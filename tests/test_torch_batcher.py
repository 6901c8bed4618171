"""The port's cross-request batcher (`os2d_torch.api.service.DynamicBatcher`).

It is host code, so most cases drive it with a stub service whose
`detect_batch` records its calls and takes milliseconds: grouping up to
max_batch, catalogs never sharing a batch, the deferred queue served first
and in order (the fast form of tests/test_service.py's soak), close()
failing pending requests with each slot completed once, and an exception
reaching every caller of its group. Then one case with the full-width model
on the CPU against the port's own `detect_batch`, as tests/test_service.py
holds the JAX batcher.
"""

import threading
import time

import numpy as np
import pytest
from PIL import Image

import os2d_torch.api.service as service_mod
from os2d_torch.api.service import DetectionService, DynamicBatcher
from os2d_torch.models import Os2dModel

JOIN_S = 30


class StubService:
    """queries_signature and detect_batch of DetectionService; an image is a
    string naming its catalog ("A3" is image 3 of catalog A)."""

    def __init__(self, delay_s=0.0, gate=None, fail_first=None):
        self.calls = []
        self.delay_s = delay_s
        self.gate = gate
        self.started = threading.Event()
        self.fail_first = fail_first
        self._lock = threading.Lock()

    def queries_signature(self, queries):
        return tuple(queries)

    def detect_batch(self, images, queries):
        with self._lock:
            self.calls.append((tuple(queries), list(images)))
            first = len(self.calls) == 1
        self.started.set()
        if self.gate is not None:
            self.gate.wait(JOIN_S)
        time.sleep(self.delay_s)
        if first and self.fail_first is not None:
            raise self.fail_first
        return [{"image": im, "catalog": tuple(queries)} for im in images]


def _request(batcher, image, catalog, out):
    """A client thread: its result or its exception lands in out[image]."""

    def run():
        try:
            out[image] = batcher.detect(image, catalog)
        except Exception as e:  # noqa: BLE001 - collected for the asserts
            out[image] = e

    t = threading.Thread(target=run)
    t.start()
    return t


def _join(threads):
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads), "a client hung"


def test_same_catalog_requests_group_up_to_max_batch():
    service = StubService()
    batcher = DynamicBatcher(service, max_batch=4, max_wait_ms=500)
    out = {}
    try:
        _join([_request(batcher, f"A{i}", ["qa"], out) for i in range(6)])
    finally:
        batcher.close()
    sizes = [len(images) for _, images in service.calls]
    assert sorted(sizes) == [2, 4], sizes
    assert sorted(im for _, images in service.calls for im in images) == sorted(out)
    for image, res in out.items():
        assert res == {"image": image, "catalog": ("qa",)}


def test_other_catalogs_never_share_a_batch():
    service = StubService(delay_s=0.002)
    batcher = DynamicBatcher(service, max_batch=8, max_wait_ms=50)
    out, threads = {}, []
    try:
        for i in range(12):
            catalog = "ABC"[i % 3]
            threads.append(_request(batcher, f"{catalog}{i}", [catalog], out))
        _join(threads)
    finally:
        batcher.close()
    assert len(out) == 12
    for catalog, images in service.calls:
        assert all(im[0] == catalog[0] for im in images), (catalog, images)
    for image, res in out.items():
        assert res["image"] == image and res["catalog"] == (image[0],)


def test_deferred_requests_are_served_first_in_order():
    """While the first batch is on the device, B1 A1 C1 B2 queue up. The next
    window takes B1 and B2 (A1 and C1 deferred); then A1 and C1 go next, in
    their order, ahead of anything newer."""
    gate = threading.Event()
    service = StubService(gate=gate)
    batcher = DynamicBatcher(service, max_batch=8, max_wait_ms=200)
    out, threads = {}, []
    try:
        threads.append(_request(batcher, "A0", ["A"], out))
        assert service.started.wait(JOIN_S)
        for image in ("B1", "A1", "C1", "B2"):
            threads.append(_request(batcher, image, [image[0]], out))
            time.sleep(0.02)  # queue order
        gate.set()
        _join(threads)
    finally:
        batcher.close()
    assert [images for _, images in service.calls] == [["A0"], ["B1", "B2"], ["A1"], ["C1"]]


def test_sustained_majority_does_not_starve_a_minority_catalog():
    service = StubService(delay_s=0.002)
    batcher = DynamicBatcher(service, max_batch=4, max_wait_ms=5)
    counts = [0] * 5
    errors = []
    deadline = time.monotonic() + 1.5

    def client(k):
        catalog = ["B"] if k == 4 else ["A"]
        try:
            while time.monotonic() < deadline:
                res = batcher.detect(f"{catalog[0]}{k}", catalog)
                assert res["catalog"] == tuple(catalog)
                counts[k] += 1
        except Exception as e:  # noqa: BLE001 - collected for the assert
            errors.append((k, e))

    threads = [threading.Thread(target=client, args=(k,)) for k in range(5)]
    try:
        for t in threads:
            t.start()
        _join(threads)
    finally:
        batcher.close()
    assert not errors, errors
    assert all(c >= 3 for c in counts), counts
    for catalog, images in service.calls:
        assert all(im[0] == catalog[0] for im in images)


def test_close_fails_pending_requests_once():
    gate = threading.Event()
    service = StubService(gate=gate)
    batcher = DynamicBatcher(service, max_batch=8, max_wait_ms=1)
    out, threads = {}, []
    threads.append(_request(batcher, "A0", ["A"], out))
    assert service.started.wait(JOIN_S)
    threads += [_request(batcher, im, [im[0]], out) for im in ("A1", "B1")]
    time.sleep(0.05)
    items = list(batcher._queue.queue)
    timer = threading.Timer(0.2, gate.set)  # the batch in flight ends during close()
    timer.start()
    batcher.close()
    _join(threads)
    timer.join()
    assert out["A0"] == {"image": "A0", "catalog": ("A",)}
    for image in ("A1", "B1"):
        assert isinstance(out[image], RuntimeError) and "closed" in str(out[image])
    assert len(service.calls) == 1
    # each slot is claimed once: a late completion changes nothing
    for item in items:
        batcher._finish(item, result="late")
        assert item[3]["claimed"] and item[3]["result"] is None
    with pytest.raises(RuntimeError, match="closed"):
        batcher.detect("A2", ["A"])


def test_an_error_reaches_every_caller_of_its_group():
    failure = ValueError("device lost")
    service = StubService(fail_first=failure)
    batcher = DynamicBatcher(service, max_batch=3, max_wait_ms=1000)
    out = {}
    try:
        _join([_request(batcher, f"A{i}", ["A"], out) for i in range(3)])
        # the worker serves on after the failed group
        assert batcher.detect("A9", ["A"]) == {"image": "A9", "catalog": ("A",)}
    finally:
        batcher.close()
    assert [len(images) for _, images in service.calls] == [3, 1]
    assert all(out[f"A{i}"] is failure for i in range(3))


def _planted_scene(rng, w, h, patch, x0, y0):
    scene = rng.randint(0, 60, (h, w, 3), np.uint8)
    scene[y0: y0 + patch.shape[0], x0: x0 + patch.shape[1]] = patch
    return scene


def test_batcher_matches_detect_batch_full_width(monkeypatch):
    """tests/test_service.py::test_dynamic_batcher_groups_concurrent_requests
    on the port: concurrent requests of one catalog group into one
    detect_batch; each result equals the direct batched call's and lands on
    its planted patch."""
    rng = np.random.RandomState(3)
    patch = np.kron(rng.randint(0, 255, (30, 30, 3), np.uint8), np.ones((8, 8, 1), np.uint8))
    positions = [(48, 112), (336, 176), (128, 48)]
    scenes = [Image.fromarray(_planted_scene(rng, 640, 480, patch, x0, y0))
              for x0, y0 in positions]
    queries = [Image.fromarray(patch)]
    monkeypatch.setattr(service_mod, "TARGET_IMAGE_SIZE", 640)
    service = DetectionService(Os2dModel(device="cpu"), score_threshold=0.3)
    want = service.detect_batch(scenes, queries)

    batcher = DynamicBatcher(service, max_batch=3, max_wait_ms=3000)
    calls = []
    detect_batch = service.detect_batch
    monkeypatch.setattr(service, "detect_batch",
                        lambda images, q: calls.append(len(images)) or detect_batch(images, q))
    out = {}
    try:
        threads = []
        for i, scene in enumerate(scenes):
            def call(i=i, scene=scene):
                out[i] = batcher.detect(scene, queries)
            threads.append(threading.Thread(target=call))
            threads[-1].start()
        for t in threads:
            t.join(300)
        assert not any(t.is_alive() for t in threads)
    finally:
        batcher.close()
    assert calls == [3]
    for i, (x0, y0) in enumerate(positions):
        res = out[i]
        assert res["scores"], f"image {i}: no detections"
        np.testing.assert_allclose(
            res["bboxes"][0], [x0 / 640, y0 / 480, (x0 + 240) / 640, (y0 + 240) / 480],
            atol=0.08)
        np.testing.assert_allclose(res["scores"], want[i]["scores"], atol=1e-5)
        np.testing.assert_allclose(res["bboxes"], want[i]["bboxes"], atol=1e-6)
