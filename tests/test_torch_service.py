"""The port's detection service (`os2d_torch.api.service.DetectionService`)
against the JAX package's (`os2d_tpu.api.service`), full width (ResNet50-C4,
1024 channels), on the planted-patch scenes of tests/test_service.py with
TARGET_IMAGE_SIZE patched to 640 on both sides.

Both sides hold the same weights: JAX's init_os2d_params(PRNGKey(0)) with a
random final aligner layer (as tests/test_torch_detect.py), converted with
`state_dict_from_jax`. At resample_precision "highest" (JAX on the CPU runs
every tier in exact fp32) the responses of detect, detect_batch, TTA
rotation90 and a prescreened catalog equal JAX's: the same detections,
scores within 1e-4 and boxes within 1e-2 px once multiplied back by the
image size. At the default tier (the port's bf16 hat resample) the top box
is on the planted patch (IoU > 0.5) and the top score is within 4e-3 (the
tier's bound) of JAX's.
"""

import base64
from io import BytesIO

import numpy as np
import pytest
import torch
from PIL import Image

import jax

import os2d_tpu.api.service as jservice
from os2d_tpu.models import os2d as jos2d
from os2d_torch.api import service as tservice
from os2d_torch.models import Os2dConfig, Os2dModel
from os2d_torch.models.from_jax import state_dict_from_jax
from os2d_torch.structures.boxes import box_iou

SIZE = 640
SCORE_ATOL, BOX_PX = 1e-4, 1e-2
DEFAULT_TIER_ATOL = 4e-3


def _to_b64(img: Image.Image) -> str:
    buf = BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _patch(rng, block=8):
    return np.kron(rng.randint(0, 255, (30, 30, 3), np.uint8), np.ones((block, block, 1), np.uint8))


def _planted_scene(rng, w, h, patch, x0, y0):
    scene = rng.randint(0, 60, (h, w, 3), np.uint8)
    scene[y0: y0 + patch.shape[0], x0: x0 + patch.shape[1]] = patch
    return scene


@pytest.fixture(scope="module", autouse=True)
def target_size():
    saved = jservice.TARGET_IMAGE_SIZE, tservice.TARGET_IMAGE_SIZE
    jservice.TARGET_IMAGE_SIZE = tservice.TARGET_IMAGE_SIZE = SIZE
    yield
    jservice.TARGET_IMAGE_SIZE, tservice.TARGET_IMAGE_SIZE = saved


@pytest.fixture(scope="module")
def params():
    p = jax.tree_util.tree_map(
        np.asarray, jos2d.init_os2d_params(jax.random.PRNGKey(0), jos2d.Os2dConfig()))
    lin = p["transform_net"]["linear"]
    lin["w"] = (0.02 * np.random.RandomState(0).randn(*lin["w"].shape)).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def models(params):
    """{tier: (JAX model, JAX params, port model)} at "highest" and "default"."""
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, params)
    sd = state_dict_from_jax(params)
    out = {}
    for tier in ("highest", "default"):
        model = Os2dModel(Os2dConfig(resample_precision=tier), device="cpu")
        model.load_state_dict(sd)
        out[tier] = (jos2d.Os2dModel(jos2d.Os2dConfig(resample_precision=tier)), jparams, model)
    return out


def _services(models, tier, **kwargs):
    jmodel, jparams, model = models[tier]
    return (jservice.DetectionService(jmodel, jparams, **kwargs),
            tservice.DetectionService(model, **kwargs))


def assert_responses_match(got, want, w, h):
    """The same detections: equal counts, and each of `got` has one in `want`
    with score within SCORE_ATOL and box within BOX_PX pixels (robust to the
    order of near-tied scores)."""
    assert len(got["scores"]) == len(want["scores"]) > 0
    scale = np.array([w, h, w, h])
    ws, wb = np.array(want["scores"]), np.array(want["bboxes"]) * scale
    for s, b in zip(got["scores"], np.array(got["bboxes"]) * scale):
        hit = (np.abs(ws - s) <= SCORE_ATOL) & (np.abs(wb - b).max(-1) <= BOX_PX)
        assert hit.any(), (s, b)
    assert got["scores"] == sorted(got["scores"], reverse=True)


def _iou(rel_box, w, h, x0, y0, side=240):
    box = torch.tensor([rel_box], dtype=torch.float32) * torch.tensor([w, h, w, h])
    return float(box_iou(box, torch.tensor([[x0, y0, x0 + side, y0 + side]], dtype=torch.float32)))


def _one_scene(seed=0):
    rng = np.random.RandomState(seed)
    patch = _patch(rng)
    return Image.fromarray(_planted_scene(rng, 640, 480, patch, 48, 112)), Image.fromarray(patch)


def test_detect_from_request_matches_jax(models):
    scene, query = _one_scene()
    payload = {"image": {"content": _to_b64(scene)}, "query": [{"content": _to_b64(query)}]}
    jsvc, svc = _services(models, "highest", score_threshold=0.3)
    got, want = svc.detect_from_request(payload), jsvc.detect_from_request(payload)
    assert_responses_match(got, want, 640, 480)
    assert _iou(got["bboxes"][0], 640, 480, 48, 112) > 0.5
    assert svc.stats == {"prescreen_dispatches": 0, "full_dispatches": 1}


def test_detect_batch_matches_jax(models):
    """One query set against two scenes of different sizes on one canvas."""
    rng = np.random.RandomState(1)
    patch = _patch(rng)
    plants = [((640, 480), (48, 112)), ((560, 560), (304, 48))]
    scenes = [Image.fromarray(_planted_scene(rng, w, h, patch, x0, y0))
              for (w, h), (x0, y0) in plants]
    jsvc, svc = _services(models, "highest", score_threshold=0.3)
    got = svc.detect_batch(scenes, [Image.fromarray(patch)])
    want = jsvc.detect_batch(scenes, [Image.fromarray(patch)])
    assert len(got) == len(want) == 2
    for ((w, h), (x0, y0)), g, wnt in zip(plants, got, want):
        assert_responses_match(g, wnt, w, h)
        assert _iou(g["bboxes"][0], w, h, x0, y0) > 0.5
    svc_payload = svc.detect_batch_from_request(
        {"images": [{"content": _to_b64(s)} for s in scenes],
         "query": [{"content": _to_b64(Image.fromarray(patch))}]})
    for g, again in zip(got, svc_payload["results"]):
        assert g == again


def test_tta_rotation90_matches_jax(models):
    rng = np.random.RandomState(2)
    patch = _patch(rng)
    scene = Image.fromarray(_planted_scene(rng, 640, 480, patch, 48, 112))
    jsvc, svc = _services(models, "highest", score_threshold=0.3,
                          class_image_augmentation="rotation90")
    got = svc.detect(scene, [Image.fromarray(patch)])
    want = jsvc.detect(scene, [Image.fromarray(patch)])
    assert_responses_match(got, want, 640, 480)
    assert _iou(got["bboxes"][0], 640, 480, 48, 112) > 0.5


def test_prescreened_catalog_matches_full_path_and_jax(models):
    """A catalog of 6 classes with prescreen_min_classes=4 goes through the
    prescreen; its response equals the full path's and JAX's prescreened one."""
    rng = np.random.RandomState(11)
    patch = _patch(rng, block=4)  # 120x120
    scene = Image.fromarray(_planted_scene(rng, 320, 240, patch, 40, 60))
    queries = [Image.fromarray(np.roll(patch, 7 * k, axis=0)) for k in range(6)]
    jsvc, svc = _services(models, "highest", score_threshold=0.3, prescreen_min_classes=4)
    got = svc.detect(scene, queries)
    want = jsvc.detect(scene, queries)
    full = tservice.DetectionService(models["highest"][2], score_threshold=0.3,
                                     prescreen_min_classes=100).detect(scene, queries)
    assert svc.stats == jsvc.stats == {"prescreen_dispatches": 1, "full_dispatches": 0}
    assert_responses_match(got, want, 320, 240)
    assert_responses_match(got, full, 320, 240)


def test_default_tier_top_box_on_patch(models):
    scene, query = _one_scene()
    jsvc, svc = _services(models, "default", score_threshold=0.3)
    got = svc.detect(scene, [query])
    want = jsvc.detect(scene, [query])
    assert got["scores"] and want["scores"]
    assert _iou(got["bboxes"][0], 640, 480, 48, 112) > 0.5
    assert abs(got["scores"][0] - want["scores"][0]) <= DEFAULT_TIER_ATOL
    np.testing.assert_allclose(np.array(got["bboxes"][0]) * [640, 480, 640, 480],
                               np.array(want["bboxes"][0]) * [640, 480, 640, 480], atol=BOX_PX)


def _b64(arr):
    return _to_b64(Image.fromarray(arr))


MALFORMED = {
    "no_image": ({"query": [{"content": "x"}]}, "image"),
    "no_query": ({"image": {"content": "QUJD"}}, "image"),
    "image_not_dict": ({"image": "abc", "query": []}, "image"),
    "bad_base64": ({"image": {"content": "!!notb64"}, "query": []}, "image"),
    "not_an_image": ({"image": {"content": base64.b64encode(b"text").decode()},
                      "query": []}, "image"),
    "images_not_list": ({"images": {"content": "x"}, "query": []}, "images"),
    "payload_not_dict": (["image"], "image"),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_parse_request_payload_refuses_as_jax(case):
    payload, key = MALFORMED[case]
    with pytest.raises(ValueError, match="malformed payload"):
        jservice.parse_request_payload(payload, key)
    with pytest.raises(ValueError, match="malformed payload"):
        tservice.parse_request_payload(payload, key)


def test_parse_request_payload_decodes_as_jax():
    rng = np.random.RandomState(5)
    scene = rng.randint(0, 255, (40, 50, 3), np.uint8)
    gray = Image.fromarray(rng.randint(0, 255, (20, 30), np.uint8), mode="L")
    payload = {"images": [{"content": _b64(scene)}, {"content": _to_b64(gray)}],
               "query": [{"content": _b64(scene[:10])}]}
    for key, p in (("images", payload), ("image", {"image": payload["images"][1],
                                                   "query": payload["query"]})):
        got, want = tservice.parse_request_payload(p, key), jservice.parse_request_payload(p, key)
        for g, w in zip(got[0] + got[1], want[0] + want[1]):
            assert g.mode == w.mode == "RGB"
            assert np.array_equal(np.asarray(g), np.asarray(w))
    with pytest.raises(ValueError, match="empty query list"):
        tservice.parse_request_payload({"image": payload["images"][0], "query": []})


def test_queries_signature_matches_jax(models):
    jsvc, svc = _services(models, "highest")
    _, query = _one_scene()
    assert svc.queries_signature([query]) == jsvc.queries_signature([query])
