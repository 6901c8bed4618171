"""The port's HTTP app (`os2d_torch/api/app.py`) with a stub `fastapi`
module: FastAPI's route decorators return the function unchanged, so the
route coroutines are called with `asyncio.run` and a fake request whose
json() returns the payload. The app is imported fresh with OS2D_DEVICE=cpu
and OS2D_CHECKPOINT set to a JAX `.pkl` (`os2d_tpu.utils.logger.
checkpoint_model`, with an optax SGD-momentum state) of the full-width model,
TARGET_IMAGE_SIZE patched to 640.

Checked: the loaded weights equal the `.pkl`'s; /detect-all-instances and
/detect-batch answer as the port's service does; a malformed payload is an
HTTPException with status 400; OS2D_DYNAMIC_BATCH=2 routes concurrent
requests through the batcher. Then the JAX package's app.py, imported with
the same stub and checkpoint, against the port's app on one payload at the
default tier: the same top box within 1e-2 px, scores within 4e-3.
"""

import asyncio
import base64
import importlib
import importlib.util
import pathlib
import sys
import types
from io import BytesIO

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import optax

import os2d_tpu.api.service as jservice
from os2d_tpu.models import os2d as jos2d
from os2d_tpu.utils import logger as jlogger
from os2d_torch.api import service as tservice
from os2d_torch.models.from_jax import state_dict_from_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
SIZE = 640
BOX_PX = 1e-2
DEFAULT_TIER_ATOL = 4e-3
PLANT = (48, 112)


class HTTPException(Exception):
    def __init__(self, status_code, detail=None):
        super().__init__(status_code, detail)
        self.status_code = status_code
        self.detail = detail


class FastAPI:
    def __init__(self, **kwargs):
        self.routes = {}

    def _route(self, method, path):
        def register(fn):
            self.routes[(method, path)] = fn
            return fn
        return register

    def post(self, path):
        return self._route("POST", path)

    def get(self, path):
        return self._route("GET", path)


class FakeRequest:
    def __init__(self, payload):
        self.payload = payload

    async def json(self):
        return self.payload


def _stub_fastapi():
    mod = types.ModuleType("fastapi")
    mod.FastAPI, mod.HTTPException, mod.Request = FastAPI, HTTPException, FakeRequest
    return mod


def _to_b64(img: Image.Image) -> str:
    buf = BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _scene(seed, w=640, h=480, x0=PLANT[0], y0=PLANT[1]):
    rng = np.random.RandomState(seed)
    patch = np.kron(rng.randint(0, 255, (30, 30, 3), np.uint8), np.ones((8, 8, 1), np.uint8))
    scene = rng.randint(0, 60, (h, w, 3), np.uint8)
    scene[y0:y0 + 240, x0:x0 + 240] = patch
    return Image.fromarray(scene), Image.fromarray(patch)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A JAX `.pkl` with its params (random final aligner layer)."""
    params = jax.tree_util.tree_map(
        np.asarray, jos2d.init_os2d_params(jax.random.PRNGKey(0), jos2d.Os2dConfig()))
    lin = params["transform_net"]["linear"]
    lin["w"] = (0.02 * np.random.RandomState(0).randn(*lin["w"].shape)).astype(np.float32)
    opt_state = optax.sgd(0.01, momentum=0.9).init(params)
    path = jlogger.checkpoint_model(params, opt_state, str(tmp_path_factory.mktemp("ckpt")),
                                    model_name="serve")
    return path, params


def _import_fresh(name, path=None):
    sys.modules.pop(name, None)
    if path is None:
        return importlib.import_module(name)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def apps(checkpoint):
    """{"port": the port's app, "port_batched": with OS2D_DYNAMIC_BATCH=2,
    "jax": the JAX package's app.py}, all from the checkpoint."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "fastapi", _stub_fastapi())
        mp.setattr(jservice, "TARGET_IMAGE_SIZE", SIZE)
        mp.setattr(tservice, "TARGET_IMAGE_SIZE", SIZE)
        mp.setenv("OS2D_DEVICE", "cpu")
        mp.setenv("OS2D_CHECKPOINT", checkpoint[0])
        mp.delenv("OS2D_DYNAMIC_BATCH", raising=False)
        out["port"] = _import_fresh("os2d_torch.api.app")
        out["jax"] = _import_fresh("os2d_jax_app_under_test", ROOT / "app.py")
        mp.setenv("OS2D_DYNAMIC_BATCH", "2")
        mp.setenv("OS2D_BATCH_WINDOW_MS", "3000")
        out["port_batched"] = _import_fresh("os2d_torch.api.app")
        try:
            yield out
        finally:
            out["port_batched"].batcher.close()
            sys.modules.pop("os2d_torch.api.app", None)
            sys.modules.pop("os2d_jax_app_under_test", None)


def _call(route, payload):
    return asyncio.run(route(FakeRequest(payload)))


def _payload(scene, query):
    return {"image": {"content": _to_b64(scene)}, "query": [{"content": _to_b64(query)}]}


def test_app_loads_the_checkpoint(apps, checkpoint):
    app = apps["port"]
    assert app.batcher is None
    assert app.service.model.device.type == "cpu"
    want = state_dict_from_jax(checkpoint[1])
    got = app.service.model.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert asyncio.run(app.health()) == {"status": "ok"}


def test_routes_answer_as_the_service(apps):
    app = apps["port"]
    scene, query = _scene(0)
    other, _ = _scene(1, w=560, h=560)
    direct = tservice.DetectionService(app.service.model)
    got = _call(app.detect_all_instances, _payload(scene, query))
    assert got == direct.detect(scene, [query])
    assert got["scores"]
    batch = {"images": [{"content": _to_b64(scene)}, {"content": _to_b64(other)}],
             "query": [{"content": _to_b64(query)}]}
    assert _call(app.detect_batch, batch) == {"results": direct.detect_batch([scene, other],
                                                                             [query])}


@pytest.mark.parametrize("route", ["detect_all_instances", "detect_batch"])
def test_malformed_payload_is_a_400(apps, route):
    with pytest.raises(HTTPException) as err:
        _call(getattr(apps["port"], route), {"query": []})
    assert err.value.status_code == 400 and "malformed payload" in err.value.detail


def test_dynamic_batch_routes_through_the_batcher(apps, monkeypatch):
    app = apps["port_batched"]
    assert app.batcher is not None and app.batcher.max_batch == 2
    scenes = [_scene(2)[0], _scene(3)[0]]
    _, query = _scene(2)
    calls = []
    detect_batch = app.service.detect_batch
    monkeypatch.setattr(app.service, "detect_batch",
                        lambda images, q: calls.append(len(images)) or detect_batch(images, q))

    async def both():
        return await asyncio.gather(*(app.detect_all_instances(FakeRequest(_payload(s, query)))
                                      for s in scenes))

    got = asyncio.run(both())
    assert calls == [2]
    assert got == detect_batch(scenes, [query])


def test_port_app_matches_jax_app(apps):
    scene, query = _scene(0)
    payload = _payload(scene, query)
    got = _call(apps["port"].detect_all_instances, payload)
    want = _call(apps["jax"].detect_all_instances, payload)
    assert got["scores"] and want["scores"]
    scale = np.array([640, 480, 640, 480])
    np.testing.assert_allclose(np.array(got["bboxes"][0]) * scale,
                               np.array(want["bboxes"][0]) * scale, atol=BOX_PX)
    assert abs(got["scores"][0] - want["scores"][0]) <= DEFAULT_TIER_ATOL
    top = np.array(got["bboxes"][0]) * scale
    assert np.abs(top - [*PLANT, PLANT[0] + 240, PLANT[1] + 240]).max() < 0.08 * 640
