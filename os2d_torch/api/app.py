"""FastAPI one-shot detection service: counterpart of the JAX package's
`app.py` (reference app.py:1-103). Run it with

    uvicorn os2d_torch.api.app:app

POST /detect-all-instances
  {"image": {"content": <b64>}, "query": [{"content": <b64>}, ...]}
  -> {"scores": [...], "bboxes": [[lx, ty, rx, by], ...]} (relative coords)

POST /detect-batch
  {"images": [{"content": <b64>}, ...], "query": [{"content": <b64>}, ...]}
  -> {"results": [{"scores": ..., "bboxes": ...}, ...]}
  One query set against N images in one dispatch.

GET /health -> {"status": "ok"}

The model is built once, when the module is imported. Environment variables:
  OS2D_CHECKPOINT      - a checkpoint file, read by
                         models.checkpoint.load_checkpoint_file: a `.pkl` of
                         the JAX package, the port's own `.pth`, or a
                         reference `.pth` (full model, weakalign or backbone
                         alone); seeded random weights if unset.
  OS2D_PYRAMID         - comma-separated pyramid scales (default "1.0").
  OS2D_TTA             - query test-time augmentation: "" (default) |
                         "rotation90" | "horflip" | "horflip_rotation90".
  OS2D_DYNAMIC_BATCH   - max batch of the cross-request batcher for
                         /detect-all-instances (0/unset = off).
  OS2D_BATCH_WINDOW_MS - the batcher's gather window (default 10 ms).
  OS2D_DEVICE          - the model's device (default "cuda"; it raises
                         without a card). "cpu" runs the kernels' plain
                         versions.
Detection runs in the event loop's thread pool, so the loop keeps serving
while a request is on the device.
"""

import asyncio
import os

try:
    from fastapi import FastAPI, HTTPException, Request
except ImportError as e:  # pragma: no cover
    raise ImportError(
        "fastapi is required for the serving app: pip install fastapi uvicorn"
    ) from e

from os2d_torch.api.service import DetectionService, DynamicBatcher, parse_request_payload
from os2d_torch.models import Os2dConfig, Os2dModel
from os2d_torch.models.checkpoint import load_checkpoint_file


def _decode_payload_images(payload: dict, image_key: str):
    """Validate + decode a request payload (the schema parser lives in
    api/service.py); malformed requests become 400s instead of 500s."""
    try:
        return parse_request_payload(payload, image_key)
    except ValueError as e:
        raise HTTPException(status_code=400, detail=str(e)) from e


def build_service() -> DetectionService:
    model_cfg = Os2dConfig()
    model = Os2dModel(model_cfg, device=os.environ.get("OS2D_DEVICE", "cuda"))
    ckpt_path = os.environ.get("OS2D_CHECKPOINT", "")
    if ckpt_path:
        state_dict, _ = load_checkpoint_file(ckpt_path, model_cfg, model)
        model.load_state_dict(state_dict)
    scales = tuple(
        float(s) for s in os.environ.get("OS2D_PYRAMID", "1.0").split(",")
    )
    return DetectionService(
        model, pyramid_scales=scales,
        class_image_augmentation=os.environ.get("OS2D_TTA", ""),
    )


app = FastAPI(title="os2d one-shot detection (PyTorch)")
service = build_service()

# cross-request dynamic batching: concurrent /detect-all-instances requests
# sharing the same query catalog are grouped into one device dispatch
_batch_size = int(os.environ.get("OS2D_DYNAMIC_BATCH", "0"))
batcher = None
if _batch_size > 1:
    batcher = DynamicBatcher(
        service, max_batch=_batch_size,
        max_wait_ms=float(os.environ.get("OS2D_BATCH_WINDOW_MS", "10")),
    )


async def _in_thread(fn, *args):
    return await asyncio.get_running_loop().run_in_executor(None, fn, *args)


@app.post("/detect-all-instances")
async def detect_all_instances(request: Request):
    payload = await request.json()
    images, queries = _decode_payload_images(payload, "image")
    detect = service.detect if batcher is None else batcher.detect
    return await _in_thread(detect, images[0], queries)


@app.post("/detect-batch")
async def detect_batch(request: Request):
    payload = await request.json()
    images, queries = _decode_payload_images(payload, "images")
    return {"results": await _in_thread(service.detect_batch, images, queries)}


@app.get("/health")
async def health():
    return {"status": "ok"}
