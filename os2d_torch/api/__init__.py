"""Serving: `service.DetectionService` and `service.DynamicBatcher`, and the
HTTP app `app.py` (needs fastapi; `uvicorn os2d_torch.api.app:app`)."""
