#!/usr/bin/env python3
"""Smoke run of the PyTorch port (os2d_torch) on one NVIDIA card.

    python3 chip_smoke.py            # one card; exits non-zero on any failure
    python3 chip_smoke.py --profile  # adds a torch.profiler breakdown of one dispatch

Phases, each printing one JSON line:
  1. env      the card (nvidia-smi name and power limit), torch/CUDA versions,
              the TF32 flags as the model sets them, and the kernel build
              (nvcc for sm_90a from os2d_torch/csrc) with its seconds.
  2. kernel   the resample kernel against its plain PyTorch version
              (rtol 1e-5, atol 1e-6) at a ragged small shape and at the bench
              protocol's largest level.
  3. planted  the planted-patch scenes of tests/test_end_to_end_eval.py at
              full width with seeded random weights: each patch must be the
              top valid detection of its class (IoU > 0.5), and the card's
              detections must agree with the same model on the CPU.
  4. main     Evaluator.detect_images at the bench protocol (bench.py):
              B=2 images of 1280x960, the 7-level pyramid, 16 classes in one
              chunk. One warmup dispatch, then timed dispatches; the kernel's
              launch count over the timed run must be 7 per dispatch. Then
              the kernel's CUDA-event time per launch on the main path's own
              largest-level inputs, beside its bound, its plain version and
              F.grid_sample (a yardstick only; the port never calls it).
Then one {"kernels": [...]} line, the nvidia-smi line, and the last line
{"ok": true, "device": {...}}. Without a CUDA card it prints no result and
exits 1.
"""

import json
import subprocess
import sys
import time

# H100 SXM published peaks: HBM bytes/s and fp32 (non-tensor-core) flop/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# flops per template-point sample in the resample: floor x2, fractions x2,
# complements x2, 8 weight products, 4 corner products summed, mask multiply-add
RESAMPLE_FLOPS_PER_SAMPLE = 20
RTOL, ATOL = 1e-5, 1e-6

IMG_W, IMG_H = 1280, 960
PYRAMID = [0.5, 0.625, 0.8, 1, 1.2, 1.4, 1.6]
NUM_CLASSES = 16
BATCH = 2
TIMED_DISPATCHES = 6
PATCH = 240
PLANTED = {0: [(48, 48, 0)], 1: [(336, 176, 1), (48, 112, 0)]}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters):
    """Mean CUDA-event time of fn() over iters launches, after 2 warmups."""
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def resample_bound(b, c, a, t):
    """(bound_ms, bound_by) of one resample: each input read once (corr
    prefix, px, py, mask), the output written once; against the fp32 rate."""
    bytes_ = 4 * (3 * b * c * t * a + c * t + b * c * a)
    ops = RESAMPLE_FLOPS_PER_SAMPLE * b * c * t * a
    bytes_ms, ops_ms = bytes_ / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def max_err_checked(got, want, what):
    import torch

    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL, msg=lambda m: f"{what}: {m}")
    return float((got - want).abs().max())


def random_resample_inputs(b, c, h, w, gen):
    import torch

    dev = "cuda"
    corr = torch.tanh(torch.randn(b, c, h, w, 225, generator=gen, device=dev))
    a, t = h * w, 121
    px = torch.rand(b, c, t, a, generator=gen, device=dev) * (w - 1)
    py = torch.rand(b, c, t, a, generator=gen, device=dev) * (h - 1)
    px[:, :, :7] = 0.0
    px[:, :, 7:14] = w - 1
    py[:, :, 3:10] = 0.0
    py[:, :, 10:17] = h - 1
    mask_t = torch.full((c, t), 1.0 / t, device=dev)
    return corr, px, py, mask_t


def planted_scenes():
    import numpy as np

    rng = np.random.RandomState(0)
    patches = []
    for _ in range(2):
        p = rng.randint(0, 255, (PATCH // 8, PATCH // 8, 3), np.uint8)
        patches.append(np.kron(p, np.ones((8, 8, 1), np.uint8)))
    scenes = []
    for image_id in sorted(PLANTED):
        scene = rng.randint(0, 60, (480, 640, 3), np.uint8)
        for x0, y0, cid in PLANTED[image_id]:
            scene[y0:y0 + PATCH, x0:x0 + PATCH] = patches[cid]
        scenes.append(scene)
    return np.stack(scenes), patches


def detections_agree(got, want):
    """Every valid detection of `got` has one in `want` of the same image and
    class with score within 1e-4 and box within 1e-2 px, and the counts
    match (robust to the order of near-tied scores)."""
    import numpy as np

    for b in range(got["valid"].shape[0]):
        for g in range(got["valid"].shape[1]):
            gv, wv = got["valid"][b, g], want["valid"][b, g]
            if gv.sum() != wv.sum():
                return False
            ws, wb = want["scores"][b, g][wv], want["boxes"][b, g][wv]
            for s, box in zip(got["scores"][b, g][gv], got["boxes"][b, g][gv]):
                hit = (np.abs(ws - s) <= 1e-4) & (np.abs(wb - box).max(-1) <= 1e-2)
                if not hit.any():
                    return False
    return True


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs "
              "an NVIDIA card", file=sys.stderr)
        return 1

    import numpy as np
    import torch.nn.functional as F

    from os2d_torch.config import get_default_cfg
    from os2d_torch.engine.evaluate import Evaluator, unpack_detections
    from os2d_torch.models import Os2dConfig, Os2dModel
    from os2d_torch.models import head as head_module
    from os2d_torch.ops import resample
    from os2d_torch.ops.cuda import build_all
    from os2d_torch.ops.sampling import resample_correlation_from_pxpy_reference
    from os2d_torch.structures.boxes import box_iou
    from os2d_torch.structures.feature_map import FeatureMapSize, feature_map_size_for_image

    # ---- 1. environment and build ----
    smi = nvidia_smi_line()
    model = Os2dModel(Os2dConfig(), seed=0)
    t0 = time.perf_counter()
    logs = build_all([resample.KERNEL.source])
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "build_s": build_s, "built": sorted(logs), "ptxas": ptxas})

    # ---- 2. kernel against its plain version ----
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    for name, (b, c, h, w) in (("ragged", (2, 3, 6, 7)), ("bench_largest", (2, 16, 96, 128))):
        corr, px, py, mask_t = random_resample_inputs(b, c, h, w, gen)
        got = resample.resample_correlation(corr, px, py, mask_t)
        torch.cuda.synchronize()
        want = resample_correlation_from_pxpy_reference(corr, px, py, mask_t)
        errs[name] = max_err_checked(got, want, f"resample kernel at {name}")
        del corr, px, py, mask_t, got, want
    emit({"phase": "kernel", "rtol": RTOL, "atol": ATOL, "max_abs_err": errs})

    # ---- 3. planted patches, and the card against the CPU ----
    cfg = get_default_cfg()
    cfg.tpu.eval_pre_top_k = 256
    cfg.tpu.eval_top_k = 16
    scenes, patches = planted_scenes()
    norm = {"mean": model.config.normalization_mean, "std": model.config.normalization_std}
    mean, std = torch.tensor(norm["mean"]), torch.tensor(norm["std"])
    class_images = [(torch.from_numpy(p).float() / 255.0 - mean) / std for p in patches]
    level = [FeatureMapSize(w=640, h=480)]
    packed = {}
    cpu_model = Os2dModel(Os2dConfig(), device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    for dev, m in (("cuda", model), ("cpu", cpu_model)):
        ev = Evaluator(m, cfg)
        head, _ = ev.build_class_heads(class_images)
        packed[dev] = unpack_detections(ev.detect_images(scenes, head, level, [(1.0, 1.0)], norm))
    det = packed["cuda"]
    found = []
    for image_id, plants in PLANTED.items():
        for x0, y0, cid in plants:
            valid = det["valid"][image_id, cid]
            top = int(np.argmax(np.where(valid, det["scores"][image_id, cid], -np.inf)))
            iou = float(box_iou(torch.tensor(det["boxes"][image_id, cid, top][None]),
                                torch.tensor([[x0, y0, x0 + PATCH, y0 + PATCH]],
                                             dtype=torch.float32)))
            found.append({"image": image_id, "class": cid, "iou": iou,
                          "ok": bool(valid.any()) and iou > 0.5})
    agree = detections_agree(packed["cuda"], packed["cpu"])
    emit({"phase": "planted", "found": found, "cuda_matches_cpu": agree})
    if not all(f["ok"] for f in found):
        raise SystemExit("planted patches were not all found")
    if not agree:
        raise SystemExit("detections on the card differ from the CPU's")
    del cpu_model

    # ---- 4. main path at the bench protocol ----
    cfg = get_default_cfg()
    cfg.tpu.eval_class_chunk = NUM_CLASSES
    rng = np.random.RandomState(0)
    class_images = [rng.randn(240, 240, 3).astype(np.float32) for _ in range(NUM_CLASSES)]
    ev = Evaluator(model, cfg)
    class_head, _ = ev.build_class_heads(class_images)
    sizes = [FeatureMapSize(w=int(IMG_W * s), h=int(IMG_H * s)) for s in PYRAMID]
    inv = [(IMG_W / sz.w, IMG_H / sz.h) for sz in sizes]
    batches = [np.random.RandomState(i).randint(0, 255, (BATCH, IMG_H, IMG_W, 3), np.uint8)
               for i in range(TIMED_DISPATCHES + 1)]

    t0 = time.perf_counter()
    ev.detect_images(batches[-1], class_head, sizes, inv, norm)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    resample.KERNEL.launches = 0
    times, outputs = [], []
    for i in range(TIMED_DISPATCHES):
        t0 = time.perf_counter()
        out = ev.detect_images(batches[i], class_head, sizes, inv, norm)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        outputs.append(out)
    launches = resample.KERNEL.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    fms = [feature_map_size_for_image(sz) for sz in sizes]
    anchors = sum(fm.w * fm.h for fm in fms)
    for out in outputs:
        if tuple(out.shape) != (BATCH, NUM_CLASSES, int(cfg.tpu.eval_top_k), 6):
            raise SystemExit(f"packed output has shape {tuple(out.shape)}")
        d = unpack_detections(out)
        if not (np.isfinite(d["boxes"]).all() and np.isfinite(d["scores"][d["valid"]]).all()
                and d["valid"].any()):
            raise SystemExit("main path produced non-finite or no detections")
    if launches != len(PYRAMID) * TIMED_DISPATCHES:
        raise SystemExit(f"resample kernel launched {launches} times in "
                         f"{TIMED_DISPATCHES} dispatches, expected "
                         f"{len(PYRAMID) * TIMED_DISPATCHES}")
    dispatch_bound = sum(resample_bound(BATCH, NUM_CLASSES, fm.w * fm.h, 121)[0] for fm in fms)
    emit({"phase": "main", "images": f"{BATCH}x{IMG_W}x{IMG_H} uint8", "levels": len(sizes),
          "anchors_per_image": anchors, "classes": NUM_CLASSES, "warmup_s": warmup_s,
          "dispatch_s": times, "median_dispatch_s": float(np.median(times)),
          "img_per_s": BATCH / float(np.median(times)),
          "img_per_s_spread": [BATCH / max(times), BATCH / min(times)],
          "resample_launches": launches, "resample_bound_ms_per_dispatch": dispatch_bound,
          "peak_gb": peak_gb})

    # the kernel on the main path's own largest-level inputs
    captured = {}
    original = head_module.resample_correlation

    def capture(corr, px, py, mask_t):
        captured.update(corr=corr, px=px, py=py, mask_t=mask_t)
        return original(corr, px, py, mask_t)

    largest = max(range(len(sizes)), key=lambda i: fms[i].w * fms[i].h)
    img = torch.as_tensor(batches[0], device="cuda").float() / 255.0
    img = (img - mean.cuda()) / std.cuda()
    from os2d_torch.ops.sampling import resize_bilinear_antialias

    head_module.resample_correlation = capture
    try:
        fm_big = model.extract_features(
            resize_bilinear_antialias(img, sizes[largest].h, sizes[largest].w))
        model.apply_head(fm_big, class_head)
    finally:
        head_module.resample_correlation = original
    corr, px, py, mask_t = (captured[k] for k in ("corr", "px", "py", "mask_t"))
    b, c, h, w, _ = corr.shape
    t, a = px.shape[2], h * w
    kernel_out = resample.resample_correlation(corr, px, py, mask_t)
    plain_out = resample_correlation_from_pxpy_reference(corr, px, py, mask_t)
    errs["main_path_largest"] = max_err_checked(kernel_out, plain_out,
                                                "resample kernel on main-path inputs")
    kernel_ms = cuda_ms(lambda: resample.resample_correlation(corr, px, py, mask_t), 20)
    plain_ms = cuda_ms(lambda: resample_correlation_from_pxpy_reference(corr, px, py, mask_t), 5)

    # yardstick: grid_sample (border, align_corners) on corr viewed as
    # [B*C*T, 1, H, W], then the masked sum; inputs laid out outside the timing
    planes = corr.permute(0, 1, 4, 2, 3).reshape(b * c * t, 1, h, w).contiguous()
    grid = torch.stack([px / (w - 1) * 2 - 1, py / (h - 1) * 2 - 1], -1).reshape(b * c * t, 1, a, 2)

    def library():
        s = F.grid_sample(planes, grid, mode="bilinear", padding_mode="border",
                          align_corners=True)
        return (s.view(b, c, t, a) * mask_t[None, :, :, None]).sum(2)

    library_err = float((library().view(b, c, h, w) - kernel_out).abs().max())
    library_ms = cuda_ms(library, 5)
    bound_ms, bound_by = resample_bound(b, c, a, t)
    emit({"phase": "resample_timing", "shape": {"B": b, "C": c, "H": h, "W": w, "T": t,
                                                "corr_row_stride": corr.stride(3)},
          "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
          "library_max_abs_err": library_err, "bound_ms": bound_ms, "bound_by": bound_by,
          "max_abs_err": errs["main_path_largest"]})
    del captured, corr, px, py, mask_t, planes, grid

    if "--profile" in argv:
        profile_dispatch(ev, batches[0], class_head, sizes, inv, norm, float(np.median(times)))

    emit({"kernels": [{
        "name": "resample_correlation",
        "route": "cuda",
        "source": "os2d_torch/csrc/resample.cu",
        "replaces": "os2d_tpu/ops/pallas_resample.py:24",
        "launches": launches,
        "max_abs_err": max(errs.values()),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# kernel families of a dispatch's device time, by substring of the kernel
# name, first match wins
KERNEL_FAMILIES = (
    ("resample kernel", ("resample_correlation",)),
    ("conv FFT", ("fft", "pointwise_mult_and_sum_complex")),
    ("conv implicit GEMM", ("fprop", "convolve")),
    ("GEMM", ("gemm",)),
    ("layout and copies", ("Nhwc", "Nchw", "copy")),
)


def kernel_family(name):
    for family, keys in KERNEL_FAMILIES:
        if any(k in name for k in keys):
            return family
    return "elementwise and other"


def profile_dispatch(ev, images, class_head, sizes, inv, norm, untraced_s):
    """Device time by kernel over one main-path dispatch (torch.profiler).
    The idle share is taken against the untraced median dispatch time, since
    the profiler's own start-up inflates the traced wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ev.detect_images(images, class_head, sizes, inv, norm)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "device_time_total", 0) or getattr(evt, "cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, evt.key, evt.count))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    families = {}
    for ms, key, _ in rows:
        families[kernel_family(key)] = families.get(kernel_family(key), 0.0) + ms
    emit({"phase": "profile", "traced_wall_ms": wall_ms, "device_ms": device_ms,
          "untraced_dispatch_ms": untraced_s * 1e3,
          "device_idle_share": (1 - device_ms / (untraced_s * 1e3)) if rows else None,
          "families_ms": dict(sorted(families.items(), key=lambda kv: -kv[1])),
          "top": [{"kernel": k[:120], "ms": ms, "calls": n} for ms, k, n in rows[:25]]})


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
