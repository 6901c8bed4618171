#!/usr/bin/env python3
"""Smoke run of the PyTorch port (os2d_torch) on one NVIDIA card.

    python3 chip_smoke.py            # one card; exits non-zero on any failure
    python3 chip_smoke.py --profile  # adds torch.profiler breakdowns of one eval
                                     # dispatch and one train step

The model is `Os2dConfig()` at full width (ResNet50-C4, 1024 channels) with
seeded random weights. Its resample runs at the "default" tier, the bf16 hat
kernel (csrc/hat_resample.cu); the "highest" tier runs the fp32 gather kernel
(csrc/resample.cu). Both share the tile skeleton csrc/resample_tile.cuh.
Training differentiates the resample with the CUDA kernel
csrc/resample_backward.cu (the hat form's gradient under JAX's rules).
Phases, each printing one JSON line:
  1. env      the card (nvidia-smi name and power limit), torch/CUDA versions,
              the TF32 flags as the model sets them, and the kernel builds
              (one nvcc per source in os2d_torch/csrc, all started together,
              for sm_90a) with their seconds.
  2. kernel   each kernel against its plain PyTorch version: the gather at
              rtol 1e-5, atol 1e-6; the hat kernel at rtol 1e-5, atol 1e-5
              and within 4e-3 (the "default" prescreen margin) of the exact
              fp32 gather; whether each agreed to the bit. Ragged small
              shapes (a single row and column among them), every level of
              the bench protocol (B=2, C=16) and C=128 at the largest, each
              with uniform px/py (almost no corr sector read twice) and with
              near-identity px/py (a tile's rows share each sector, as on
              the main path); px/py up to 0.5 outside the map; H=300;
              B*C = 65600.
  3. planted  the planted-patch scenes of tests/test_end_to_end_eval.py
              through Evaluator.detect_images at the default tier: each patch
              must be the top valid detection of its class (IoU > 0.5), and
              the card's detections must agree with the same model on the CPU
              (scores 1e-4, boxes 1e-2 px).
  4. evaluate engine.evaluate.evaluate() over the planted dataset written as
              files and read through the port's data layer, two pyramid
              levels, TTA "horflip_rotation90" (8 views per class) and a
              finite nms_score_threshold (the class prescreen runs): mAP@0.50
              must be >= 0.9 and equal to the same run on the CPU.
  5. prescreen  Evaluator.detect_images_prescreened with a one-hot class bank
              and a threshold between the classes' best scores: some but not
              all classes are pruned, the same ones as on the CPU, and the
              survivors' detections match the full path (scores 1e-4, boxes
              1e-3 px) and the CPU's.
  6. main     Evaluator.detect_images at the bench protocol (bench.py):
              B=2 images of 1280x960, the 7-level pyramid, 16 classes in one
              chunk, default tier. One warmup dispatch, then timed
              dispatches; the hat kernel must launch 7 times per dispatch.
  7. main_highest  the same protocol at resample_precision="highest": the
              gather kernel must launch 7 times per dispatch.
     tiers    both tiers in turns (default, highest, highest, default, four
              rounds): median img/s and spread of each.
  8. main_path_inputs / resample_timing  one more default-tier dispatch with
              the head's resample inputs captured at every level: both
              kernels held against their plain versions there, with their
              CUDA-event times per level; then their times per launch on
              the largest level, beside their bounds, their
              plain versions and one PyTorch call each that computes the
              same function (F.grid_sample and a masked sum; the port calls
              neither).
  9. train_first_step  the training path's first TrainStep at the default
              recipe (below) but with RLL's margin_pos at 1.0, on the card and
              on the CPU from the same weights and batch: loss and gradient
              norm within rtol 2e-3 (fp32 convolutions and their backward in
              another order on the two devices, and the bf16 hat forward on
              both). Random weights score every anchor above the recipe's
              0.6, which leaves the cls gradient (the backward kernel's
              dpx/dpy) zero; at 1.0 every positive has a loss, and the step
              must show a positive loss and a non-zero cls cotangent. The
              card's backward-kernel inputs are captured for phase 11.
 10. train    engine.train.trainval_loop at the default train recipe of
              get_default_cfg() (batch 4, 600x600 patches, class_batch_size 15
              padded to 16, class images of 240 px, SGD lr 1e-4, momentum 0.9,
              weight decay 1e-4, max_grad_norm 100, RLL with remapping,
              train_features) with Os2dConfig() at full width, on a synthetic
              planted dataset of 16 classes written under build/: TRAIN_STEPS
              steps and one eval with the objective as criterion. Finite losses
              and gradient norms, parameters that moved, and one launch of the
              hat kernel and one of the backward kernel per step.
 11. train_timing  TrainStep at the same recipe: median and spread of s/step
              over timed steps after one warmup step, with both kernels
              counted per step; then the backward kernel on phase 9's
              captured inputs: held against its plain version (rtol 1e-5,
              atol 1e-6 times each part's largest magnitude; no part may be
              all zeros) and timed per launch, beside its bound, its plain
              version and one PyTorch call that computes the same gradient
              (aten.grid_sampler_2d_backward; the port calls none of it).
              --profile adds a breakdown of one train step by kernel family.
Phase 2 also holds the resample's backward kernel (csrc/resample_backward.cu)
against its plain version: dpx and dpy at rtol 1e-5, atol 1e-6 (and whether
they agree to the bit), dcorr (fp32 atomic sums) at rtol 1e-5, atol 1e-6, on
the ragged shapes, integer and border coordinates and the training shape
(B=4, C=16, 38x38, T=121 of 225) on uniform and near-identity inputs.
Launch counts are set to 0 just before each of phases 3-7 and 9-11 and read
just after it; a phase whose kernel was not launched fails. Then one
{"kernels": [...]} line, the nvidia-smi line, and the last line
{"ok": true, "device": {...}}. Without a CUDA card it prints no result and
exits 1.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

# H100 SXM published peaks: HBM bytes/s and fp32 (non-tensor-core) flop/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# flops per template-point sample in the gather resample: floor x2,
# fractions x2, complements x2, 8 weight products, 4 corner products summed,
# mask multiply-add
RESAMPLE_FLOPS_PER_SAMPLE = 20
# and in the banded hat form: floor x2, four hat weights (two subtracts and
# a max each), four mask products, four row products and two row sums, two
# column products and their sum, the accumulate
HAT_FLOPS_PER_SAMPLE = 28
RTOL, ATOL = 1e-5, 1e-6
# the hat kernel rounds at its plain version's points and so agrees with it
# to the bit; this is the gate it has had since it ran on the tensor cores
HAT_RTOL, HAT_ATOL = 1e-5, 1e-5
DEFAULT_TIER_MARGIN = 4e-3  # engine.evaluate.prescreen_margin("default")

IMG_W, IMG_H = 1280, 960
PYRAMID = [0.5, 0.625, 0.8, 1, 1.2, 1.4, 1.6]
NUM_CLASSES = 16
BATCH = 2
TIMED_DISPATCHES = 6
TIER_ROUNDS = 4  # rounds of default, highest, highest, default in phase tiers
PATCH = 240
PLANTED = {0: [(48, 48, 0)], 1: [(336, 176, 1), (48, 112, 0)]}
EVAL_PYRAMID = [0.8, 1.0]
EVAL_TTA = "horflip_rotation90"
EVAL_SCORE_THRESHOLD = 0.5
PRESCREEN_CLASSES = 8
PRESCREEN_W, PRESCREEN_H = 320, 256
# the training phases: a planted dataset of TRAIN_CLASSES 240-px class
# patches in TRAIN_IMAGES scenes of TRAIN_SIZE px, one patch in each cell of
# a 2x2 grid (so the recipe's 600-px crops keep the patches near the 240-px
# anchor size and the remapped targets hold positives); the recipe is
# get_default_cfg()'s
TRAIN_CLASSES, TRAIN_IMAGES, TRAIN_SIZE = 16, 8, 640
TRAIN_STEPS = 4
TRAIN_TIMED_STEPS = 6
TRAIN_EVAL_IMAGES = 2
TRAIN_CPU_RTOL = 2e-3
# random weights score every anchor far above 0.6 against every class,
# positives and negatives alike, whatever is planted; at the recipe's
# margin_pos 0.6 no positive has a loss, and the cls gradient (the backward
# kernel's dpx/dpy, the TransformNet's gradient through them) is zero. The
# first step, which holds the card against the CPU and captures the
# backward kernel's inputs, takes margin_pos 1.0: every positive has a loss
FIRST_STEP_MARGIN_POS = 1.0
# flops per template-point sample in the backward kernel: the hat weights
# and derivatives of 4 rows and 4 columns (4 each: two subtracts, an abs, a
# max), dpx (4 rows of 2 products and a sum, then 2 products and a sum each),
# dpy (2 products, then 4 of 2 products and 2 sums), the 4 dcorr products
# (2 each) and the two cotangent products
BACKWARD_FLOPS_PER_SAMPLE = 90


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


def bound(bytes_, ops, ops_per_s):
    """(bound_ms, bound_by): the larger of the byte and the operation time."""
    bytes_ms, ops_ms = bytes_ / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def resample_bytes(b, c, a, t):
    """Each input read once (corr prefix, px, py, mask), the output written
    once; fp32 throughout."""
    return 4 * (3 * b * c * t * a + c * t + b * c * a)


def resample_bound(b, c, a, t):
    """The gather kernel: its fp32 operations against the fp32 rate."""
    return bound(resample_bytes(b, c, a, t), RESAMPLE_FLOPS_PER_SAMPLE * b * c * t * a,
                 FP32_FLOPS)


def hat_bound(b, c, a, t):
    """The hat kernel: the gather's bytes, its banded fp32 operations
    against the fp32 rate."""
    return bound(resample_bytes(b, c, a, t), HAT_FLOPS_PER_SAMPLE * b * c * t * a, FP32_FLOPS)


def backward_bytes(b, c, a, t, t_full):
    """dcorr (all t_full channels) written once, the corr prefix, px and py
    read once, dpx and dpy written once, the two cotangents and the mask
    read once; fp32 throughout."""
    return 4 * (b * c * a * t_full + b * c * a * t + 4 * b * c * t * a + 2 * b * c * a + c * t)


def backward_bound(b, c, a, t, t_full):
    return bound(backward_bytes(b, c, a, t, t_full), BACKWARD_FLOPS_PER_SAMPLE * b * c * t * a,
                 FP32_FLOPS)


def max_err_checked(got, want, what, rtol=RTOL, atol=ATOL):
    import torch

    torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=lambda m: f"{what}: {m}")
    return float((got - want).abs().max())


def random_resample_inputs(b, c, h, w, gen, kind, t_side=11):
    """corr [B, C, H, W, 225] in tanh range, px/py [B, C, T, H*W], mask_t
    [C, T]. kind "uniform": px/py spread over the map, some exactly on the
    borders; "outside": the same reaching 0.5 past each border;
    "near_identity": the anchor plus the template offset of the head's
    identity transform (15-px anchor boxes, t = tx*11 + ty), jittered by up
    to 0.25 px, as the main path with random weights gives them."""
    import torch

    dev = "cuda"
    corr = torch.tanh(torch.randn(b, c, h, w, 225, generator=gen, device=dev))
    t = t_side * t_side
    shape = (b, c, t, h * w)
    if kind in ("uniform", "outside"):
        pad = 0.5 if kind == "outside" else 0.0
        px = torch.rand(shape, generator=gen, device=dev) * (w - 1 + 2 * pad) - pad
        py = torch.rand(shape, generator=gen, device=dev) * (h - 1 + 2 * pad) - pad
        px[:, :, :7] = 0.0
        px[:, :, 7:14] = w - 1
        py[:, :, 3:10] = 0.0
        py[:, :, 10:17] = h - 1
    else:
        ti = torch.arange(t, device=dev)
        off_x = ((ti // t_side) - t_side // 2).float() * (15 / 14) + 0.5
        off_y = ((ti % t_side) - t_side // 2).float() * (15 / 14) + 0.5
        ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                                indexing="ij")

        def jitter():
            return (torch.rand(shape, generator=gen, device=dev) - 0.5) * 0.5

        px = (xs.reshape(-1).float() + off_x[:, None] + jitter()).clamp(0, w - 1)
        py = (ys.reshape(-1).float() + off_y[:, None] + jitter()).clamp(0, h - 1)
    mask_t = torch.full((c, t), 1.0 / t, device=dev)
    return corr, px.contiguous(), py.contiguous(), mask_t


def planted_scenes():
    """The two 640x480 scenes and two class patches of
    tests/test_end_to_end_eval.py (same seed, same draws)."""
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


def write_planted_dataset(root):
    """The planted scenes as the files and CSV-schema dataframe of
    tests/test_end_to_end_eval.py:30-69 (JPEG, quality 95)."""
    import pandas as pd
    from PIL import Image

    scenes, patches = planted_scenes()
    os.makedirs(os.path.join(root, "classes", "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "src"), exist_ok=True)
    for cid, patch in enumerate(patches):
        Image.fromarray(patch).save(os.path.join(root, "classes", "images", f"class{cid}.jpg"),
                                    quality=95)
    rows = []
    for image_id, plants in sorted(PLANTED.items()):
        for x0, y0, cid in plants:
            rows.append(dict(imageid=image_id, imagefilename=f"img{image_id}.jpg", classid=cid,
                             classfilename=f"class{cid}.jpg", gtbboxid=len(rows), difficult=0,
                             lx=x0 / 640, ty=y0 / 480, rx=(x0 + PATCH) / 640,
                             by=(y0 + PATCH) / 480))
        Image.fromarray(scenes[image_id]).save(os.path.join(root, "src", f"img{image_id}.jpg"),
                                               quality=95)
    return pd.DataFrame(rows)


def write_train_dataset(root):
    """A planted training set: TRAIN_CLASSES class patches of 240 px (8-px
    blocks of seeded random colors) and TRAIN_IMAGES noise scenes of
    TRAIN_SIZE px, each holding four patches, one in each cell of a 2x2 grid,
    every class in TRAIN_IMAGES * 4 / TRAIN_CLASSES scenes. Written as JPEG
    files and a CSV-schema dataframe."""
    import numpy as np
    import pandas as pd
    from PIL import Image

    rng = np.random.RandomState(1)
    os.makedirs(os.path.join(root, "classes", "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "src"), exist_ok=True)
    patches = []
    for cid in range(TRAIN_CLASSES):
        p = rng.randint(0, 255, (PATCH // 8, PATCH // 8, 3), np.uint8)
        patches.append(np.kron(p, np.ones((8, 8, 1), np.uint8)))
        Image.fromarray(patches[-1]).save(
            os.path.join(root, "classes", "images", f"class{cid}.jpg"), quality=95)
    cell = TRAIN_SIZE // 2
    rows = []
    for image_id in range(TRAIN_IMAGES):
        scene = rng.randint(0, 60, (TRAIN_SIZE, TRAIN_SIZE, 3), np.uint8)
        for k in range(4):
            cid = (image_id * 4 + k) % TRAIN_CLASSES
            x0 = (k % 2) * cell + rng.randint(0, cell - PATCH + 1)
            y0 = (k // 2) * cell + rng.randint(0, cell - PATCH + 1)
            scene[y0:y0 + PATCH, x0:x0 + PATCH] = patches[cid]
            rows.append(dict(imageid=image_id, imagefilename=f"img{image_id}.jpg", classid=cid,
                             classfilename=f"class{cid}.jpg", gtbboxid=len(rows), difficult=0,
                             lx=x0 / TRAIN_SIZE, ty=y0 / TRAIN_SIZE,
                             rx=(x0 + PATCH) / TRAIN_SIZE, by=(y0 + PATCH) / TRAIN_SIZE))
        Image.fromarray(scene).save(os.path.join(root, "src", f"img{image_id}.jpg"), quality=95)
    return pd.DataFrame(rows)


def detections_agree(got, want, box_atol=1e-2):
    """Every valid detection of `got` has one in `want` of the same image and
    class with score within 1e-4 and box within box_atol px, and the counts
    match (robust to the order of near-tied scores)."""
    import numpy as np

    for b in range(got["valid"].shape[0]):
        for g in range(got["valid"].shape[1]):
            gv, wv = got["valid"][b, g], want["valid"][b, g]
            if gv.sum() != wv.sum():
                return False
            ws, wb = want["scores"][b, g][wv], want["boxes"][b, g][wv]
            for s, box in zip(got["scores"][b, g][gv], got["boxes"][b, g][gv]):
                hit = (np.abs(ws - s) <= 1e-4) & (np.abs(wb - box).max(-1) <= box_atol)
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
    from os2d_torch.data.dataloader import DataloaderOneShotDetection
    from os2d_torch.data.dataset import DatasetOneShotDetection
    from os2d_torch.engine.evaluate import Evaluator, evaluate, unpack_detections
    from os2d_torch.models import Os2dConfig, Os2dModel
    from os2d_torch.models import head as head_module
    from os2d_torch.data.dataloader import build_train_dataloader_from_config
    from os2d_torch.engine.objective import ObjectiveConfig
    from os2d_torch.engine.optimization import create_optimizer
    from os2d_torch.engine.train import (
        TrainStep,
        prepare_batch_arrays,
        trainable_parameters,
        trainval_loop,
    )
    from os2d_torch.ops import hat_resample, resample, resample_grad
    from os2d_torch.ops.cuda import BUILD_DIR, build_all
    from os2d_torch.ops.sampling import (
        hat_resample_operand,
        hat_resample_reference,
        resample_backward_reference,
        resample_correlation_from_pxpy_reference,
    )
    from os2d_torch.structures.boxes import box_iou
    from os2d_torch.structures.feature_map import FeatureMapSize, feature_map_size_for_image

    kernels = {"resample_correlation": resample.KERNEL,
               "hat_resample_correlation": hat_resample.KERNEL,
               "resample_correlation_backward": resample_grad.KERNEL}

    def reset_counts():
        for k in kernels.values():
            k.launches = 0

    def read_counts():
        return {name: k.launches for name, k in kernels.items()}

    def require_launches(phase, counts, kernel, expected=None):
        n = counts[kernel]
        if n == 0 or (expected is not None and n != expected):
            raise SystemExit(f"{phase}: {kernel} launched {n} times, expected "
                             f"{'at least one' if expected is None else expected}")

    # ---- 1. environment and build ----
    smi = nvidia_smi_line()
    model = Os2dModel(Os2dConfig(), seed=0)
    t0 = time.perf_counter()
    logs = build_all([k.source for k in kernels.values()])
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "build_s": build_s, "built": sorted(logs), "ptxas": ptxas})

    # ---- 2. kernels against their plain versions ----
    # ragged small shapes (not multiples of the 8x32 anchor tile, a single
    # row, a single column), every level of the bench protocol (B=2, C=16)
    # and C=128 at the largest, each with uniform and with near-identity
    # px/py; px/py reaching 0.5 outside the map; a map taller than 256
    # rows; B*C above 65535
    sizes = [FeatureMapSize(w=int(IMG_W * s), h=int(IMG_H * s)) for s in PYRAMID]
    fms = [feature_map_size_for_image(sz) for sz in sizes]
    ragged = [(2, 3, 6, 7), (2, 3, 19, 23), (1, 2, 1, 7), (1, 2, 6, 1)]
    shapes = ragged + [(BATCH, NUM_CLASSES, fm.h, fm.w) for fm in fms]
    shapes += [(BATCH, 128, fms[-1].h, fms[-1].w)]
    cases = [(shape, kind) for shape in shapes for kind in ("uniform", "near_identity")]
    cases += [(shape, "outside") for shape in ragged]
    cases += [((1, 2, 300, 7), "uniform"), ((2, 32800, 3, 2), "uniform")]
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"resample_correlation": {}, "hat_resample_correlation": {}}
    hat_exact_errs = {}
    for (b, c, h, w), kind in cases:
        name = f"{kind}_{b}x{c}x{h}x{w}"
        corr, px, py, mask_t = random_resample_inputs(b, c, h, w, gen, kind)
        corr = corr[..., :121]
        exact = resample_correlation_from_pxpy_reference(corr, px, py, mask_t)
        got = resample.resample_correlation(corr, px, py, mask_t)
        torch.cuda.synchronize()
        errs["resample_correlation"][name] = max_err_checked(
            got, exact, f"resample kernel at {name}")
        got = hat_resample.resample_correlation_hat(corr, px, py, mask_t)
        torch.cuda.synchronize()
        want = hat_resample_reference(corr, px, py, mask_t)
        errs["hat_resample_correlation"][name] = max_err_checked(
            got, want, f"hat kernel at {name}", HAT_RTOL, HAT_ATOL)
        if kind != "outside":  # outside the map the hat form drops, the gather clamps
            hat_exact_errs[name] = float((got - exact).abs().max())
            if not hat_exact_errs[name] <= DEFAULT_TIER_MARGIN:
                raise SystemExit(f"hat kernel is {hat_exact_errs[name]} from the exact gather "
                                 f"at {name}, above the margin {DEFAULT_TIER_MARGIN}")
        del corr, px, py, mask_t, got, want, exact
    # the backward kernel: ragged shapes with uniform (some coordinates on
    # the borders), near-identity and integer coordinates (every sample on
    # a tie), and the training shape
    bwd_cases = [(shape, kind) for shape in ragged
                 for kind in ("uniform", "near_identity", "integer")]
    bwd_cases += [((4, 16, 38, 38), kind) for kind in ("uniform", "near_identity")]
    errs["resample_correlation_backward"] = {}
    for (b, c, h, w), kind in bwd_cases:
        name = f"{kind}_{b}x{c}x{h}x{w}"
        corr, px, py, mask_t = random_resample_inputs(
            b, c, h, w, gen, "uniform" if kind == "integer" else kind)
        if kind == "integer":
            px, py = px.floor().contiguous(), py.floor().contiguous()
        g = torch.randn(b, c, h * w, generator=gen, device="cuda")
        g_sum = g + torch.randn(b, c, h * w, generator=gen, device="cuda")
        got = resample_grad.resample_correlation_backward(g, g_sum, corr, px, py, mask_t)
        torch.cuda.synchronize()
        want = resample_backward_reference(g, g_sum, corr, px, py, mask_t, px.shape[2])
        errs["resample_correlation_backward"][name] = {
            part: max_err_checked(x, y, f"backward kernel {part} at {name}")
            for part, x, y in zip(("dcorr", "dpx", "dpy"), got, want)}
        if got[0][..., px.shape[2]:].any():
            raise SystemExit(f"backward kernel wrote dcorr channels >= T at {name}")
        del corr, px, py, mask_t, g, g_sum, got, want
    bwd_errs = errs["resample_correlation_backward"]
    emit({"phase": "kernel",
          "resample_correlation_backward": {
              "rtol": RTOL, "atol": ATOL, "max_abs_err": bwd_errs,
              "dpx_dpy_bit_equal": all(e["dpx"] == 0.0 and e["dpy"] == 0.0
                                       for e in bwd_errs.values()),
              "dcorr_bit_equal": all(e["dcorr"] == 0.0 for e in bwd_errs.values())}})
    emit({"phase": "kernel",
          "resample_correlation": {"rtol": RTOL, "atol": ATOL,
                                   "max_abs_err": errs["resample_correlation"],
                                   "bit_equal": all(
                                       e == 0.0 for e in errs["resample_correlation"].values())},
          "hat_resample_correlation": {"rtol": HAT_RTOL, "atol": HAT_ATOL,
                                       "max_abs_err": errs["hat_resample_correlation"],
                                       "bit_equal": all(
                                           e == 0.0
                                           for e in errs["hat_resample_correlation"].values()),
                                       "vs_exact_gather": hat_exact_errs,
                                       "exact_margin": DEFAULT_TIER_MARGIN}})

    # ---- 3. planted patches at the default tier, the card against the CPU ----
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
    reset_counts()
    for dev, m in (("cuda", model), ("cpu", cpu_model)):
        ev = Evaluator(m, cfg)
        head, _ = ev.build_class_heads(class_images)
        packed[dev] = unpack_detections(ev.detect_images(scenes, head, level, [(1.0, 1.0)], norm))
    planted_counts = read_counts()
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
                          "score": float(det["scores"][image_id, cid, top]),
                          "ok": bool(valid.any()) and iou > 0.5})
    agree = detections_agree(packed["cuda"], packed["cpu"])
    emit({"phase": "planted", "resample_precision": model.config.resample_precision,
          "found": found, "cuda_matches_cpu": agree, "launches": planted_counts})
    if not all(f["ok"] for f in found):
        raise SystemExit("planted patches were not all found")
    if not agree:
        raise SystemExit("detections on the card differ from the CPU's")
    require_launches("planted", planted_counts, "hat_resample_correlation")

    # ---- 4. evaluate() to VOC mAP: data layer, TTA, prescreen ----
    eval_cfg = get_default_cfg()
    eval_cfg.eval.mAP_iou_thresholds = [0.5]
    eval_cfg.eval.class_image_augmentation = EVAL_TTA
    eval_cfg.eval.nms_score_threshold = EVAL_SCORE_THRESHOLD
    eval_cfg.tpu.eval_pre_top_k = 256
    eval_cfg.tpu.eval_top_k = 32
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as root:
        df = write_planted_dataset(root)
        dataset = DatasetOneShotDetection(
            df, gt_path=os.path.join(root, "classes", "images"),
            image_path=os.path.join(root, "src"), name="planted", image_size=640,
            eval_scale=640, cache_images=True)
        loader = DataloaderOneShotDetection(dataset, batch_size=1,
                                            pyramid_scales_eval=EVAL_PYRAMID)
        reset_counts()
        t0 = time.perf_counter()
        results = evaluate(loader, model, eval_cfg)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        eval_counts = read_counts()
        t0 = time.perf_counter()
        cpu_results = evaluate(loader, cpu_model, eval_cfg)
        cpu_eval_s = time.perf_counter() - t0
    emit({"phase": "evaluate", "data": "files (PIL + pandas) through os2d_torch.data",
          "levels": EVAL_PYRAMID, "class_image_augmentation": EVAL_TTA,
          "nms_score_threshold": EVAL_SCORE_THRESHOLD,
          "mAP@0.50": results["mAP@0.50"], "recall@0.50": results["recall@0.50"],
          "prescreen_pruned": results.get("prescreen_pruned"),
          "cpu_mAP@0.50": cpu_results["mAP@0.50"],
          "cpu_prescreen_pruned": cpu_results.get("prescreen_pruned"),
          "launches": eval_counts, "seconds": eval_s, "cpu_seconds": cpu_eval_s})
    if "prescreen_pruned" not in results:
        raise SystemExit("evaluate() did not go through the class prescreen")
    if not results["mAP@0.50"] >= 0.9:
        raise SystemExit(f"evaluate() mAP@0.50 {results['mAP@0.50']} < 0.9")
    if cpu_results["mAP@0.50"] != results["mAP@0.50"]:
        raise SystemExit(f"evaluate() mAP@0.50 {results['mAP@0.50']} on the card, "
                         f"{cpu_results['mAP@0.50']} on the CPU")
    require_launches("evaluate", eval_counts, "hat_resample_correlation")

    # ---- 5. the prescreen pruning some classes, the card against the CPU ----
    # random-init features give every class of a real bank a ceiling near
    # 0.99, so the bank is one-hot as in tests/test_torch_prescreen.py: class
    # k correlates with feature channel 240 + k, its ceiling has real spread
    ps_cfg = get_default_cfg()
    ps_cfg.tpu.eval_class_chunk = 2
    ps_cfg.tpu.eval_pre_top_k = 256
    ps_cfg.tpu.eval_top_k = 32
    ps_feats = torch.zeros(PRESCREEN_CLASSES, 15, 15, 1024)
    for k in range(PRESCREEN_CLASSES):
        ps_feats[k, :, :, 240 + k] = 1.0
    ps_scene = np.random.RandomState(0).randint(0, 255, (1, PRESCREEN_H, PRESCREEN_W, 3),
                                                np.uint8)
    ps_level = [FeatureMapSize(w=PRESCREEN_W, h=PRESCREEN_H)]
    ps = {}
    for dev, m in (("cuda", model), ("cpu", cpu_model)):
        ps_head = head_module.ClassHead(ps_feats.to(dev),
                                        head_module.make_class_pool_mask(PRESCREEN_CLASSES,
                                                                         device=dev))
        ev = Evaluator(m, ps_cfg)
        if dev == "cuda":
            # a threshold between the classes' best scores, as the tests pick it
            ps_cfg.eval.nms_score_threshold = float("-inf")
            full0 = unpack_detections(ev.detect_images(ps_scene, ps_head, ps_level,
                                                       [(1.0, 1.0)], norm))
            ps_cfg.eval.nms_score_threshold = float(np.median(full0["scores"][0].max(1)))
            ps["full"] = unpack_detections(ev.detect_images(ps_scene, ps_head, ps_level,
                                                            [(1.0, 1.0)], norm))
            reset_counts()
        pre = ev.detect_images_prescreened(ps_scene, ps_head, ps_level, [(1.0, 1.0)], norm)
        if dev == "cuda":
            torch.cuda.synchronize()
            ps_counts = read_counts()
        ps[dev] = unpack_detections(pre)
        ps[dev + "_pruned"] = ev.prescreen_pruned
    ps_match_full = detections_agree(ps["cuda"], ps["full"], box_atol=1e-3)
    ps_match_cpu = detections_agree(ps["cuda"], ps["cpu"])
    emit({"phase": "prescreen", "classes": PRESCREEN_CLASSES,
          "image": f"{PRESCREEN_W}x{PRESCREEN_H}",
          "nms_score_threshold": ps_cfg.eval.nms_score_threshold,
          "pruned": ps["cuda_pruned"], "cpu_pruned": ps["cpu_pruned"],
          "kept_rows": int((ps["cuda"]["valid"][0].sum(1) > 0).sum()),
          "matches_full_path": ps_match_full, "cuda_matches_cpu": ps_match_cpu,
          "launches": ps_counts})
    if not 0 < ps["cuda_pruned"] < PRESCREEN_CLASSES:
        raise SystemExit(f"prescreen pruned {ps['cuda_pruned']} of {PRESCREEN_CLASSES} "
                         f"classes: the partial prune was not exercised")
    if ps["cpu_pruned"] != ps["cuda_pruned"]:
        raise SystemExit(f"prescreen pruned {ps['cuda_pruned']} classes on the card, "
                         f"{ps['cpu_pruned']} on the CPU")
    if not ps_match_full:
        raise SystemExit("prescreened detections differ from the full path's on the card")
    if not ps_match_cpu:
        raise SystemExit("prescreened detections on the card differ from the CPU's")
    require_launches("prescreen", ps_counts, "hat_resample_correlation")
    del cpu_model

    # ---- 6./7. main path at the bench protocol, both tiers ----
    cfg = get_default_cfg()
    cfg.tpu.eval_class_chunk = NUM_CLASSES
    rng = np.random.RandomState(0)
    class_images = [rng.randn(240, 240, 3).astype(np.float32) for _ in range(NUM_CLASSES)]
    inv = [(IMG_W / sz.w, IMG_H / sz.h) for sz in sizes]
    anchors = sum(fm.w * fm.h for fm in fms)
    batches = [np.random.RandomState(i).randint(0, 255, (BATCH, IMG_H, IMG_W, 3), np.uint8)
               for i in range(TIMED_DISPATCHES + 1)]
    model_highest = Os2dModel(Os2dConfig(resample_precision="highest"), seed=0)
    model_highest.load_state_dict(model.state_dict())

    def run_main(phase, m, n_timed, kernel, bound_ms_per_dispatch):
        ev = Evaluator(m, cfg)
        class_head, _ = ev.build_class_heads(class_images)
        t0 = time.perf_counter()
        ev.detect_images(batches[-1], class_head, sizes, inv, norm)
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0

        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        times, outputs = [], []
        for i in range(n_timed):
            t0 = time.perf_counter()
            out = ev.detect_images(batches[i], class_head, sizes, inv, norm)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            outputs.append(out)
        counts = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        for out in outputs:
            if tuple(out.shape) != (BATCH, NUM_CLASSES, int(cfg.tpu.eval_top_k), 6):
                raise SystemExit(f"{phase}: packed output has shape {tuple(out.shape)}")
            d = unpack_detections(out)
            if not (np.isfinite(d["boxes"]).all() and np.isfinite(d["scores"][d["valid"]]).all()
                    and d["valid"].any()):
                raise SystemExit(f"{phase}: non-finite or no detections")
        require_launches(phase, counts, kernel, len(PYRAMID) * n_timed)
        median = float(np.median(times))
        emit({"phase": phase, "resample_precision": m.config.resample_precision,
              "images": f"{BATCH}x{IMG_W}x{IMG_H} uint8", "levels": len(sizes),
              "anchors_per_image": anchors, "classes": NUM_CLASSES, "warmup_s": warmup_s,
              "dispatch_s": times, "median_dispatch_s": median, "img_per_s": BATCH / median,
              "img_per_s_spread": [BATCH / max(times), BATCH / min(times)],
              "launches": counts, "resample_bound_ms_per_dispatch": bound_ms_per_dispatch,
              "peak_gb": peak_gb})
        return ev, class_head, counts, median

    ev, class_head, main_counts, main_median = run_main(
        "main", model, TIMED_DISPATCHES, "hat_resample_correlation",
        sum(hat_bound(BATCH, NUM_CLASSES, fm.h * fm.w, 121)[0] for fm in fms))
    ev_highest, class_head_highest, highest_counts, _ = run_main(
        "main_highest", model_highest, TIMED_DISPATCHES, "resample_correlation",
        sum(resample_bound(BATCH, NUM_CLASSES, fm.w * fm.h, 121)[0] for fm in fms))

    # the two tiers in turns (default, highest, highest, default, ...), so
    # that neither gains from running later in the process
    tier_runs = {"default": (ev, class_head), "highest": (ev_highest, class_head_highest)}
    tier_times = {"default": [], "highest": []}
    for i, tier in enumerate(["default", "highest", "highest", "default"] * TIER_ROUNDS):
        tier_ev, tier_head = tier_runs[tier]
        t0 = time.perf_counter()
        tier_ev.detect_images(batches[i % TIMED_DISPATCHES], tier_head, sizes, inv, norm)
        torch.cuda.synchronize()
        tier_times[tier].append(time.perf_counter() - t0)
    tier_median = {k: float(np.median(v)) for k, v in tier_times.items()}
    emit({"phase": "tiers", "order": "default, highest, highest, default, ...",
          "dispatch_s": tier_times,
          "img_per_s": {k: BATCH / m for k, m in tier_median.items()},
          "img_per_s_spread": {k: [BATCH / max(v), BATCH / min(v)]
                               for k, v in tier_times.items()},
          "median_dispatch_ms": {k: m * 1e3 for k, m in tier_median.items()},
          "default_at_least_highest": tier_median["default"] <= tier_median["highest"]})
    del tier_runs, ev_highest, class_head_highest, model_highest

    # ---- 8. both kernels on the main path's own inputs ----
    # one more dispatch with the head's resample inputs captured at every
    # level; both kernels are held against their plain versions and timed
    # there, and on the largest level set beside their bounds, their plain
    # versions and one PyTorch call each
    captured = []
    original = resample_grad.FORWARD["default"]

    def capture(corr, px, py, mask_t):
        out = original(corr, px, py, mask_t)
        captured.append((corr, px, py, mask_t, out))
        return out

    resample_grad.FORWARD["default"] = capture
    try:
        ev.detect_images(batches[0], class_head, sizes, inv, norm)
    finally:
        resample_grad.FORWARD["default"] = original
    torch.cuda.synchronize()
    if len(captured) != len(PYRAMID):
        raise SystemExit(f"captured {len(captured)} resample calls, expected {len(PYRAMID)}")
    main_exact_errs = {}
    level_ms = {"resample_correlation": {}, "hat_resample_correlation": {}}
    for corr, px, py, mask_t, hat_level in captured:
        name = f"main_path_{corr.shape[2]}x{corr.shape[3]}"
        level_ms["resample_correlation"][name] = cuda_ms(
            lambda: resample.resample_correlation(corr, px, py, mask_t), 10)
        level_ms["hat_resample_correlation"][name] = cuda_ms(
            lambda: hat_resample.resample_correlation_hat(corr, px, py, mask_t), 10)
        exact = resample_correlation_from_pxpy_reference(corr, px, py, mask_t)
        errs["resample_correlation"][name] = max_err_checked(
            resample.resample_correlation(corr, px, py, mask_t), exact,
            f"resample kernel on main-path inputs at {name}")
        errs["hat_resample_correlation"][name] = max_err_checked(
            hat_level, hat_resample_reference(corr, px, py, mask_t),
            f"hat kernel on main-path inputs at {name}", HAT_RTOL, HAT_ATOL)
        main_exact_errs[name] = float((hat_level - exact).abs().max())
        if not main_exact_errs[name] <= DEFAULT_TIER_MARGIN:
            raise SystemExit(f"hat kernel is {main_exact_errs[name]} from the exact gather on "
                             f"the main path's inputs at {name}, above the margin "
                             f"{DEFAULT_TIER_MARGIN}")
        del exact
    emit({"phase": "main_path_inputs", "levels": len(captured),
          "max_abs_err": {k: {n: e for n, e in v.items() if n.startswith("main_path_")}
                          for k, v in errs.items()},
          "hat_vs_exact_gather": main_exact_errs, "ms": level_ms,
          "ms_per_dispatch": {k: sum(v.values()) for k, v in level_ms.items()}})
    corr, px, py, mask_t, hat_out = max(captured, key=lambda x: x[0].shape[2] * x[0].shape[3])
    del captured
    b, c, h, w, _ = corr.shape
    t, a = px.shape[2], h * w
    shape = {"B": b, "C": c, "H": h, "W": w, "T": t, "corr_row_stride": corr.stride(3)}
    largest_name = f"main_path_{h}x{w}"

    # the gather kernel
    exact = resample_correlation_from_pxpy_reference(corr, px, py, mask_t)
    gather_out = resample.resample_correlation(corr, px, py, mask_t)
    gather_ms = cuda_ms(lambda: resample.resample_correlation(corr, px, py, mask_t), 20)
    gather_plain_ms = cuda_ms(
        lambda: resample_correlation_from_pxpy_reference(corr, px, py, mask_t), 5)
    # yardstick: grid_sample (border, align_corners) on corr viewed as
    # [B*C*T, 1, H, W], then the masked sum; inputs laid out outside the timing
    planes = corr.permute(0, 1, 4, 2, 3).reshape(b * c * t, 1, h, w).contiguous()
    grid = torch.stack([px / (w - 1) * 2 - 1, py / (h - 1) * 2 - 1], -1).reshape(b * c * t, 1, a, 2)

    def grid_sample_library():
        s = F.grid_sample(planes, grid, mode="bilinear", padding_mode="border",
                          align_corners=True)
        return (s.view(b, c, t, a) * mask_t[None, :, :, None]).sum(2)

    gather_library_err = float((grid_sample_library().view(b, c, h, w) - gather_out).abs().max())
    gather_library_ms = cuda_ms(grid_sample_library, 5)
    del planes, grid
    gather_bound_ms, gather_bound_by = resample_bound(b, c, a, t)
    emit({"phase": "resample_timing", "kernel": "resample_correlation", "shape": shape,
          "ms": gather_ms, "plain_ms": gather_plain_ms, "library_ms": gather_library_ms,
          "library": "F.grid_sample + masked sum", "library_max_abs_err": gather_library_err,
          "bound_ms": gather_bound_ms, "bound_by": gather_bound_by,
          "max_abs_err": errs["resample_correlation"][largest_name]})

    # the hat kernel; yardstick: grid_sample (zeros padding, as the hat form
    # drops what lies outside the map, align_corners) on the planes of
    # M = bf16(corr * mask) held in fp32, then the sum over t; M laid out
    # outside the timing
    hat_ms = cuda_ms(lambda: hat_resample.resample_correlation_hat(corr, px, py, mask_t), 20)
    hat_plain_ms = cuda_ms(lambda: hat_resample_reference(corr, px, py, mask_t), 3)
    planes = hat_resample_operand(corr, mask_t).float().view(b * c * t, 1, h, w)
    grid = torch.stack([px / (w - 1) * 2 - 1, py / (h - 1) * 2 - 1], -1).reshape(b * c * t, 1, a, 2)

    def hat_library():
        s = F.grid_sample(planes, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=True)
        return s.view(b, c, t, a).sum(2)

    hat_library_err = float((hat_library().view(b, c, h, w) - hat_out).abs().max())
    hat_library_ms = cuda_ms(hat_library, 5)
    del planes, grid
    hat_bound_ms, hat_bound_by = hat_bound(b, c, a, t)
    emit({"phase": "resample_timing", "kernel": "hat_resample_correlation", "shape": shape,
          "ms": hat_ms, "plain_ms": hat_plain_ms, "library_ms": hat_library_ms,
          "library": "F.grid_sample over bf16(corr * mask) + sum over t",
          "library_max_abs_err": hat_library_err, "bound_ms": hat_bound_ms,
          "bound_by": hat_bound_by,
          "max_abs_err": errs["hat_resample_correlation"][largest_name],
          "vs_exact_gather": main_exact_errs[largest_name]})
    del corr, px, py, mask_t, exact, gather_out, hat_out

    # ---- 9.-11. the training path at the default recipe ----
    train_cfg = get_default_cfg()
    train_cfg.train.optim.max_iter = TRAIN_STEPS
    train_cfg.eval.iter = TRAIN_STEPS  # evals with the criterion before and after the steps
    train_cfg.eval.mAP_iou_thresholds = [0.5]
    train_cfg.tpu.device_class_cache = "off"
    objective = ObjectiveConfig()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as root:
        df = write_train_dataset(root)
        train_set = DatasetOneShotDetection(
            df, gt_path=os.path.join(root, "classes", "images"),
            image_path=os.path.join(root, "src"), name="planted-train", image_size=TRAIN_SIZE,
            eval_scale=TRAIN_SIZE, cache_images=True)
        train_loader, _ = build_train_dataloader_from_config(train_cfg, train_set, seed=0)
        eval_loader = DataloaderOneShotDetection(train_set.copy_subset(TRAIN_EVAL_IMAGES),
                                                 batch_size=1, pyramid_scales_eval=[1.0])
    train_batch = train_loader.get_batch(0)

    # 9. the first step on the card and on the CPU from the same weights, at
    # FIRST_STEP_MARGIN_POS (see its comment); the card's backward inputs are
    # captured for phase 11
    train_model = Os2dModel(Os2dConfig(), seed=1)
    cpu_train_model = Os2dModel(Os2dConfig(), device="cpu")
    cpu_train_model.load_state_dict({k: v.cpu() for k, v in train_model.state_dict().items()})
    first_objective = ObjectiveConfig(margin_pos=FIRST_STEP_MARGIN_POS)
    first, captured = {}, []
    original_backward = resample_grad.resample_correlation_backward

    def capture_backward(*args):
        captured.append(args)
        return original_backward(*args)

    for dev, m in (("cuda", train_model), ("cpu", cpu_train_model)):
        opt = create_optimizer(train_cfg.train.optim, trainable_parameters(m, train_cfg.train))
        step = TrainStep(m, first_objective, opt, train_cfg.train)
        arrays, c_pad = prepare_batch_arrays(train_batch, m.device)
        if dev == "cuda":
            reset_counts()
            resample_grad.resample_correlation_backward = capture_backward
        t0 = time.perf_counter()
        try:
            first[dev] = step(arrays, c_pad)
        finally:
            resample_grad.resample_correlation_backward = original_backward
        first[dev + "_s"] = time.perf_counter() - t0
        if dev == "cuda":
            first_counts = read_counts()
    del cpu_train_model
    if len(captured) != 1:
        raise SystemExit(f"captured {len(captured)} backward calls in one step, expected 1")
    step_bwd_inputs = tuple(x.detach() for x in captured.pop())
    first_err = {k: abs(first["cuda"][k] - first["cpu"][k]) / max(abs(first["cpu"][k]), 1e-12)
                 for k in first["cpu"]}
    emit({"phase": "train_first_step", "batch": list(arrays["images"].shape),
          "classes_padded": c_pad, "margin_pos": FIRST_STEP_MARGIN_POS,
          "cuda": first["cuda"], "cpu": first["cpu"],
          "relative_err": first_err, "rtol": TRAIN_CPU_RTOL, "cuda_s": first["cuda_s"],
          "cpu_s": first["cpu_s"], "launches": first_counts})
    if not all(np.isfinite(v) for v in first["cuda"].values()):
        raise SystemExit(f"train_first_step: non-finite metrics {first['cuda']}")
    if not first["cuda"]["cls_RLL_pos"] > 0:
        raise SystemExit("train_first_step: no positive scores below margin_pos, so the cls "
                         "gradient, and with it the backward's dpx/dpy, is zero")
    if not float(step_bwd_inputs[0].abs().max()) > 0:
        raise SystemExit("train_first_step: the captured cls cotangent is all zeros")
    for k in ("loss", "grad_norm"):
        if not first_err[k] <= TRAIN_CPU_RTOL:
            raise SystemExit(f"train_first_step: {k} {first['cuda'][k]} on the card, "
                             f"{first['cpu'][k]} on the CPU")
    require_launches("train_first_step", first_counts, "hat_resample_correlation", 1)
    require_launches("train_first_step", first_counts, "resample_correlation_backward", 1)

    # 10. trainval_loop: the train steps and the evals with the criterion
    watched = ("backbone.conv1.weight", "backbone.layer3.5.conv3.weight",
               "transform_net.linear.weight", "backbone.layer1.0.bn1.running_var")
    before = {k: train_model.state_dict()[k].clone() for k in watched}
    train_opt = create_optimizer(train_cfg.train.optim,
                                 trainable_parameters(train_model, train_cfg.train))
    reset_counts()
    t0 = time.perf_counter()
    full_log, _ = trainval_loop(train_loader, train_model, train_cfg, objective, train_opt,
                                dataloaders_eval=[eval_loader])
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    loop_counts = read_counts()
    moved = {k: float((train_model.state_dict()[k] - before[k]).abs().max()) for k in watched}
    series = {k: v for k, v in full_log.items() if k != "time"}
    emit({"phase": "train", "steps": TRAIN_STEPS, "eval_images": TRAIN_EVAL_IMAGES,
          "log": series, "param_max_change": moved, "seconds": loop_s,
          "launches": loop_counts})
    finite_keys = ["train_loss", "train_grad_norm", f"loss_{eval_loader.get_name()}"]
    for k in finite_keys:
        values = [v for v in full_log.get(k, []) if not np.isnan(v)]
        if not values or not np.isfinite(values).all():
            raise SystemExit(f"train: the log's {k} is {full_log.get(k)}")
    if not all(v > 0 for v in moved.values()):
        raise SystemExit(f"train: parameters did not move: {moved}")
    require_launches("train", loop_counts, "resample_correlation_backward", TRAIN_STEPS)
    if loop_counts["hat_resample_correlation"] < TRAIN_STEPS:
        raise SystemExit(f"train: the hat kernel launched {loop_counts} times")

    # 11. TrainStep timing, then the backward kernel on the first step's inputs
    step = TrainStep(train_model, objective, train_opt, train_cfg.train)
    arrays, c_pad = prepare_batch_arrays(train_batch, "cuda")
    t0 = time.perf_counter()
    step(arrays, c_pad)
    torch.cuda.synchronize()
    train_warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    step_times, step_counts = [], []
    for _ in range(TRAIN_TIMED_STEPS):
        reset_counts()
        t0 = time.perf_counter()
        metrics = step(arrays, c_pad)
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t0)
        step_counts.append(read_counts())
        if not all(np.isfinite(v) for v in metrics.values()):
            raise SystemExit(f"train_timing: non-finite metrics {metrics}")
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for counts in step_counts:
        require_launches("train_timing", counts, "hat_resample_correlation", 1)
        require_launches("train_timing", counts, "resample_correlation_backward", 1)
    train_median = float(np.median(step_times))
    emit({"phase": "train_timing", "recipe": "get_default_cfg() train: batch 4, 600x600, "
          "15 classes padded to 16, class images 240 px, SGD", "warmup_s": train_warmup_s,
          "step_s": step_times, "median_step_s": train_median,
          "step_s_spread": [min(step_times), max(step_times)],
          "launches_per_step": step_counts[0], "peak_gb": train_peak_gb})

    g, g_sum, corr, px, py, mask_t = step_bwd_inputs
    del step_bwd_inputs
    b, c, h, w, t_full = corr.shape
    t, a = px.shape[2], h * w
    got = resample_grad.resample_correlation_backward(g, g_sum, corr, px, py, mask_t)
    want = resample_backward_reference(g, g_sum, corr, px, py, mask_t, t)
    name = f"train_first_step_{b}x{c}x{h}x{w}"
    # the step's gradients are small: each part is held at the random cases'
    # atol taken relative to its largest magnitude; a part that is all zeros
    # would hold no kernel to anything
    want_max = {part: float(y.abs().max()) for part, y in zip(("dcorr", "dpx", "dpy"), want)}
    if not all(v > 0 for v in want_max.values()):
        raise SystemExit(f"train_timing: the first step's backward has an all-zero part "
                         f"{want_max} (max |g| {float(g.abs().max())})")
    errs["resample_correlation_backward"][name] = {
        part: max_err_checked(x, y, f"backward kernel {part} on the first step's inputs",
                              atol=ATOL * want_max[part])
        for part, x, y in zip(("dcorr", "dpx", "dpy"), got, want)}
    del got, want
    bwd_ms = cuda_ms(lambda: resample_grad.resample_correlation_backward(
        g, g_sum, corr, px, py, mask_t), 20)
    bwd_plain_ms = cuda_ms(lambda: resample_backward_reference(
        g, g_sum, corr, px, py, mask_t, t), 3)
    # yardstick: one aten.grid_sampler_2d_backward (bilinear, zeros padding as
    # the hat form drops what lies outside, align_corners) over the corr
    # planes for the cotangent g * mask; inputs laid out outside the timing
    planes = corr[..., :t].permute(0, 1, 4, 2, 3).reshape(b * c * t, 1, h, w).contiguous()
    grid = torch.stack([px / (w - 1) * 2 - 1, py / (h - 1) * 2 - 1], -1).reshape(
        b * c * t, 1, a, 2)
    grad_out = (g[:, :, None, :] * mask_t[None, :, :, None]).reshape(b * c * t, 1, 1, a)

    def grid_sample_backward():
        return torch.ops.aten.grid_sampler_2d_backward(grad_out, planes, grid, 0, 0, True,
                                                       [True, True])

    bwd_library_ms = cuda_ms(grid_sample_backward, 5)
    del planes, grid, grad_out
    bwd_bound_ms, bwd_bound_by = backward_bound(b, c, a, t, t_full)
    emit({"phase": "train_timing", "kernel": "resample_correlation_backward",
          "shape": {"B": b, "C": c, "H": h, "W": w, "T": t, "T_full": t_full},
          "ms": bwd_ms, "plain_ms": bwd_plain_ms, "library_ms": bwd_library_ms,
          "library": "aten.grid_sampler_2d_backward (grad of planes and grid)",
          "bound_ms": bwd_bound_ms, "bound_by": bwd_bound_by,
          "max_abs_err": errs["resample_correlation_backward"][name],
          "max_abs_want": want_max, "max_abs_g": float(g.abs().max()),
          "atol_relative": ATOL, "rtol": RTOL})
    del g, g_sum, corr, px, py, mask_t

    if "--profile" in argv:
        profile_run("profile", lambda: ev.detect_images(batches[0], class_head, sizes, inv, norm),
                    main_median)
        profile_run("profile_train", lambda: step(arrays, c_pad), train_median)

    emit({"kernels": [{
        "name": "resample_correlation",
        "route": "cuda",
        "source": "os2d_torch/csrc/resample.cu",
        "replaces": "os2d_tpu/ops/pallas_resample.py:24",
        "launches": highest_counts["resample_correlation"],
        "max_abs_err": max(errs["resample_correlation"].values()),
        "ms": gather_ms,
        "plain_ms": gather_plain_ms,
        "bound_ms": gather_bound_ms,
        "bound_by": gather_bound_by,
        "library_ms": gather_library_ms,
    }, {
        "name": "hat_resample_correlation",
        "route": "cuda",
        "source": "os2d_torch/csrc/hat_resample.cu",
        "replaces": "os2d_tpu/ops/pallas_hat_resample.py:42",
        "launches": main_counts["hat_resample_correlation"],
        "max_abs_err": max(errs["hat_resample_correlation"].values()),
        "ms": hat_ms,
        "plain_ms": hat_plain_ms,
        "bound_ms": hat_bound_ms,
        "bound_by": hat_bound_by,
        "library_ms": hat_library_ms,
    }, {
        "name": "resample_correlation_backward",
        "route": "cuda",
        "source": "os2d_torch/csrc/resample_backward.cu",
        "replaces": "os2d_tpu/ops/sampling.py:147",
        "launches": loop_counts["resample_correlation_backward"],
        "max_abs_err": max(max(e.values())
                           for e in errs["resample_correlation_backward"].values()),
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
        "bound_ms": bwd_bound_ms,
        "bound_by": bwd_bound_by,
        "library_ms": bwd_library_ms,
    }]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# kernel families of a dispatch's device time, by substring of the kernel
# name, first match wins
KERNEL_FAMILIES = (
    ("resample backward kernel", ("resample_backward",)),
    ("hat resample kernel", ("HatResample",)),
    ("resample kernel", ("GatherResample",)),
    ("conv FFT", ("fft", "pointwise_mult_and_sum_complex")),
    ("conv backward (dgrad, wgrad)", ("dgrad", "wgrad")),
    ("conv implicit GEMM", ("fprop", "convolve")),
    ("GEMM", ("gemm",)),
    ("layout and copies", ("Nhwc", "Nchw", "copy")),
)


def kernel_family(name):
    for family, keys in KERNEL_FAMILIES:
        if any(k in name for k in keys):
            return family
    return "elementwise and other"


def is_annotation(evt):
    """A record_function range (Optimizer.step#SGD.step) that the profiler
    also reports on the device timeline: its time is its kernels', counted
    under their own names. A kernel's name may hold "#" too (a lambda's
    `{lambda()#1}`, in most of at::native's elementwise and reduce kernels),
    so "#" alone does not mark a range."""
    return getattr(evt, "is_user_annotation", False) or ("#" in evt.key and "(" not in evt.key)


def profile_run(phase, fn, untraced_s):
    """Device time by kernel over one call of fn, an eval dispatch or a train
    step (torch.profiler). The idle share is taken against the untraced
    median time, since the profiler's own start-up inflates the traced wall
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or is_annotation(evt):
            continue
        dev_us = getattr(evt, "device_time_total", 0) or getattr(evt, "cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, evt.key, evt.count))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    families = {}
    for ms, key, _ in rows:
        families[kernel_family(key)] = families.get(kernel_family(key), 0.0) + ms
    emit({"phase": phase, "traced_wall_ms": wall_ms, "device_ms": device_ms,
          "untraced_ms": untraced_s * 1e3,
          "device_idle_share": (1 - device_ms / (untraced_s * 1e3)) if rows else None,
          "families_ms": dict(sorted(families.items(), key=lambda kv: -kv[1])),
          "top": [{"kernel": k[:120], "ms": ms, "calls": n} for ms, k, n in rows[:25]]})


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
