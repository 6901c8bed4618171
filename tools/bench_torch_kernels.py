#!/usr/bin/env python3
"""Time the PyTorch port's CUDA kernels on one NVIDIA card.

    python3 tools/bench_torch_kernels.py                      # the kernel table
    python3 tools/bench_torch_kernels.py --kernels forward --levels all --parent DIR
    python3 tools/bench_torch_kernels.py --kernels backward --parent DIR [--profile]
    python3 tools/bench_torch_kernels.py --kernels int8 --levels all --parent DIR
    python3 tools/bench_torch_kernels.py --kernels forward --variants rows16,chunk16

Table (`--kernels table`, the default, or `all`): one JSON line per row of
the kernel table in PERF.md, each with the kernel's CUDA-event ms per
launch, its plain PyTorch version's ms (ops/), the ms of one library call
that computes the same function where there is one, and the least time by
bytes and operations with the term that sets it (`bound_ms`, `bound_by`):
  - "gather", "hat", "int8" (from theta): the head's resample inputs of one
    default-tier dispatch at the benchmark's eval protocol (`Os2dConfig()`,
    seed-0 weights, B=2 uint8 images of 1280x960, the 7-level pyramid, 16
    classes in one chunk), captured at every level; a row per level with
    the three kernels' ms, then one row per kernel at the largest level;
  - "backward": the inputs of the resample backward in a first TrainStep at
    the default train recipe's shapes (tools/trace_conv_determinism_torch.py:
    `default_recipe_train_arrays`, batch 4 of 600x600, 16 classes of 240 px;
    seed-1 weights, RLL's margin_pos at 1.0 so that every positive has a
    loss);
  - "group_norm_forward", "group_norm_backward": the GroupNorm kernels at
    GN_SLOTS (the stem, layer1 and layer3 slots of exp2's 4 x 600-px scene
    pass, the stem and layer3 slots of its 16 x 240-px class pass);
  - "frozen_bn_act": the frozen BatchNorm kernel at FBN_SLOTS of the eval
    protocol's 1.6 level, beside ATen's eager chain and the host's
    microseconds a call of each;
  - "roi_align": the RoIAlign kernel at the CoAE cell's shapes (32 pairs of
    60x80x1024 maps, 300 RoIs each of the anchors' sizes, clipped to the
    1280x960 image), beside its plain version on the card; its bytes those
    of `hopper_bench/counts/coae.py: roi_align_bytes` with each pair's
    touched cells (`touched_cells`).
The bounds come from hopper_bench/counts: `flops.bound_s` against the HBM
and fp32 rates of peaks.json, `flops.hat_bytes_ops` and
`backward_bytes_ops`, `group_norm.slot_bytes`; the gather's, the int8
kernel's and the frozen BatchNorm's bytes and operations, which the
benchmark does not count, are counted here. First a line per package with
its sources' nvcc seconds and ptxas registers and spills.

Forward (`--kernels forward` or `all`): inputs of the bench protocol's
levels (B=2, C=16, T=121 of 225 channels, fm from the 1280x960 image at
pyramid [0.5 .. 1.6]) of two kinds: "uniform" px/py spread over the whole
map, and "near_identity" px/py at the anchor plus the template offset of
the head's identity transform, jittered by up to 0.25 px (the main path
with random weights has the identity transform exactly). For each level,
kind and kernel package it prints one JSON line: CUDA-event ms per wrapper
call and the max error against the plain version (ops/sampling.py).

int8 (`--kernels int8` or `all`): the int8 kernel at the same levels on
theta of three kinds, "identity" (the main path with random weights),
"near_identity" (each entry moved by up to 0.05) and "random" (entries in
[-1, 1]), with the anchors' boxes and the template lattice of the head
(`random_theta_inputs`). A package whose wrapper takes theta
(`resample_correlation_int8_theta`) gets theta; an older one gets the px/py
that this checkout's `ops.geometry.interior_sample_coords` forms from it
(their time, which the older head spent building px/py, is not in its
row). The packages run in turns (each, then the same in reverse); each turn
prints one JSON line with ms per call and whether the result equals this
checkout's plain version to the bit.

Backward (`--kernels backward` or `all`): the default train recipe's shape
(B=4, C=16, fm 38x38, T=121 of 225) on "uniform", "near_identity" and
"identity" (exact, as a first train step has it) inputs. The packages run
in turns (this checkout, each other package, then the same in reverse), and
each turn prints one JSON line: ms per call of
`ops.resample_grad.resample_correlation_backward`, the ms of one
`aten.grid_sampler_2d_backward` over the same planes in the same turn (the
port calls none of it), and the max error of dcorr, dpx and dpy against
the plain version. Packages:
  - "tree": os2d_torch of this checkout (the table times this one only);
  - DIR's name: DIR/os2d_torch for each --parent DIR (an unpacked checkout
    of another commit, e.g. `git archive` of the parent);
  - --variants: copies of this checkout's os2d_torch with the shared tile
    skeleton (csrc/resample_tile.cuh) or the backward
    (csrc/resample_backward.cu) edited (VARIANTS below), built under
    build/resample_variants/.
The last line is the card's nvidia-smi name and power limit. Needs a card.
"""

import argparse
import importlib
import importlib.util
import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from hopper_bench.counts.flops import (  # noqa: E402
    backward_bytes_ops,
    bound_s,
    hat_bytes_ops,
)
from hopper_bench.counts.coae import roi_align_bytes, touched_cells  # noqa: E402
from hopper_bench.counts.group_norm import slot_bytes  # noqa: E402
from tools.trace_conv_determinism_torch import default_recipe_train_arrays  # noqa: E402

LEVELS = [(30, 40), (38, 50), (48, 64), (60, 80), (72, 96), (84, 112), (96, 128)]  # fm H x W
TILE, BWD, INT8 = "resample_tile.cuh", "resample_backward.cu", "int8_hat_resample.cu"
VARIANTS = {  # name: edits (file in csrc/, old text, new text)
    "rows16": [(TILE, "kTileRows = 8;", "kTileRows = 16;")],
    "rows4": [(TILE, "kTileRows = 8;", "kTileRows = 4;")],
    "chunk16": [(TILE, "kChunk = 8;", "kChunk = 16;")],
    "min_blocks5": [(TILE, "__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 5)")],
    "min_blocks6": [(TILE, "__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 6)")],
    "min_blocks8": [(TILE, "__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 8)")],
    # the backward's scatter kernel: chunks of 2 or 8 template points, and
    # registers capped for 3 resident blocks per SM
    "bwd_chunk2": [(BWD, "kChunk = 4;", "kChunk = 2;")],
    "bwd_chunk8": [(BWD, "kChunk = 4;", "kChunk = 8;")],
    "bwd_blocks3": [(BWD, "__launch_bounds__(os2d::kThreads)\nresample_backward_scatter",
                     "__launch_bounds__(os2d::kThreads, 3)\nresample_backward_scatter")],
    # the backward's transpose with tiles of 64 or 16 anchors
    "bwd_tile64": [(BWD, "kTransposeTile = 32;", "kTransposeTile = 64;")],
    "bwd_tile16": [(BWD, "kTransposeTile = 32;", "kTransposeTile = 16;")],
    # the dcorr kernel: 8 planes a block; loads 2 or 8 chunks ahead; the
    # ballots on every chunk (no run test)
    "bwd_dcorr_warps8": [(BWD, "kDcorrWarps = 4;", "kDcorrWarps = 8;")],
    "bwd_depth2": [(BWD, "kDcorrDepth = 4;", "kDcorrDepth = 2;")],
    "bwd_depth8": [(BWD, "kDcorrDepth = 4;", "kDcorrDepth = 8;")],
    "bwd_no_runs": [(BWD, "bool runs = false;\n  if (tag != nullptr) {",
                     "bool runs = false;\n  if (false) {")],
    # an ablation of the backward, for where its time goes (it drops work,
    # so its results are wrong): no pass for the ties
    "bwd_no_ties": [(BWD, "while (tie_chunks) {", "while (false && tie_chunks) {")],
    # the int8 kernel: chunks of 4 or 16 template points
    "int8_chunk4": [(INT8, "kChunk = 8;", "kChunk = 4;")],
    "int8_chunk16": [(INT8, "kChunk = 8;", "kChunk = 16;")],
}


BACKWARD_SHAPE = (4, 16, 38, 38)  # B, C, fm H, fm W of the default train recipe
SOURCES = {"forward": ["resample.cu", "hat_resample.cu"], "backward": ["resample_backward.cu"],
           "int8": ["int8_hat_resample.cu"]}
IMG_W, IMG_H, BATCH, NUM_CLASSES = 1280, 960, 2, 16  # the benchmark's eval protocol
PYRAMID = [0.5, 0.625, 0.8, 1, 1.2, 1.4, 1.6]
# (name, N, C, H, W) of GroupNorm slots at exp2's V2 training recipe
GN_SLOTS = [("scene_stem", 4, 64, 300, 300), ("scene_layer1_bn3", 4, 256, 150, 150),
            ("scene_layer3_bn3", 4, 1024, 38, 38), ("class_stem", 16, 64, 120, 120),
            ("class_layer3_bn3", 16, 1024, 15, 15)]
GN_GROUPS, GN_EPS = 32, 1e-5
# (name, form, (N, C, H, W)) of frozen BatchNorm slots at the eval
# protocol's 1.6 level (B=2, 2048x1536 scenes); form 0 is relu(bn(x)), 1
# adds the block's input, 2 the downsample's BatchNorm
FBN_SLOTS = [("stem", 0, (2, 64, 1024, 768)), ("layer3_tail", 1, (2, 1024, 96, 128)),
             ("layer3_tail_downsample", 2, (2, 1024, 96, 128))]
# operations per template-point sample of the gather resample: floor x2,
# fractions x2, complements x2, 8 weight products, 4 corner products
# summed, mask multiply-add
GATHER_OPS_PER_SAMPLE = 20
# and of the int8 hat form: floor x2, four hat weights (two subtracts, an
# abs and a max each), two row weights (a multiply and a round each), four
# corner quantizations (a multiply, a round, a min and a max each), four
# integer products and two sums, two conversions and scalings, two column
# products and their sum, the mask product and the accumulate
INT8_OPS_PER_SAMPLE = 49
# and the sample coordinates from theta: the box-local x and y (two
# products and two sums each), then per axis a product and a sum (box),
# two products and a subtract (normalize), a clip (two), a sum and two
# products (to the map)
THETA_OPS_PER_SAMPLE = 28


def bound(bytes_, ops):
    """(ms, "bytes" or "operations"): hopper_bench/counts/flops.py's least
    time for `bytes_` and fp32 `ops`, and the term that sets it."""
    by_bytes, by_ops = bound_s(bytes_, 0), bound_s(0, ops)
    return bound_s(bytes_, ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def gather_bytes_ops(b, c, a, t):
    """The gather resample: the fp32 corr prefix, px and py read, the mask
    read, the scores written; its operations."""
    return 4 * (3 * b * c * t * a + c * t + b * c * a), GATHER_OPS_PER_SAMPLE * b * c * t * a


def int8_bytes_ops(b, c, a, t, side):
    """The int8 kernel from theta: the fp32 corr prefix, theta (6 floats an
    anchor of each (b, c)), the anchors' boxes, the lattice and the mask
    read, the scores written; the int8 hat form's and the coordinates'
    operations."""
    return (4 * (b * c * t * a + 6 * b * c * a + 4 * a + 2 * side + c * t + b * c * a),
            (INT8_OPS_PER_SAMPLE + THETA_OPS_PER_SAMPLE) * b * c * t * a)


def frozen_bn_bytes(form, n, c, h, w):
    """One frozen BatchNorm slot: x read and y written, the identity read
    too in a tail, the parameter vectors (and the downsample's) once; fp32."""
    return 4 * ((2 if form == 0 else 3) * n * c * h * w + (8 if form == 2 else 4) * c)


def bounds(kernel, *shape):
    """(ms, by) of a kernel of the table at a shape: gather, hat and
    backward (B, C, A, T[, T_full]), int8 (B, C, A, T, lattice side),
    frozen_bn_act (form, N, C, H, W); [(ms, by) forward, backward] of
    group_norm (N, C, H, W)."""
    if kernel == "group_norm":
        return [bound(b, 0) for b in slot_bytes(*shape, groups=GN_GROUPS)]
    if kernel == "frozen_bn_act":
        return bound(frozen_bn_bytes(*shape), 0)
    return bound(*{"gather": gather_bytes_ops, "hat": hat_bytes_ops, "int8": int8_bytes_ops,
                   "backward": backward_bytes_ops}[kernel](*shape))


def load_package(root, alias):
    """Import root/os2d_torch under the module name `alias`; returns its
    (ops.resample, ops.hat_resample, ops.cuda, ops.resample_grad,
    ops.int8_resample) modules."""
    pkg = root / "os2d_torch"
    spec = importlib.util.spec_from_file_location(alias, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return tuple(importlib.import_module(f"{alias}.ops.{m}")
                 for m in ("resample", "hat_resample", "cuda", "resample_grad",
                           "int8_resample"))


def variant_root(name):
    root = ROOT / "build" / "resample_variants" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(ROOT / "os2d_torch", root / "os2d_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for source, old, new in VARIANTS[name]:
        path = root / "os2d_torch" / "csrc" / source
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} not in {path}")
        path.write_text(text.replace(old, new))
    return root


def make_inputs(h, w, kind, gen, b=2, c=16, t_side=11):
    """corr [B, C, H, W, 225] (the whole tensor), px/py [B, C, T, H*W] of
    the kind, mask_t [C, T]."""
    import torch

    t = t_side * t_side
    corr = torch.tanh(torch.randn(b, c, h, w, 225, generator=gen, device="cuda"))
    shape = (b, c, t, h * w)
    if kind == "uniform":
        px = torch.rand(shape, generator=gen, device="cuda") * (w - 1)
        py = torch.rand(shape, generator=gen, device="cuda") * (h - 1)
    else:
        ti = torch.arange(t, device="cuda")
        off_x = ((ti // t_side) - t_side // 2).float() * (15 / 14) + 0.5
        off_y = ((ti % t_side) - t_side // 2).float() * (15 / 14) + 0.5
        ys, xs = torch.meshgrid(torch.arange(h, device="cuda"), torch.arange(w, device="cuda"),
                                indexing="ij")

        def jitter():
            if kind == "identity":
                return torch.zeros(shape, device="cuda")
            return (torch.rand(shape, generator=gen, device="cuda") - 0.5) * 0.5

        px = (xs.reshape(-1).float() + off_x[:, None] + jitter()).clamp(0, w - 1)
        py = (ys.reshape(-1).float() + off_y[:, None] + jitter()).clamp(0, h - 1)
    mask_t = torch.full((c, t), 1.0 / t, device="cuda")
    return corr, px.contiguous(), py.contiguous(), mask_t


def random_theta_inputs(b, c, h, w, gen, kind):
    """The int8 kernel's theta source as the interior-first head builds it:
    theta [B, C, H*W, 6], the anchors' feature-map boxes [H*W, 4] and the
    template lattice [2, 11]. kind "identity" (the main path with random
    weights), "near_identity" (each entry moved by up to 0.05) or "random"
    (entries in [-1, 1])."""
    import torch

    from os2d_torch.ops.sampling import linspace
    from os2d_torch.structures.boxes import strided_anchor_grid
    from os2d_torch.structures.feature_map import ALIGNER_RECEPTIVE_FIELD, ALIGNER_STRIDE

    a = h * w
    theta = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0], device="cuda").repeat(b, c, a, 1)
    if kind == "near_identity":
        theta += (torch.rand(b, c, a, 6, generator=gen, device="cuda") - 0.5) * 0.1
    elif kind == "random":
        theta = torch.rand(b, c, a, 6, generator=gen, device="cuda") * 2.0 - 1.0
    boxes = strided_anchor_grid(w, h, float(ALIGNER_RECEPTIVE_FIELD.w),
                                float(ALIGNER_RECEPTIVE_FIELD.h), float(ALIGNER_STRIDE.w),
                                float(ALIGNER_STRIDE.h), device="cuda")
    lattice = torch.stack([linspace(-1.0, 1.0, 15, device="cuda")[2:13]] * 2)
    return theta.contiguous(), boxes, lattice


def bench_int8(packages, gen, levels, iters):
    """The packages' int8 kernel in turns at each level on theta of each
    kind, one line a turn."""
    import torch

    from os2d_torch.ops.geometry import interior_sample_coords
    from os2d_torch.ops.sampling import int8_hat_resample_theta_reference

    order = list(packages) + list(reversed(packages))
    for h, w in levels:
        for kind in ("identity", "near_identity", "random"):
            corr = make_inputs(h, w, "uniform", gen)[0]
            theta, boxes, lattice = random_theta_inputs(2, 16, h, w, gen, kind)
            mask_t = torch.full((16, 121), 1.0 / 121, device="cuda")
            prefix = corr[..., :121]
            px, py = interior_sample_coords(theta, boxes, lattice, h, w)
            want = int8_hat_resample_theta_reference(prefix, theta, boxes, lattice, mask_t)
            for turn, name in enumerate(order):
                mod = packages[name][4]
                if hasattr(mod, "resample_correlation_int8_theta"):
                    def fn():
                        return mod.resample_correlation_int8_theta(prefix, theta, boxes,
                                                                   lattice, mask_t)
                    source = "theta"
                else:
                    def fn():
                        return mod.resample_correlation_int8(prefix, px, py, mask_t)
                    source = "px/py"
                got = fn()
                torch.cuda.synchronize()
                row = {"kernel": "int8", "fm": f"{h}x{w}", "kind": kind, "turn": turn,
                       "package": name, "source": source, "bit_equal": torch.equal(got, want),
                       "ms": cuda_ms(fn, iters)}
                print(json.dumps(row), flush=True)
            del corr, prefix, theta, px, py, want


def cuda_ms(fn, iters):
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


def grid_sample_backward(g, corr, px, py, mask_t):
    """One aten.grid_sampler_2d_backward over the corr planes for the
    cotangent g * mask (bilinear, zeros padding, align_corners): the
    library's call for the same gradient, its inputs laid out beforehand."""
    import torch

    b, c, h, w, _ = corr.shape
    t, a = px.shape[2], h * w
    planes = corr[..., :t].permute(0, 1, 4, 2, 3).reshape(b * c * t, 1, h, w).contiguous()
    grid = torch.stack([px / (w - 1) * 2 - 1, py / (h - 1) * 2 - 1], -1).reshape(
        b * c * t, 1, a, 2)
    grad_out = (g[:, :, None, :] * mask_t[None, :, :, None]).reshape(b * c * t, 1, 1, a)
    return lambda: torch.ops.aten.grid_sampler_2d_backward(grad_out, planes, grid, 0, 0, True,
                                                           [True, True])


def device_ms_by_kernel(fn, calls=10):
    """{kernel or memset name: device ms per call} over `calls` calls of fn
    (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0) or getattr(evt, "self_cuda_time_total", 0)
        if us > 0:
            name = evt.key.split("::")[-1].split("(")[0].strip() or evt.key
            out[name] = out.get(name, 0.0) + us / 1e3 / calls
    return out


def bench_backward(packages, gen, iters, profiled):
    """The packages' backward in turns at BACKWARD_SHAPE, one line a turn;
    with `profiled`, then one line a package with its device time by
    kernel."""
    import torch

    b, c, h, w = BACKWARD_SHAPE
    plain = packages["tree"][3].resample_backward_reference
    order = list(packages) + list(reversed(packages))
    for kind in ("uniform", "near_identity", "identity"):
        corr, px, py, mask_t = make_inputs(h, w, kind, gen, b, c)
        g = torch.randn(b, c, h * w, generator=gen, device="cuda")
        g_sum = g + torch.randn(b, c, h * w, generator=gen, device="cuda")
        inputs = (g, g_sum, corr, px, py, mask_t)
        want = plain(*inputs, px.shape[2])
        library = grid_sample_backward(g, corr, px, py, mask_t)
        for turn, name in enumerate(order):
            fn = packages[name][3].resample_correlation_backward
            got = fn(*inputs)
            torch.cuda.synchronize()
            row = {"kernel": "backward", "shape": list(BACKWARD_SHAPE), "kind": kind,
                   "turn": turn, "package": name,
                   "max_abs_err": {part: float((x - y).abs().max()) for part, x, y in
                                   zip(("dcorr", "dpx", "dpy"), got, want)}}
            del got
            row["ms"] = cuda_ms(lambda: fn(*inputs), iters)
            row["library_ms"] = cuda_ms(library, iters)
            print(json.dumps(row), flush=True)
        for name in packages if profiled else []:
            fn = packages[name][3].resample_correlation_backward
            print(json.dumps({"kernel": "backward", "kind": kind, "package": name,
                              "device_ms_by_kernel": device_ms_by_kernel(lambda: fn(*inputs))}),
                  flush=True)
        del inputs, want, library, corr, px, py, g, g_sum


def _row(name, ms, bound_ms_by, **fields):
    bound_ms, bound_by = bound_ms_by
    row = {"row": name, "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "roofline_pct": 100 * bound_ms / ms, **fields}
    print(json.dumps(row), flush=True)


def _planes_grid(corr, px, py, t):
    """corr's [B*C*T, 1, H, W] planes and the [B*C*T, 1, A, 2] grid of
    px/py for grid_sample (align_corners)."""
    import torch

    b, c, h, w = corr.shape[:4]
    planes = corr[..., :t].permute(0, 1, 4, 2, 3).reshape(b * c * t, 1, h, w).contiguous()
    grid = torch.stack([px / (w - 1) * 2 - 1, py / (h - 1) * 2 - 1], -1).reshape(
        b * c * t, 1, h * w, 2)
    return planes, grid


def table_resample(iters):
    """The gather, hat and int8 rows on the main path's own inputs."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from os2d_torch.config import get_default_cfg
    from os2d_torch.engine.evaluate import Evaluator
    from os2d_torch.models import Os2dConfig, Os2dModel
    from os2d_torch.models import head as head_module
    from os2d_torch.ops import hat_resample, int8_resample, resample, resample_grad
    from os2d_torch.ops.sampling import (
        hat_resample_operand,
        hat_resample_reference,
        int8_hat_resample_theta_reference,
        quantize_int8,
        resample_correlation_from_pxpy_reference,
    )
    from os2d_torch.structures.feature_map import FeatureMapSize

    model = Os2dModel(Os2dConfig(), seed=0)
    cfg = get_default_cfg()
    cfg.tpu.eval_class_chunk = NUM_CLASSES
    ev = Evaluator(model, cfg)
    rng = np.random.RandomState(0)
    head, _ = ev.build_class_heads([rng.randn(240, 240, 3).astype(np.float32)
                                    for _ in range(NUM_CLASSES)])
    sizes = [FeatureMapSize(w=int(IMG_W * s), h=int(IMG_H * s)) for s in PYRAMID]
    inv = [(IMG_W / sz.w, IMG_H / sz.h) for sz in sizes]
    norm = {"mean": model.config.normalization_mean, "std": model.config.normalization_std}
    images = np.random.RandomState(0).randint(0, 255, (BATCH, IMG_H, IMG_W, 3), np.uint8)
    captured, captured_theta = [], []
    original, original_coords = resample_grad.FORWARD["default"], head_module.interior_sample_coords

    def capture(corr, px, py, mask_t):
        captured.append((corr, px, py, mask_t))
        return original(corr, px, py, mask_t)

    def capture_coords(theta, boxes, lattice, h, w):
        captured_theta.append((theta.contiguous(), boxes, lattice))
        return original_coords(theta, boxes, lattice, h, w)

    ev.detect_images(images, head, sizes, inv, norm)  # warm-up
    resample_grad.FORWARD["default"] = capture
    head_module.interior_sample_coords = capture_coords
    try:
        ev.detect_images(images, head, sizes, inv, norm)
    finally:
        resample_grad.FORWARD["default"] = original
        head_module.interior_sample_coords = original_coords
    torch.cuda.synchronize()
    del model, ev, head
    for (corr, px, py, mask_t), (theta, boxes, lattice) in zip(captured, captured_theta):
        print(json.dumps({"row": "main_path_level", "fm": f"{corr.shape[2]}x{corr.shape[3]}",
                          "ms": {
            "gather": cuda_ms(lambda: resample.resample_correlation(corr, px, py, mask_t), iters),
            "hat": cuda_ms(lambda: hat_resample.resample_correlation_hat(corr, px, py, mask_t),
                           iters),
            "int8": cuda_ms(lambda: int8_resample.resample_correlation_int8_theta(
                corr, theta, boxes, lattice, mask_t), iters)}}), flush=True)
    corr, px, py, mask_t = captured[-1]
    theta, boxes, lattice = captured_theta[-1]
    del captured, captured_theta
    b, c, h, w, _ = corr.shape
    t, a = px.shape[2], h * w
    shape = {"B": b, "C": c, "H": h, "W": w, "T": t}
    exact = resample_correlation_from_pxpy_reference(corr, px, py, mask_t)

    # the gather; its library call grid_sample (border) and the masked sum
    planes, grid = _planes_grid(corr, px, py, t)

    def gather_library():
        s = F.grid_sample(planes, grid, mode="bilinear", padding_mode="border",
                          align_corners=True)
        return (s.view(b, c, t, a) * mask_t[None, :, :, None]).sum(2)

    got = resample.resample_correlation(corr, px, py, mask_t)
    _row("gather", cuda_ms(lambda: resample.resample_correlation(corr, px, py, mask_t), iters),
         bounds("gather", b, c, a, t), shape=shape,
         plain_ms=cuda_ms(lambda: resample_correlation_from_pxpy_reference(corr, px, py, mask_t),
                          5),
         library_ms=cuda_ms(gather_library, 5), library="F.grid_sample + masked sum",
         max_abs_err=float((got - exact).abs().max()),
         library_max_abs_err=float((gather_library().view(b, c, h, w) - got).abs().max()))

    # the hat kernel; its library call grid_sample (zeros) over the planes of
    # bf16(corr * mask) held in fp32, then the sum over t
    planes = hat_resample_operand(corr, mask_t).float().view(b * c * t, 1, h, w)

    def hat_library():
        s = F.grid_sample(planes, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
        return s.view(b, c, t, a).sum(2)

    got = hat_resample.resample_correlation_hat(corr, px, py, mask_t)
    _row("hat", cuda_ms(lambda: hat_resample.resample_correlation_hat(corr, px, py, mask_t),
                        iters),
         bounds("hat", b, c, a, t), shape=shape,
         plain_ms=cuda_ms(lambda: hat_resample_reference(corr, px, py, mask_t), 3),
         library_ms=cuda_ms(hat_library, 5),
         library="F.grid_sample over bf16(corr * mask) + sum over t",
         max_abs_err=float((got - hat_resample_reference(corr, px, py, mask_t)).abs().max()),
         vs_exact_gather=float((got - exact).abs().max()),
         library_max_abs_err=float((hat_library().view(b, c, h, w) - got).abs().max()))

    # the int8 kernel from theta; its library call, an approximation (the
    # row weights are not quantized): grid_sample (border) over the planes
    # of round(corr*127)/127 * mask, then the sum over t
    planes = (quantize_int8(corr) / 127.0 * mask_t[None, :, None, None, :]).permute(
        0, 1, 4, 2, 3).reshape(b * c * t, 1, h, w).contiguous()

    def int8_library():
        s = F.grid_sample(planes, grid, mode="bilinear", padding_mode="border",
                          align_corners=True)
        return s.view(b, c, t, a).sum(2)

    args = (corr, theta, boxes, lattice, mask_t)
    got = int8_resample.resample_correlation_int8_theta(*args)
    _row("int8", cuda_ms(lambda: int8_resample.resample_correlation_int8_theta(*args), iters),
         bounds("int8", b, c, a, t, lattice.shape[1]), shape=shape, source="theta",
         plain_ms=cuda_ms(lambda: int8_hat_resample_theta_reference(*args), 3),
         library_ms=cuda_ms(int8_library, 5),
         library="F.grid_sample over round(corr*127)/127 * mask + sum over t (approximate)",
         max_abs_err=float((got - int8_hat_resample_theta_reference(*args)).abs().max()),
         vs_exact_gather=float((got - exact).abs().max()),
         library_max_abs_err=float((int8_library().view(b, c, h, w) - got).abs().max()))


def table_backward(iters):
    """The backward row on the inputs of a first TrainStep on
    default_recipe_train_arrays()."""
    import torch

    from os2d_torch.config import get_default_cfg
    from os2d_torch.engine.objective import ObjectiveConfig
    from os2d_torch.engine.optimization import create_optimizer
    from os2d_torch.engine.train import TrainStep, trainable_parameters
    from os2d_torch.models import Os2dConfig, Os2dModel
    from os2d_torch.ops import resample_grad
    from os2d_torch.ops.sampling import resample_backward_reference

    cfg = get_default_cfg()
    model = Os2dModel(Os2dConfig(), seed=1)
    step = TrainStep(model, ObjectiveConfig(margin_pos=1.0), create_optimizer(
        cfg.train.optim, trainable_parameters(model, cfg.train)), cfg.train)
    captured = []
    original = resample_grad.resample_correlation_backward

    def capture(*args):
        captured.append(tuple(x.detach() for x in args))
        return original(*args)

    resample_grad.resample_correlation_backward = capture
    try:
        step(*default_recipe_train_arrays())
    finally:
        resample_grad.resample_correlation_backward = original
    del model, step
    g, g_sum, corr, px, py, mask_t = inputs = captured[0]
    b, c, h, w, t_full = corr.shape
    t, a = px.shape[2], h * w
    got = resample_grad.resample_correlation_backward(*inputs)
    want = resample_backward_reference(*inputs, t)
    planes, grid = _planes_grid(corr, px, py, t)
    grad_out = (g[:, :, None, :] * mask_t[None, :, :, None]).reshape(b * c * t, 1, 1, a)
    _row("backward", cuda_ms(lambda: resample_grad.resample_correlation_backward(*inputs), iters),
         bounds("backward", b, c, a, t, t_full),
         shape={"B": b, "C": c, "H": h, "W": w, "T": t, "T_full": t_full},
         plain_ms=cuda_ms(lambda: resample_backward_reference(*inputs, t), 3),
         library_ms=cuda_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
             grad_out, planes, grid, 0, 0, True, [True, True]), 5),
         library="aten.grid_sampler_2d_backward (grad of planes and grid)",
         max_abs_err={part: float((x - y).abs().max())
                      for part, x, y in zip(("dcorr", "dpx", "dpy"), got, want)})


def table_group_norm(gen, iters):
    """The GroupNorm rows at GN_SLOTS."""
    import torch
    import torch.nn.functional as F

    from os2d_torch.ops import group_norm as gn

    for name, n, c, h, w in GN_SLOTS:
        x = (torch.randn(n, c, h, w, generator=gen, device="cuda") * 2
             + (torch.rand(1, c, 1, 1, generator=gen, device="cuda") * 2 - 1) * 3).contiguous(
            memory_format=torch.channels_last)
        dy = torch.randn(n, c, h, w, generator=gen, device="cuda").contiguous(
            memory_format=torch.channels_last)
        weight = torch.rand(c, generator=gen, device="cuda") + 0.5
        bias = torch.randn(c, generator=gen, device="cuda") * 0.1
        _, mean, rstd = gn.group_norm_forward(x, GN_GROUPS, weight, bias, GN_EPS)
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, weight, bias)]
        holder = {}

        def aten_forward():
            holder["y"] = F.group_norm(leaves[0], GN_GROUPS, leaves[1], leaves[2], GN_EPS)

        aten_forward()
        forward_bound, backward_bound = bounds("group_norm", n, c, h, w)
        _row("group_norm_forward", cuda_ms(
            lambda: gn.group_norm_forward(x, GN_GROUPS, weight, bias, GN_EPS), iters),
            forward_bound, slot=name, nchw=[n, c, h, w],
            plain_ms=cuda_ms(lambda: gn.group_norm_reference(x, GN_GROUPS, weight, bias, GN_EPS),
                             5),
            library_ms=cuda_ms(aten_forward, iters), library="F.group_norm")
        _row("group_norm_backward", cuda_ms(
            lambda: gn.group_norm_backward(dy, x, GN_GROUPS, weight, mean, rstd), iters),
            backward_bound, slot=name, nchw=[n, c, h, w],
            plain_ms=cuda_ms(lambda: gn.group_norm_backward_reference(
                dy, x, GN_GROUPS, weight, mean, rstd), 5),
            library_ms=cuda_ms(lambda: torch.autograd.grad(holder["y"], leaves, dy,
                                                           retain_graph=True), iters),
            library="F.group_norm's autograd backward")
        del x, dy, leaves, holder, mean, rstd


def table_frozen_bn(gen, iters):
    """The frozen BatchNorm rows at FBN_SLOTS, beside ATen's eager chain (the
    plain version's operations, one launch each)."""
    import torch

    from os2d_torch.ops import frozen_bn as fb

    def norm(c):
        bn = fb.FrozenBatchNorm2d(c, device="cuda")
        with torch.no_grad():
            bn.weight.copy_(torch.rand(c, generator=gen, device="cuda") + 0.5)
            bn.bias.copy_(torch.randn(c, generator=gen, device="cuda") * 0.5)
            bn.running_mean.copy_(torch.randn(c, generator=gen, device="cuda"))
            bn.running_var.copy_(torch.rand(c, generator=gen, device="cuda") * 2 + 0.01)
        return bn

    def operand(shape):
        return torch.randn(shape, generator=gen, device="cuda").contiguous(
            memory_format=torch.channels_last)

    for name, form, shape in FBN_SLOTS:
        args = (operand(shape) * 2, norm(shape[1]), None if form == 0 else operand(shape),
                norm(shape[1]) if form == 2 else None)
        host_us = {}
        with torch.no_grad():
            for label, fn in (("kernel", fb.frozen_bn_act), ("eager", fb.frozen_bn_act_eager)):
                fn(*args)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(50):
                    fn(*args)
                host_us[label] = (time.perf_counter() - t0) / 50 * 1e6
                torch.cuda.synchronize()
            eager_ms = cuda_ms(lambda: fb.frozen_bn_act_eager(*args), iters)
            _row("frozen_bn_act", cuda_ms(lambda: fb.frozen_bn_act(*args), iters),
                 bounds("frozen_bn_act", form, *shape), slot=name, form=form, nchw=list(shape),
                 plain_ms=eager_ms, library_ms=eager_ms,
                 library="ATen's eager chain (the plain version's operations)",
                 host_us_per_call=host_us)
        del args


def table_roi_align(gen, iters, pairs=32, fm=(60, 80), channels=1024, post=300, pool=7):
    """The RoIAlign row at the CoAE cell's shapes, beside its plain version
    on the card."""
    import torch

    from os2d_torch.ops.roi_align import roi_align, roi_align_reference

    h, w = fm[0] * 16, fm[1] * 16
    n = pairs * post
    u = torch.rand(n, 4, generator=gen, device="cuda")
    cx, cy = u[:, 0] * w, u[:, 1] * h
    bw, bh = 64 * torch.exp(u[:, 2] * 2.5), 64 * torch.exp(u[:, 3] * 2.5)
    boxes = torch.stack([(cx - bw / 2).clamp(0, w - 1), (cy - bh / 2).clamp(0, h - 1),
                         (cx + bw / 2).clamp(0, w - 1), (cy + bh / 2).clamp(0, h - 1)], 1)
    index = torch.arange(pairs, device="cuda").repeat_interleave(post).float()
    rois = torch.cat([index[:, None], boxes], 1)
    feats = torch.randn(pairs, *fm, channels, generator=gen, device="cuda")
    per_roi = touched_cells(boxes.tolist(), 1.0 / 16, *fm)
    cells = [sum(per_roi[i * post:(i + 1) * post]) for i in range(pairs)]
    _row("roi_align", cuda_ms(lambda: roi_align(feats, rois, pool), iters),
         bound(roi_align_bytes(pairs, post, *fm, channels, pool, cells), 0),
         shape={"pairs": pairs, "fm": list(fm), "channels": channels, "rois_per_pair": post},
         plain_ms=cuda_ms(lambda: roi_align_reference(feats, rois, pool), 2),
         library_ms=None, library="(none: torchvision is not installed)")
    del feats, rois


def build_line(name, package, sources):
    """Build `sources` of a package (its cuda module), all nvcc processes
    at once; one line with the seconds and ptxas's registers and spills."""
    t0 = time.perf_counter()
    log = package[2].build_all(sources)
    return {"built": name, "sources": sorted(sources), "build_s": time.perf_counter() - t0,
            "ptxas": [ln.strip() for text in log.values() for ln in text.splitlines()
                      if "registers" in ln or "spill" in ln or "Compiling entry" in ln]}


def main(argv):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, nargs="*", default=[],
                    help="unpacked checkouts to time beside this one")
    ap.add_argument("--variants", default="", help=f"comma-separated, of {sorted(VARIANTS)}")
    ap.add_argument("--levels", choices=["largest", "all"], default="largest")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--kernels", choices=["table", "forward", "backward", "int8", "all"],
                    default="table")
    ap.add_argument("--profile", action="store_true",
                    help="the backward's device time by kernel (torch.profiler)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_torch_kernels: needs an NVIDIA card", file=sys.stderr)
        return 1

    roots = {"tree": ROOT}
    for parent in args.parent:
        roots[parent.name] = parent.resolve()
    for name in filter(None, args.variants.split(",")):
        roots[name] = variant_root(name)
    packages = {name: load_package(root, f"resample_bench_{name}")
                for name, root in roots.items()}
    parts = (["table", "forward", "backward", "int8"] if args.kernels == "all"
             else [args.kernels])
    sources = {name: sorted({src for part in parts if part != "table" for src in SOURCES[part]})
               for name in packages}
    if "table" in parts:
        sources["tree"] = packages["tree"][2].all_sources()
    with ThreadPoolExecutor(len(packages)) as pool:
        lines = list(pool.map(lambda name: build_line(name, packages[name], sources[name]),
                              packages))
    for line in lines:
        print(json.dumps(line), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    levels = LEVELS if args.levels == "all" else LEVELS[-1:]
    if "table" in parts:
        table_resample(args.iters)
        table_backward(args.iters)
        table_group_norm(gen, args.iters)
        table_frozen_bn(gen, args.iters)
        table_roi_align(gen, args.iters)
    if "backward" in parts:
        bench_backward(packages, gen, args.iters, args.profile)
    if "int8" in parts:
        bench_int8(packages, gen, levels, args.iters)
    plain_resample, plain_hat = packages["tree"][0], packages["tree"][1]
    plain = {"gather": plain_resample.resample_correlation_from_pxpy_reference,
             "hat": plain_hat.hat_resample_reference}
    for h, w in levels if "forward" in parts else []:
        for kind in ("uniform", "near_identity"):
            corr, px, py, mask_t = make_inputs(h, w, kind, gen)
            inputs = (corr[..., :px.shape[2]], px, py, mask_t)
            del corr
            want = {k: fn(*inputs) for k, fn in plain.items()}
            for name, (resample, hat_resample, *_) in packages.items():
                for kernel, fn in (("gather", resample.resample_correlation),
                                   ("hat", hat_resample.resample_correlation_hat)):
                    row = {"fm": f"{h}x{w}", "kind": kind, "package": name, "kernel": kernel}
                    got = fn(*inputs)
                    torch.cuda.synchronize()
                    row["max_abs_err"] = float((got - want[kernel]).abs().max())
                    row["ms"] = cuda_ms(lambda: fn(*inputs), args.iters)
                    print(json.dumps(row), flush=True)
            del inputs, want
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
