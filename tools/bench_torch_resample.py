#!/usr/bin/env python3
"""Time the PyTorch port's resample kernels and their backward on one NVIDIA card.

    python3 tools/bench_torch_resample.py                      # this checkout, largest level
    python3 tools/bench_torch_resample.py --levels all --parent DIR --variants rows16,chunk16
    python3 tools/bench_torch_resample.py --kernels backward --parent DIR [--profile]
    python3 tools/bench_torch_resample.py --kernels int8 --levels all --parent DIR

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
(`chip_smoke.random_theta_inputs`). A
package whose wrapper takes theta (`resample_correlation_int8_theta`) gets
theta; an older one gets the px/py that this checkout's
`ops.geometry.interior_sample_coords` forms from it (their time, which
the older head spent building px/py, is not in its row). The packages run
in turns (each, then the same in reverse); each turn prints one JSON line
with ms per call and whether the result equals this checkout's plain
version to the bit.

Backward (`--kernels backward` or `all`): the default train recipe's shape
(B=4, C=16, fm 38x38, T=121 of 225) on "uniform", "near_identity" and
"identity" (exact, as a first train step has it) inputs. The packages run
in turns (this checkout, each other package, then the same in reverse), and
each turn prints one JSON line: ms per call of
`ops.resample_grad.resample_correlation_backward`, the ms of one
`aten.grid_sampler_2d_backward` over the same planes in the same turn (the
port calls none of it), and the max error of dcorr, dpx and dpy against
the plain version. Packages:
  - "tree": os2d_torch of this checkout;
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
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


def bench_int8(packages, gen, levels, iters):
    """The packages' int8 kernel in turns at each level on theta of each
    kind, one line a turn."""
    import torch

    from chip_smoke import random_theta_inputs
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


def main(argv):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, nargs="*", default=[],
                    help="unpacked checkouts to time beside this one")
    ap.add_argument("--variants", default="", help=f"comma-separated, of {sorted(VARIANTS)}")
    ap.add_argument("--levels", choices=["largest", "all"], default="largest")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--kernels", choices=["forward", "backward", "int8", "all"], default="all")
    ap.add_argument("--profile", action="store_true",
                    help="the backward's device time by kernel (torch.profiler)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_torch_resample: needs an NVIDIA card", file=sys.stderr)
        return 1

    roots = {"tree": ROOT}
    for parent in args.parent:
        roots[parent.name] = parent.resolve()
    for name in filter(None, args.variants.split(",")):
        roots[name] = variant_root(name)
    packages = {name: load_package(root, f"resample_bench_{name}")
                for name, root in roots.items()}
    parts = ["forward", "backward", "int8"] if args.kernels == "all" else [args.kernels]
    sources = [src for part in parts for src in SOURCES[part]]
    with ThreadPoolExecutor(len(packages)) as pool:
        logs = dict(zip(packages, pool.map(lambda p: p[2].build_all(sources),
                                           packages.values())))
    for name, log in logs.items():
        print(json.dumps({"built": name, "ptxas": [
            ln.strip() for text in log.values() for ln in text.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]}), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    levels = LEVELS if args.levels == "all" else LEVELS[-1:]
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
