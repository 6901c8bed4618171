#!/usr/bin/env python3
"""Time the PyTorch port's two resample kernels on one NVIDIA card.

    python3 tools/bench_torch_resample.py                      # this checkout, largest level
    python3 tools/bench_torch_resample.py --levels all --parent DIR --variants rows16,chunk16

Inputs are those of the bench protocol's levels (B=2, C=16, T=121 of 225
channels, fm from the 1280x960 image at pyramid [0.5 .. 1.6]) of two kinds:
"uniform" px/py spread over the whole map, and "near_identity" px/py at the
anchor plus the template offset of the head's identity transform, jittered
by up to 0.25 px (the main path with random weights has the identity
transform exactly). For each level, kind and kernel package it prints one
JSON line: CUDA-event ms per wrapper call and the max error against the
plain version (ops/sampling.py). Packages:
  - "tree": os2d_torch of this checkout;
  - DIR's name: DIR/os2d_torch for each --parent DIR (an unpacked checkout
    of another commit, e.g. `git archive` of the parent);
  - --variants: copies of this checkout's os2d_torch with the shared tile
    skeleton (csrc/resample_tile.cuh) edited (VARIANTS below: tiles of 16
    or 4 rows, chunks of 16 template points, registers capped for 5, 6 or
    8 resident blocks per SM), built under build/resample_variants/.
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
LEVELS = [(30, 40), (38, 50), (48, 64), (60, 80), (72, 96), (84, 112), (96, 128)]  # fm H x W
VARIANTS = {  # name: edits of csrc/resample_tile.cuh
    "rows16": [("kTileRows = 8;", "kTileRows = 16;")],
    "rows4": [("kTileRows = 8;", "kTileRows = 4;")],
    "chunk16": [("kChunk = 8;", "kChunk = 16;")],
    "min_blocks5": [("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 5)")],
    "min_blocks6": [("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 6)")],
    "min_blocks8": [("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 8)")],
}


def load_package(root, alias):
    """Import root/os2d_torch under the module name `alias`; returns its
    (ops.resample, ops.hat_resample, ops.cuda) modules."""
    pkg = root / "os2d_torch"
    spec = importlib.util.spec_from_file_location(alias, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return tuple(importlib.import_module(f"{alias}.ops.{m}")
                 for m in ("resample", "hat_resample", "cuda"))


def variant_root(name):
    root = ROOT / "build" / "resample_variants" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(ROOT / "os2d_torch", root / "os2d_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    header = root / "os2d_torch" / "csrc" / "resample_tile.cuh"
    text = header.read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} not in {header}")
        text = text.replace(old, new)
    header.write_text(text)
    return root


def make_inputs(h, w, kind, gen, b=2, c=16, t_side=11):
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
            return (torch.rand(shape, generator=gen, device="cuda") - 0.5) * 0.5

        px = (xs.reshape(-1).float() + off_x[:, None] + jitter()).clamp(0, w - 1)
        py = (ys.reshape(-1).float() + off_y[:, None] + jitter()).clamp(0, h - 1)
    mask_t = torch.full((c, t), 1.0 / t, device="cuda")
    return corr[..., :t], px.contiguous(), py.contiguous(), mask_t


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


def main(argv):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, nargs="*", default=[],
                    help="unpacked checkouts to time beside this one")
    ap.add_argument("--variants", default="", help=f"comma-separated, of {sorted(VARIANTS)}")
    ap.add_argument("--levels", choices=["largest", "all"], default="largest")
    ap.add_argument("--iters", type=int, default=20)
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
    with ThreadPoolExecutor(len(packages)) as pool:
        logs = dict(zip(packages, pool.map(
            lambda p: p[2].build_all(["resample.cu", "hat_resample.cu"]), packages.values())))
    for name, log in logs.items():
        print(json.dumps({"built": name, "ptxas": [
            ln.strip() for text in log.values() for ln in text.splitlines()
            if "registers" in ln or "spill" in ln]}), flush=True)

    plain_resample, plain_hat = packages["tree"][0], packages["tree"][1]
    plain = {"gather": plain_resample.resample_correlation_from_pxpy_reference,
             "hat": plain_hat.hat_resample_reference}
    gen = torch.Generator(device="cuda").manual_seed(0)
    levels = LEVELS if args.levels == "all" else LEVELS[-1:]
    for h, w in levels:
        for kind in ("uniform", "near_identity"):
            inputs = make_inputs(h, w, kind, gen)
            want = {k: fn(*inputs) for k, fn in plain.items()}
            for name, (resample, hat_resample, _) in packages.items():
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
