"""Release-checkpoint parity runbook with the PyTorch port (twin of
tools/parity_release.py).

One command between "the released artifacts are available" and "the
north-star accuracy gate passed": given the reference's released checkpoints
(https://github.com/aosokin/os2d, `os2d_v2-train.pth` etc.) and the GroZi-3.2k
data root, run the full published eval protocol (1280px, 7-scale pyramid
[0.5..1.6], NMS IoU 0.3, VOC mAP@0.5 — BASELINE.md) with `os2d_torch` and
assert the published numbers:

  row                    expected mAP@0.5 (grozi-val-new-cl)
  v2-train               90.65
  v1-train               88.71   (ResNet101, simplified affine)
  v2-init                86.07
  v2-train-single-scale  85.58   (pyramid [1.0])

Usage (all rows; checkpoints resolved by their release filenames):
  python tools/parity_release_torch.py --models-dir /path/to/models \\
      --data-path /path/to/data            # data/grozi/... as in the reference

  python tools/parity_release_torch.py --row v2-train \\
      --checkpoint /path/os2d_v2-train.pth --data-path /path/to/data

Options: --tol 0.3 (mAP tolerance), --rows a,b,c (subset), --device cpu (the
kernels' plain versions; the card by default), --mesh N (eval sharded over N
ranks, -1 all of them, as cfg.tpu.eval_shard_axis says; only in a process
that torchrun started, e.g. `torchrun --nproc_per_node=N
tools/parity_release_torch.py --mesh N ...`; it raises otherwise rather than
run on one card). The model is built from the config as
`python -m os2d_torch.main` builds it (`os2d_torch.main.
build_model_from_config`) and loaded through the checkpoint cascade
(`os2d_torch.models.checkpoint.load_checkpoint_file`), which reads the
reference's `.pth`, the port's `.pth` and the JAX package's `.pkl`.

Prints one machine-readable JSON line per row plus an overall verdict line
{"parity_gate": "PASS"|"FAIL", ...} (rank 0 alone under torchrun); exit
code 0 iff every requested row passed.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

ROWS = {
    # row -> (release filename, expected mAP@0.5, model overrides, eval overrides)
    "v2-train": ("os2d_v2-train.pth", 90.65, {}, {}),
    "v1-train": (
        "os2d_v1-train.pth", 88.71,
        {"backbone_arch": "resnet101", "use_simplified_affine_model": True,
         "use_inverse_geom_model": False},
        {},
    ),
    "v2-init": ("os2d_v2-init.pth", 86.07, {}, {}),
    "v2-train-single-scale": (
        "os2d_v2-train.pth", 85.58, {},
        {"scales_of_image_pyramid": [1.0]},
    ),
}
DATASET = "grozi-val-new-cl"
SCALE = 1280


def make_eval_mesh(mesh_axis, device):
    """(mesh, whether this rank has work). No mesh for --mesh 0 or 1; else
    the mesh of `mesh_axis` ranks (-1 every rank) of the process group that
    torchrun started, which this joins; a rank outside it has no work.
    Raises in a process that torchrun did not start, and where the job has
    fewer ranks than asked for."""
    if mesh_axis in (0, 1):
        return None, True
    from os2d_torch.parallel import init_distributed, make_mesh
    from os2d_torch.parallel.mesh import launched_world_size

    world = launched_world_size()
    if "RANK" not in os.environ or world < 2:
        raise SystemExit(f"--mesh {mesh_axis} shards the eval over the ranks of a torchrun "
                         f"job; start this script with torchrun --nproc_per_node=N")
    want = world if mesh_axis < 0 else mesh_axis
    if want > world:
        raise SystemExit(f"--mesh {mesh_axis} asks for {want} ranks; torchrun started {world}")
    mesh = make_mesh(want, init_distributed(device=None if device == "cuda" else device))
    return mesh, mesh is not None


def run_row(row, checkpoint, data_path, tol, mesh, device):
    from os2d_torch.config import get_default_cfg
    from os2d_torch.data.dataloader import build_eval_dataloaders_from_cfg
    from os2d_torch.engine.train import evaluate_model
    from os2d_torch.main import build_model_from_config
    from os2d_torch.parallel import primary_host
    from os2d_torch.utils.logger import setup_logger

    _, expected, model_over, eval_over = ROWS[row]
    cfg = get_default_cfg()
    cfg.eval.dataset_names = [DATASET]
    cfg.eval.dataset_scales = [SCALE]
    cfg.eval.mAP_iou_thresholds = [0.5]
    cfg.eval.class_image_augmentation = ""
    for k, v in eval_over.items():
        setattr(cfg.eval, k, v)
    for k, v in model_over.items():
        setattr(cfg.model, k, v)
    cfg.init.model = checkpoint

    model, _ = build_model_from_config(cfg, setup_logger("OS2D"),
                                       mesh.device if mesh is not None else device)
    img_normalization = {"mean": cfg.model.normalization_mean,
                         "std": cfg.model.normalization_std}
    loaders = build_eval_dataloaders_from_cfg(cfg, img_normalization, data_path=data_path)
    meters = evaluate_model(loaders, model, cfg, mesh=mesh)
    measured = float(meters[DATASET]["mAP@0.50"]) * 100.0
    ok = abs(measured - expected) <= tol
    if primary_host():
        print(json.dumps({
            "row": row, "checkpoint": checkpoint, "dataset": DATASET,
            "scale": SCALE,
            "pyramid": list(cfg.eval.scales_of_image_pyramid),
            "mAP@0.50": round(measured, 3), "expected": expected,
            "tol": tol, "pass": ok,
        }), flush=True)
    return ok, measured


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--models-dir", default="",
                    help="directory holding the released .pth checkpoints")
    ap.add_argument("--checkpoint", default="",
                    help="explicit checkpoint path (single --row mode)")
    ap.add_argument("--data-path", required=True,
                    help="data root containing grozi/ (reference layout)")
    ap.add_argument("--row", default="", help="single row to run")
    ap.add_argument("--rows", default=",".join(ROWS),
                    help="comma-separated rows (default: all)")
    ap.add_argument("--tol", type=float, default=0.3,
                    help="mAP tolerance in points (default 0.3)")
    ap.add_argument("--mesh", type=int, default=1,
                    help="ranks of a torchrun job to shard the eval over (-1 = all, 1 = none)")
    ap.add_argument("--device", default="cuda",
                    help="the model's device without a mesh (default: the card)")
    args = ap.parse_args(argv)

    rows = [args.row] if args.row else [
        r for r in args.rows.split(",") if r.strip()
    ]
    for r in rows:
        if r not in ROWS:
            ap.error(f"unknown row {r!r}; choose from {sorted(ROWS)}")
    if args.row and args.checkpoint:
        paths = {args.row: args.checkpoint}
    else:
        if not args.models_dir:
            ap.error("--models-dir is required unless --row + --checkpoint")
        paths = {r: os.path.join(args.models_dir, ROWS[r][0]) for r in rows}
    missing = [p for p in paths.values() if not os.path.isfile(p)]
    if missing:
        ap.error(f"checkpoint(s) not found: {missing}")

    import torch.distributed as dist

    from os2d_torch.parallel import primary_host

    mesh, has_work = make_eval_mesh(args.mesh, args.device)
    printer = primary_host()
    try:
        results = {}
        all_ok = True
        for r in rows if has_work else []:
            ok, measured = run_row(r, paths[r], args.data_path, args.tol, mesh, args.device)
            results[r] = {"mAP@0.50": round(measured, 3),
                          "expected": ROWS[r][1], "pass": ok}
            all_ok = all_ok and ok
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if printer:
        print(json.dumps({
            "parity_gate": "PASS" if all_ok else "FAIL",
            "tol": args.tol, "rows": results,
        }), flush=True)
    sys.exit(0 if all_ok else 1)


if __name__ == "__main__":
    main()
