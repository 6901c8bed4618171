"""Whether chip_smoke.py's phase `distributed` compares the same numbers from
run to run: the phase (the plain reference steps, a one-rank nccl group and
two gloo ranks sharing cuda:0, then the sharded evals) run --repeats times on
each of --sets sets of DIST_STEPS train batches of chip_smoke.py's planted
training set, on one card.

    python3 tools/repeat_distributed_torch.py [--sets 2] [--repeats 2]

Each run of the phase prints its own JSON line (phase "distributed"); then
one line per run, "run <set> <repeat> <pass or FAIL and why> <seconds>",
and a last JSON line: per set, whether every repeat gave the same loss
errors, weights and reference metrics to the bit.
"""
import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def training_batches(sets):
    """`sets` lists of DIST_STEPS batches, drawn in order from chip_smoke's
    planted training set at its train recipe (loader seed 0)."""
    from os2d_torch.config import get_default_cfg
    from os2d_torch.data.dataloader import build_train_dataloader_from_config
    from os2d_torch.data.dataset import DatasetOneShotDetection
    from os2d_torch.ops.cuda import BUILD_DIR

    cfg = get_default_cfg()
    cfg.train.optim.max_iter = chip_smoke.TRAIN_STEPS
    cfg.eval.iter = chip_smoke.TRAIN_STEPS
    cfg.eval.mAP_iou_thresholds = [0.5]
    cfg.tpu.device_class_cache = "off"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as root:
        df = chip_smoke.write_train_dataset(root)
        train_set = DatasetOneShotDetection(
            df, gt_path=os.path.join(root, "classes", "images"),
            image_path=os.path.join(root, "src"), name="planted-train",
            image_size=chip_smoke.TRAIN_SIZE, eval_scale=chip_smoke.TRAIN_SIZE,
            cache_images=True)
        loader, _ = build_train_dataloader_from_config(cfg, train_set, seed=0)
    n = chip_smoke.DIST_STEPS
    out = []
    for s in range(sets):
        batches = [loader.get_batch(i % len(loader)) for i in range(n * s, n * s + n)]
        out.append([{k: b[k] for k in chip_smoke.DIST_BATCH_KEYS} for b in batches])
    return cfg, out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sets", type=int, default=2)
    parser.add_argument("--repeats", type=int, default=2)
    args = parser.parse_args(argv)

    import torch

    from os2d_torch.ops import hat_resample, int8_resample, resample, resample_grad
    from os2d_torch.ops.cuda import build_all

    if not torch.cuda.is_available():
        raise SystemExit("repeat_distributed_torch: needs an NVIDIA card")
    print(chip_smoke.nvidia_smi_line(), flush=True)
    build_all([m.KERNEL.source for m in (resample, hat_resample, int8_resample, resample_grad)])
    cfg, sets = training_batches(args.sets)

    reports = []
    real_emit = chip_smoke.emit

    def keep(obj):
        if obj.get("phase") == "distributed":
            reports.append(obj)
        real_emit(obj)
    chip_smoke.emit = keep
    summary = []
    for si, batches in enumerate(sets):
        seen, passes = [], 0
        for rep in range(args.repeats):
            before = len(reports)
            t0 = time.perf_counter()
            try:
                chip_smoke.distributed_phase(cfg, batches, lambda *a, **k: None)
                verdict = "pass"
                passes += 1
            except SystemExit as e:
                verdict = f"FAIL {e}"
            print("run", si, rep, verdict, time.perf_counter() - t0, flush=True)
            if len(reports) == before:  # the phase ended before its report
                seen.append(None)
                continue
            r = reports[-1]
            a, b = r["a_nccl_1_rank"], r["b_gloo_2_ranks_on_cuda0"]
            seen.append((r["reference_metrics"], a["loss_max_rel_err"], b["loss_max_rel_err"],
                         a["weights_excess_over_tol"], b["weights_excess_over_tol"]))
        summary.append({"set": si, "passes": passes, "repeats": args.repeats,
                        "repeats_bit_equal": None not in seen and all(x == seen[0] for x in seen),
                        "loss_max_rel_err_a_b": [x and [x[1], x[2]] for x in seen]})
    print(json.dumps({"sets": summary}))


if __name__ == "__main__":
    main()
