"""Run-to-run repeatability of the port's mAP gate (tools/map_sensitivity_torch.py)
on one card: which step of the gate drifts between two runs of one tree at
one seed, and by how much.

    python3 tools/gate_repeatability_torch.py [--steps 200] [--trainings 3]
        [--lockstep-steps 20] [--gate-runs 3]

Parts, each printing one JSON line:
  train_processes  the gate's training (`map_sensitivity_torch.train`, seed
                   0) in --trainings processes: a sha256 of each trained
                   state_dict, all equal or not, and the largest weight
                   difference from the first.
  state_dmap       each of those states evaluated at fp32_high (the gate's
                   reference) and at bf16_fold_default, as the gate does:
                   both mAPs and the dmAP of each state, the dmAPs' spread
                   over the states, beside the weights' drift.
  lockstep         two models from seed 0 stepped on the same prepared
                   batches in one process, with cuDNN's default algorithm
                   choice and then with cudnn.deterministic (and benchmark
                   off): after every step the loss terms' and the weights'
                   largest difference, and the first step that differs.
  backward         the resample's backward kernel (csrc/resample_backward.cu)
                   twice on the same inputs at the gate's shape (B=4, C=8,
                   30x30, uniform and near-identity px/py): whether dcorr,
                   dpx and dpy repeat to the bit, and dcorr's largest
                   difference.
  conv_backward    one backbone convolution's weight gradient twice, with
                   cuDNN's default algorithms and with deterministic ones.
  eval_processes   the bf16+fold eval (bf16_fold_default) of one trained
                   state in two processes: equal detections or not.
  gate_processes   the whole gate (tools/map_sensitivity_torch.py, train
                   and the seven configs) in --gate-runs processes: each
                   run's dmAP per config, and each config's spread.
Then nvidia-smi's name and power limit. Everything is written under
build/gate_repeatability/ (gitignored).
"""

import argparse
import hashlib
import json
import os
import pickle
import subprocess
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tools import map_sensitivity_torch as gate  # noqa: E402

OUT = os.path.join(ROOT, "build", "gate_repeatability")


def emit(obj):
    print(json.dumps(obj), flush=True)


def state_hash(state):
    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode())
        h.update(state[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def max_state_diff(a, b):
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def dataset(root):
    from os2d_torch.data.dataset import DatasetOneShotDetection

    df = gate.make_dataset(root, np.random.RandomState(0))
    return DatasetOneShotDetection(df, gt_path=os.path.join(root, "classes", "images"),
                                   image_path=os.path.join(root, "src"), name="sens",
                                   image_size=gate.IMG_W, eval_scale=gate.IMG_W,
                                   cache_images=True)


def gate_args(steps, root, device="cuda"):
    return argparse.Namespace(train_steps=steps, device=device, batch_size=4, train_patch=480,
                              root=root, scales=3)


def child_train(steps, out_path):
    """The gate's training in this process; its state_dict saved to out_path."""
    from os2d_torch.utils.logger import setup_logger

    state = gate.train(dataset(os.path.join(OUT, "data")), gate_args(steps, OUT),
                       setup_logger("OS2D.repeat", None))
    torch.save({k: v.cpu() for k, v in state.items()}, out_path)


def child_eval(state_path, out_dir):
    """bf16_fold_default's eval of a saved state in this process."""
    # this process evaluates the one config
    gate.CONFIGS = {"bf16_fold_default": gate.CONFIGS["bf16_fold_default"]}
    state = torch.load(state_path, map_location="cuda", weights_only=True)
    gate.evaluate_configs(dataset(os.path.join(OUT, "data")), state, gate_args(0, out_dir))


def state_dmap(data, states):
    """fp32_high and bf16_fold_default of each state -> the state_dmap part."""
    names = ("fp32_high", "bf16_fold_default")
    saved = gate.CONFIGS
    gate.CONFIGS = {k: saved[k] for k in names}
    try:
        per_state = []
        for i, state in enumerate(states):
            results, _ = gate.evaluate_configs(
                data, {k: v.cuda() for k, v in state.items()},
                gate_args(0, os.path.join(OUT, f"dmap{i}")))
            maps = {k: results[k]["mAP@0.50"] for k in names}
            per_state.append({**maps, "dmAP": maps["bf16_fold_default"] - maps["fp32_high"]})
    finally:
        gate.CONFIGS = saved
    dmaps = [r["dmAP"] for r in per_state]
    return {"states": per_state, "dmAP_min": min(dmaps), "dmAP_max": max(dmaps),
            "dmAP_spread": max(dmaps) - min(dmaps),
            "fp32_high_spread": (max(r["fp32_high"] for r in per_state)
                                 - min(r["fp32_high"] for r in per_state)),
            "weights_max_diff_from_first": [max_state_diff(states[0], s) for s in states]}


def gate_processes(runs, steps):
    """tools/map_sensitivity_torch.py in `runs` processes -> dmAP per config
    and run, and each config's spread over the runs."""
    script = os.path.join(ROOT, "tools", "map_sensitivity_torch.py")
    rows = []
    for i in range(runs):
        out = subprocess.run([sys.executable, script, "--train-steps", str(steps), "--root",
                              os.path.join(OUT, f"gate{i}")], check=True, timeout=900,
                             cwd=ROOT, capture_output=True, text=True).stdout
        last = json.loads(out.strip().splitlines()[-1])
        rows.append({"fp32_high": last["fp32_high"]["mAP@0.50"],
                     **{k: v["dmAP"] for k, v in last.items() if isinstance(v, dict)
                        and "dmAP" in v}})
    spread = {k: max(r[k] for r in rows) - min(r[k] for r in rows) for k in rows[0]}
    return {"runs": rows, "spread": spread}


def run_child(*argv):
    subprocess.run([sys.executable, os.path.abspath(__file__), *argv], check=True,
                   timeout=900, cwd=ROOT)


def lockstep(data, steps, deterministic):
    from os2d_torch.config import get_default_cfg
    from os2d_torch.data.dataloader import build_train_dataloader_from_config
    from os2d_torch.engine.objective import ObjectiveConfig
    from os2d_torch.engine.optimization import create_optimizer
    from os2d_torch.engine.train import TrainStep, prepare_batch_arrays, trainable_parameters
    from os2d_torch.models import Os2dConfig, Os2dModel

    torch.backends.cudnn.deterministic = deterministic
    torch.backends.cudnn.benchmark = False
    cfg = get_default_cfg()
    cfg.train.batch_size = 4
    cfg.train.class_batch_size = gate.NUM_CLASSES
    cfg.train.augment.train_patch_width = cfg.train.augment.train_patch_height = 480
    cfg.train.optim.lr = 1e-4
    loader, _ = build_train_dataloader_from_config(cfg, data, seed=0)
    runs = []
    for _ in range(2):
        model = Os2dModel(Os2dConfig(), seed=0)
        optimizer = create_optimizer(cfg.train.optim, trainable_parameters(model, cfg.train))
        runs.append((model, TrainStep(model, ObjectiveConfig(), optimizer, cfg.train)))
    per_step, first = [], None
    for i in range(steps):
        arrays, c_pad = prepare_batch_arrays(loader.get_batch(i % len(loader)), "cuda")
        meters = [step(arrays, c_pad) for _, step in runs]
        w = max_state_diff(runs[0][0].state_dict(), runs[1][0].state_dict())
        loss = max(abs(meters[0][k] - meters[1][k]) for k in meters[0])
        per_step.append({"step": i, "weights_max_diff": w, "loss_terms_max_diff": loss})
        if first is None and (w > 0 or loss > 0):
            first = i
    torch.backends.cudnn.deterministic = False
    return {"deterministic": deterministic, "steps": steps, "first_differing_step": first,
            "per_step": per_step}


def backward_repeat():
    from os2d_torch.ops.resample_grad import resample_correlation_backward

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, c, h, w, t = 4, 8, 30, 30, 121
    corr = torch.rand((b, c, h, w, 225), generator=gen, device="cuda") * 2 - 1
    px = (torch.rand((b, c, t, h * w), generator=gen, device="cuda") * (w - 1)).contiguous()
    py = (torch.rand((b, c, t, h * w), generator=gen, device="cuda") * (h - 1)).contiguous()
    # near-identity px/py: neighbouring anchors share corr cells, so the
    # atomic adds into one cell come from many threads
    grid_x = torch.arange(w, device="cuda").repeat(h).float()
    grid_y = torch.arange(h, device="cuda").repeat_interleave(w).float()
    px_id = (grid_x + 0.3 * torch.rand((b, c, t, h * w), generator=gen, device="cuda")).clamp(
        0, w - 1)
    py_id = (grid_y + 0.3 * torch.rand((b, c, t, h * w), generator=gen, device="cuda")).clamp(
        0, h - 1)
    mask_t = torch.rand((c, t), generator=gen, device="cuda")
    g = torch.randn((b, c, h * w), generator=gen, device="cuda")
    out = {}
    for name, (x, y) in (("uniform", (px, py)), ("near_identity", (px_id, py_id))):
        r1 = resample_correlation_backward(g, g, corr, x.contiguous(), y.contiguous(), mask_t)
        r2 = resample_correlation_backward(g, g, corr, x.contiguous(), y.contiguous(), mask_t)
        torch.cuda.synchronize()
        out[name] = {
            "dcorr_bit_equal": bool(torch.equal(r1[0], r2[0])),
            "dcorr_differing": int((r1[0] != r2[0]).sum()),
            "dcorr_max_diff": float((r1[0] - r2[0]).abs().max()),
            "dcorr_max_abs": float(r1[0].abs().max()),
            "dpx_bit_equal": bool(torch.equal(r1[1], r2[1])),
            "dpy_bit_equal": bool(torch.equal(r1[2], r2[2]))}
    return out


def conv_backward_repeat():
    """layer3's first 3x3 convolution's weight gradient at the gate's
    feature-map size (4 x 30 x 30)."""
    from os2d_torch.models import Os2dConfig, Os2dModel

    model = Os2dModel(Os2dConfig(), seed=0)
    conv = model.backbone.layer3[0].conv2
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((4, 30, 30, conv.weight.shape[1]), generator=gen, device="cuda")
    out = {}
    for deterministic in (False, True):
        torch.backends.cudnn.deterministic = deterministic
        grads = []
        for _ in range(2):
            w = conv.weight.detach().clone().requires_grad_()
            y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, padding=1, stride=1)
            (gw,) = torch.autograd.grad((y * y).sum(), [w])
            grads.append(gw)
        torch.cuda.synchronize()
        out["deterministic" if deterministic else "default"] = {
            "bit_equal": bool(torch.equal(grads[0], grads[1])),
            "max_diff": float((grads[0] - grads[1]).abs().max())}
    torch.backends.cudnn.deterministic = False
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200, help="the gate's train steps")
    ap.add_argument("--trainings", type=int, default=3, help="training processes")
    ap.add_argument("--lockstep-steps", type=int, default=20)
    ap.add_argument("--gate-runs", type=int, default=3, help="whole gate processes")
    ap.add_argument("--child-train", nargs=2, metavar=("STEPS", "OUT"), help=argparse.SUPPRESS)
    ap.add_argument("--child-eval", nargs=2, metavar=("STATE", "OUT"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child_train:
        return child_train(int(args.child_train[0]), args.child_train[1])
    if args.child_eval:
        return child_eval(*args.child_eval)
    if not torch.cuda.is_available():
        print("gate_repeatability_torch: needs an NVIDIA card", file=sys.stderr)
        return 1
    os.makedirs(OUT, exist_ok=True)
    t0 = time.time()
    data = dataset(os.path.join(OUT, "data"))

    states = []
    for i in range(args.trainings):
        path = os.path.join(OUT, f"state{i}.pth")
        run_child("--child-train", str(args.steps), path)
        states.append(torch.load(path, weights_only=True))
    hashes = [state_hash(s) for s in states]
    emit({"part": "train_processes", "steps": args.steps, "sha256": hashes,
          "equal": len(set(hashes)) == 1,
          "weights_max_diff": max((max_state_diff(states[0], s) for s in states[1:]),
                                  default=0.0)})
    emit({"part": "state_dmap", **state_dmap(data, states)})

    for deterministic in (False, True):
        emit({"part": "lockstep", **lockstep(data, args.lockstep_steps, deterministic)})
    emit({"part": "backward", **backward_repeat()})
    emit({"part": "conv_backward", **conv_backward_repeat()})

    dets = []
    for i in range(2):
        out_dir = os.path.join(OUT, f"eval{i}")
        run_child("--child-eval", os.path.join(OUT, "state0.pth"), out_dir)
        with open(os.path.join(out_dir, "dets_bf16_fold_default", "sens_detections.pkl"),
                  "rb") as f:
            dets.append(pickle.load(f))
    same = all(np.array_equal(a, b) for key in ("boxes_xyxy", "scores", "labels")
               for a, b in zip(dets[0][key], dets[1][key]))
    emit({"part": "eval_processes", "config": "bf16_fold_default", "equal": same,
          "scores_max_diff": max(float(np.abs(a - b).max()) if a.shape == b.shape and a.size
                                 else (0.0 if a.shape == b.shape else float("inf"))
                                 for a, b in zip(dets[0]["scores"], dets[1]["scores"]))})
    emit({"part": "gate_processes", **gate_processes(args.gate_runs, args.steps)})
    emit({"part": "done", "seconds": time.time() - t0})
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
