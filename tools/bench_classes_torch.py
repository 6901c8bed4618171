"""Large-catalog eval scaling of the port: seconds per image against the
class count at the bench protocol (one 1280x960 image, the 7-level pyramid
[0.5 ... 1.6]), with uniform class chunks and with per-level chunks
(cfg.tpu.eval_class_chunk_per_level) in turns, and the peak device memory of
each. The twin of tools/bench_classes.py.

    python tools/bench_classes_torch.py [C ...]        # default 256 1024, one card

Env (read here only, as the JAX tool's): OS2D_CHUNK (eval_class_chunk,
default 128), OS2D_INT8=1 (the int8 class bank, cfg.tpu.quantize_class_feats),
OS2D_PRESENT=<K> (a mixed bank of K near-duplicate "present" classes and
C-K one-hot "absent" ones, and the class prescreen timed against the full
path at eval.nms_score_threshold 0.45), OS2D_PRE_TOPK (eval_pre_top_k),
OS2D_ROUNDS (timed rounds of each mode, default 3), OS2D_DEVICE (default
cuda). The bank is one random class image's features copied C times with
noise: building C class heads through the backbone is not what this
measures. Prints one JSON line per class count and mode, then
nvidia-smi's name and power limit.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from os2d_torch.config import get_default_cfg  # noqa: E402
from os2d_torch.engine.evaluate import Evaluator  # noqa: E402
from os2d_torch.models.head import ClassHead, quantize_class_head  # noqa: E402
from os2d_torch.structures.feature_map import FeatureMapSize  # noqa: E402

IMG_W, IMG_H = 1280, 960
PYRAMID = [0.5, 0.625, 0.8, 1, 1.2, 1.4, 1.6]
FEATURES = 1024


def protocol(model):
    """(level_sizes, inverse_scales, img_normalization) of the bench protocol."""
    level_sizes = [FeatureMapSize(w=int(IMG_W * s), h=int(IMG_H * s)) for s in PYRAMID]
    inverse_scales = [(IMG_W / sz.w, IMG_H / sz.h) for sz in level_sizes]
    norm = {"mean": model.config.normalization_mean, "std": model.config.normalization_std}
    return level_sizes, inverse_scales, norm


def synthetic_bank(model, num_classes, n_present=0, seed=0):
    """A [C, 15, 15, F] bank from one random class image: C noisy copies, or
    n_present noisy copies and C - n_present one-hot classes (their
    correlation ceilings are low, so the prescreen prunes them)."""
    rng = np.random.RandomState(seed)
    base = model.build_class_head_from_images([rng.randn(240, 240, 3).astype(np.float32)])
    gen = torch.Generator(device=model.device).manual_seed(seed + 1)
    n_noisy = n_present or num_classes
    feats = base.class_feats.repeat(n_noisy, 1, 1, 1)
    feats = feats + 0.01 * torch.randn(feats.shape, generator=gen, device=model.device)
    if n_present:
        absent = torch.zeros((num_classes - n_present,) + tuple(feats.shape[1:]),
                             device=model.device)
        absent[torch.arange(num_classes - n_present), :, :,
               torch.arange(num_classes - n_present) % FEATURES] = 1.0
        feats = torch.cat([feats, absent])
    return ClassHead(feats, base.pool_mask.repeat(num_classes, 1, 1))


def timed_detect(evaluator, image, head, prescreen=False):
    """(seconds, packed) of one synchronized dispatch on one image."""
    level_sizes, inverse_scales, norm = protocol(evaluator.model)
    detect = evaluator.detect_images_prescreened if prescreen else evaluator.detect_images
    if image.is_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    packed = detect(image[None], head, level_sizes, inverse_scales, norm)
    if image.is_cuda:
        torch.cuda.synchronize()
    return time.perf_counter() - t0, packed


def chunk_modes_in_turns(model, cfg, head, image, rounds):
    """Uniform and per-level class chunks in turns (one warmup dispatch
    each, then `rounds` rounds, the order flipped every round) -> {mode:
    {"times": [...], "peak_mib": x}}, and the two modes' last outputs."""
    modes = {}
    for per_level in (False, True):
        mcfg = cfg.clone()
        mcfg.tpu.eval_class_chunk_per_level = per_level
        modes["per_level" if per_level else "uniform"] = Evaluator(model, mcfg)
    stats = {name: {"times": [], "peak_mib": 0.0} for name in modes}
    outs = {}
    order = list(modes)
    for i_round in range(rounds + 1):
        for name in (order if i_round % 2 == 0 else order[::-1]):
            if image.is_cuda:
                torch.cuda.reset_peak_memory_stats()
            seconds, outs[name] = timed_detect(modes[name], image, head)
            if image.is_cuda:
                stats[name]["peak_mib"] = max(stats[name]["peak_mib"],
                                              torch.cuda.max_memory_allocated() / 2 ** 20)
            if i_round:  # round 0 warms up
                stats[name]["times"].append(seconds)
    return stats, outs


def main(argv=None):
    from os2d_torch.models import Os2dConfig, Os2dModel

    argv = sys.argv[1:] if argv is None else argv
    counts = [int(a) for a in argv] or [256, 1024]
    device = os.environ.get("OS2D_DEVICE", "cuda")
    chunk = int(os.environ.get("OS2D_CHUNK", "128"))
    use_int8 = bool(os.environ.get("OS2D_INT8"))
    n_present = int(os.environ.get("OS2D_PRESENT", "0"))
    rounds = int(os.environ.get("OS2D_ROUNDS", "3"))
    cfg = get_default_cfg()
    cfg.tpu.eval_class_chunk = chunk
    if os.environ.get("OS2D_PRE_TOPK"):
        cfg.tpu.eval_pre_top_k = int(os.environ["OS2D_PRE_TOPK"])
    model = Os2dModel(Os2dConfig(), device=device, seed=0)
    rng = np.random.RandomState(0)
    image = torch.as_tensor(rng.randint(0, 255, (IMG_H, IMG_W, 3), np.uint8), device=device)
    for c in counts:
        head = synthetic_bank(model, c, n_present)
        if use_int8:
            head = quantize_class_head(head)
        stats, outs = chunk_modes_in_turns(model, cfg, head, image, rounds)
        for name, st in stats.items():
            print(json.dumps({"classes": c, "chunk": chunk, "mode": name, "int8": use_int8,
                              "s_per_image": float(np.median(st["times"])),
                              "times": st["times"], "peak_mib": st["peak_mib"],
                              "equal_to_uniform": bool(torch.equal(outs[name],
                                                                   outs["uniform"]))}),
                  flush=True)
        if n_present and not use_int8:
            pcfg = cfg.clone()
            pcfg.eval.nms_score_threshold = 0.45
            ev = Evaluator(model, pcfg)
            timed_detect(ev, image, head, prescreen=True)
            times = [timed_detect(ev, image, head, prescreen=True)[0] for _ in range(rounds)]
            print(json.dumps({"classes": c, "chunk": chunk, "mode": "prescreen",
                              "present": n_present, "pruned": ev.prescreen_pruned // (rounds + 1),
                              "s_per_image": float(np.median(times)), "times": times}),
                  flush=True)
        del head
    if device != "cpu":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
