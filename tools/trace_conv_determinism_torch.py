#!/usr/bin/env python3
"""Which convolution gradients of the port's training repeat to the bit on
one NVIDIA card, and what cuDNN's deterministic algorithms cost per layer.

    python3 tools/trace_conv_determinism_torch.py [--parts train,train_bf16,pretrain] [--repeats 3]

Each convolution of one training step is captured as the step runs it (its
input and weight in the compute dtype, stride, padding, bias, and whether
its input needs a gradient): `TrainStep` at the default train recipe's
shapes (`default_recipe_train_arrays`: batch 4 of 600x600, 16 classes of
240 px, `Os2dConfig()`; the backbone on the scenes, the shared backbone on
the class images, the TransformNet on [64, 225, 38, 38]; part "train", and
"train_bf16" at compute_dtype bfloat16) and the ImageNet pretrainer's step
(ResNet101, 224 px, bf16, batch 64; part "pretrain"). Then for each
distinct convolution, with a seeded random output gradient in the output's
layout, `aten.convolution_backward` computes the input gradient (dgrad) and
the weight and bias gradients (wgrad) --repeats times under cuDNN's default
algorithms and under `cudnn.deterministic`: whether each repeats to the
bit, the cuDNN kernels that run (torch.profiler) and the ms of each
(CUDA events); and likewise under the port's rule (models/resnet.py:
conv2d_backward), which the port's training runs. A 1x1 convolution's weight gradient is also taken as one
GEMM over [N*H*W, Cin] and [N*H*W, Cout] (design (b)): its ms, whether it
repeats, and its largest difference from cuDNN's.

One JSON line per layer ("layer"), in the order the step runs them, then a
summary per part ("summary": the layers whose dgrad or wgrad part, and the
sums of each setting's ms), then the card's nvidia-smi name and power limit.
Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

PRETRAIN_ARCH, PRETRAIN_SIZE, PRETRAIN_BATCH, PRETRAIN_CLASSES = "resnet101", 224, 64, 1000
TIMED_ITERS = 5


class ConvRecorder:
    """Records every convolution of the port while active: Conv2d.forward
    (the backbones, the classifier) and transform_net._conv_bias (the
    TransformNet), with the layer's name from `names` (module -> name)."""

    def __init__(self, names):
        self.names, self.calls = names, []

    def _record(self, conv, x, w, bias, stride, padding):
        self.calls.append({"layer": self.names.get(conv, "?"), "branch": None,
                           "x": x.detach(), "w": w.detach(),
                           "bias": None if bias is None else bias.detach(),
                           "stride": stride, "padding": padding,
                           "input_grad": bool(x.requires_grad)})

    def __enter__(self):
        import torch

        from os2d_torch.models import resnet, transform_net

        self._saved = (resnet.Conv2d.forward, transform_net._conv_bias)
        orig_forward, orig_conv_bias = self._saved
        recorder = self

        def forward(conv, x, dtype=torch.float32):
            recorder._record(conv, x.to(dtype), conv.weight.to(dtype), conv.bias, conv.stride,
                             conv.padding)
            return orig_forward(conv, x, dtype)

        def conv_bias(conv, x, dtype, weight=None):
            w = conv.weight if weight is None else weight
            fp32 = dtype == torch.float32
            recorder._record(conv, x if fp32 else x.to(dtype), w if fp32 else w.to(dtype),
                             conv.bias if fp32 else None, 1, conv.padding)
            return orig_conv_bias(conv, x, dtype, weight)

        resnet.Conv2d.forward = forward
        transform_net._conv_bias = conv_bias
        return self

    def __exit__(self, *exc):
        from os2d_torch.models import resnet, transform_net

        resnet.Conv2d.forward, transform_net._conv_bias = self._saved


def default_recipe_train_arrays(device="cuda"):
    """A prepared batch at the default train recipe's shapes: 4 uint8 images
    of 600x600, 16 classes of 240x240, two ground-truth boxes an image near
    the anchors' 240 px (so that some anchors are positives), from a fixed
    generator. Returns (arrays, padded class count)."""
    import torch

    from os2d_torch.engine.decode import default_boxes_for_image_size
    from os2d_torch.structures.feature_map import FeatureMapSize

    b, side, classes = 4, 600, 16
    gen = torch.Generator(device=device).manual_seed(0)

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=gen, device=device, dtype=torch.uint8)

    gt_boxes = torch.zeros((b, 8, 4), device=device)
    gt_boxes[:, 0] = torch.tensor([40.0, 40.0, 280.0, 280.0])
    gt_boxes[:, 1] = torch.tensor([264.0, 248.0, 504.0, 488.0])
    gt_valid = torch.zeros((b, 8), dtype=torch.bool, device=device)
    gt_valid[:, :2] = True
    arrays = {"images": u8(b, side, side, 3), "class_images": u8(classes, 240, 240, 3),
              "class_valid": torch.ones(classes, dtype=torch.bool, device=device),
              "gt_boxes": gt_boxes,
              "gt_labels": torch.tensor([[0, 1] + [-1] * 6] * b, device=device),
              "gt_difficult": torch.zeros((b, 8), dtype=torch.bool, device=device),
              "gt_valid": gt_valid,
              "default_boxes": default_boxes_for_image_size(FeatureMapSize(w=side, h=side),
                                                            device=device)}
    return arrays, classes


def capture_train_step(compute_dtype="float32"):
    """The convolutions of one TrainStep at the default recipe's shapes."""
    import torch

    from os2d_torch.config import get_default_cfg
    from os2d_torch.engine.objective import ObjectiveConfig
    from os2d_torch.engine.optimization import create_optimizer
    from os2d_torch.engine.train import TrainStep, trainable_parameters
    from os2d_torch.models import Os2dConfig, Os2dModel

    arrays, classes = default_recipe_train_arrays()
    cfg = get_default_cfg()
    model = Os2dModel(Os2dConfig(compute_dtype=compute_dtype), seed=1)
    optimizer = create_optimizer(cfg.train.optim, trainable_parameters(model, cfg.train))
    step = TrainStep(model, ObjectiveConfig(margin_pos=1.0), optimizer, cfg.train)
    names = {m: n for n, m in model.named_modules()}
    scene_calls = len([m for m in model.backbone.modules() if m in names and
                       type(m).__name__ == "Conv2d"])
    recorder = ConvRecorder(names)
    with recorder:
        step(arrays, classes)
    torch.cuda.synchronize()
    # the step runs the backbone on the scenes, then on the class images,
    # then the TransformNet
    for i, call in enumerate(recorder.calls):
        call["branch"] = ("transform_net" if call["layer"].startswith("transform_net")
                          else "scenes" if i < scene_calls else "class_images")
    return recorder.calls


def capture_pretrain_step():
    """The convolutions of one pretrainer step (ResNet101, 224 px, bf16)."""
    import torch

    from os2d_torch.pretrain import train_imagenet as pretrain

    model = pretrain.init_classifier(PRETRAIN_ARCH, PRETRAIN_CLASSES, "cuda", seed=0)
    chain = pretrain.ChainSGD(model.parameters(), pretrain.piecewise_constant_schedule(0.1, {}))
    step = pretrain.make_train_step(model, chain)
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randn(PRETRAIN_BATCH, PRETRAIN_SIZE, PRETRAIN_SIZE, 3, generator=gen,
                         device="cuda")
    labels = torch.randint(0, PRETRAIN_CLASSES, (PRETRAIN_BATCH,), generator=gen, device="cuda")
    recorder = ConvRecorder({m: n for n, m in model.named_modules()})
    with recorder:
        step(images, labels)
    torch.cuda.synchronize()
    for call in recorder.calls:
        call["branch"] = "classifier"
    return recorder.calls


def _key(call):
    x, w = call["x"], call["w"]
    return (tuple(x.shape), x.stride(), x.dtype, tuple(w.shape), call["stride"],
            call["padding"], call["bias"] is not None, call["input_grad"])


def _kernel_names(fn):
    """The device kernels of one call of fn (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA})


def _ms(fn):
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(TIMED_ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / TIMED_ITERS


SETTINGS = ("default", "deterministic", "port")


def trace_one(call, repeats, gen, settings=SETTINGS, kernel_names=True):
    """Repeatability, kernels and ms of one convolution's gradients under
    each of `settings`: cuDNN's default algorithms ("default"), cuDNN's
    deterministic ones ("deterministic"), and the port's rule ("port":
    models/resnet.py: conv2d_backward for an fp32 convolution, cuDNN's
    default algorithms for a bf16 one, as models/resnet.py: conv2d takes
    them)."""
    import torch
    import torch.nn.functional as F

    from os2d_torch.models.resnet import conv2d_backward

    x, w, bias = call["x"], call["w"], call["bias"]
    s, p = call["stride"], call["padding"]
    with torch.no_grad():
        out = F.conv2d(x, w, bias, s, p)
    g = torch.randn(out.shape, generator=gen, device=out.device, dtype=out.dtype)
    if not out.is_contiguous() and out.is_contiguous(memory_format=torch.channels_last):
        g = g.contiguous(memory_format=torch.channels_last)
    del out
    bias_sizes = None if bias is None else [bias.shape[0]]

    def backward(setting, mask):
        if setting == "port" and x.dtype == torch.float32:
            return conv2d_backward(g, x, w, bias is not None, s, p, mask)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=setting == "deterministic",
                                        allow_tf32=False):
            return torch.ops.aten.convolution_backward(g, x, w, bias_sizes, [s, s], [p, p],
                                                       [1, 1], False, [0, 0], 1, mask)

    masks = {"wgrad": (False, True, bias is not None)}
    if call["input_grad"]:
        masks["dgrad"] = (True, False, False)
    row = {"repeats": {}, "ms": {}}
    if kernel_names:
        row["kernels"] = {}
    results = {}
    for setting in settings:
        for part, mask in masks.items():
            runs = [[t for t in backward(setting, mask) if t is not None]
                    for _ in range(repeats)]
            torch.cuda.synchronize()
            results[(setting, part)] = runs[0]
            row["repeats"].setdefault(part, {})[setting] = all(
                torch.equal(a, b) for r in runs[1:] for a, b in zip(runs[0], r))
            if kernel_names:
                row["kernels"].setdefault(setting, {})[part] = _kernel_names(
                    lambda: backward(setting, mask))
            row["ms"].setdefault(setting, {})[part] = _ms(lambda: backward(setting, mask))
            del runs
    # each setting's gradients against the default's, as far apart as their
    # sums' orders take them
    row["max_abs_vs_default"] = {
        setting: {part: max(float((a.float() - b.float()).abs().max()) for a, b in
                            zip(results[(setting, part)], results[("default", part)]))
                  for part in masks}
        for setting in settings if setting != "default"}
    if w.shape[2:] == (1, 1) and p == 0 and kernel_names:
        # design (b) alone: the weight gradient of a 1x1 convolution as one GEMM
        xs = x[:, :, ::s, ::s] if s > 1 else x
        cin, cout = w.shape[1], w.shape[0]

        def gemm():
            g2 = g.permute(0, 2, 3, 1).reshape(-1, cout)
            return (g2.t() @ xs.permute(0, 2, 3, 1).reshape(-1, cin)).view(cout, cin, 1, 1)

        first, again = gemm(), gemm()
        row["gemm_wgrad"] = {"ms": _ms(gemm), "repeats": torch.equal(first, again),
                             "max_abs_vs_cudnn": float(
                                 (first.float() - results[("default", "wgrad")][0].float())
                                 .abs().max()),
                             "kernels": _kernel_names(gemm)}
    return row


def _print(line):
    print(line, flush=True)


def trace(part, calls, repeats, settings=SETTINGS, kernel_names=True, emit=_print):
    """Each call's row (`trace_one`, once per distinct convolution) and a
    summary; `emit`, where given, takes each as a JSON string."""
    import torch

    gen = torch.Generator(device=calls[0]["x"].device).manual_seed(0)
    done = {}
    rows = []
    for i, call in enumerate(calls):
        key = _key(call)
        if key not in done:
            done[key] = trace_one(call, repeats, gen, settings, kernel_names)
        row = {"phase": "layer", "part": part, "index": i, "layer": call["layer"],
               "branch": call["branch"], "x": list(call["x"].shape),
               "w": list(call["w"].shape), "stride": call["stride"],
               "padding": call["padding"], "dtype": str(call["x"].dtype).replace("torch.", ""),
               "bias": call["bias"] is not None, "same_as_index": None}
        first = next(j for j, c in enumerate(calls) if _key(c) == key)
        if first != i:
            row["same_as_index"] = first
        row.update(done[key])
        rows.append(row)
        if emit:
            emit(json.dumps(row))

    def failing(setting):
        return {grad: [r["index"] for r in rows
                       if grad in r["repeats"] and not r["repeats"][grad][setting]]
                for grad in ("dgrad", "wgrad")}

    parted = failing("default")
    sums = {s: {grad: sum(r["ms"][s].get(grad, 0.0) for r in rows) for grad in ("dgrad", "wgrad")}
            for s in settings}
    summary = {"phase": "summary", "part": part, "convolutions": len(rows),
               "distinct": len(done), "parted": parted,
               "parted_kinds": sorted({(tuple(rows[i]["w"][2:]), rows[i]["stride"], grad)
                                       for grad, idx in parted.items() for i in idx}),
               "not_repeating": {s: failing(s) for s in settings if s != "default"},
               "ms_sum": sums,
               "ms_minus_default_on_parted": {
                   s: {grad: sum(rows[i]["ms"][s][grad] - rows[i]["ms"]["default"][grad]
                                 for i in idx) for grad, idx in parted.items()}
                   for s in settings if s != "default"}}
    gemm = [r for r in rows if "gemm_wgrad" in r]
    if gemm:
        summary["gemm_wgrad_1x1"] = {
            "layers": len(gemm), "all_repeat": all(r["gemm_wgrad"]["repeats"] for r in gemm),
            "ms_sum": sum(r["gemm_wgrad"]["ms"] for r in gemm),
            "cudnn_default_ms_sum": sum(r["ms"]["default"]["wgrad"] for r in gemm)}
    if emit:
        emit(json.dumps(summary))
    return rows, summary


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", default="train,train_bf16,pretrain")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("trace_conv_determinism_torch: needs an NVIDIA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    for part in args.parts.split(","):
        calls = {"train": capture_train_step,
                 "train_bf16": lambda: capture_train_step("bfloat16"),
                 "pretrain": capture_pretrain_step}[part]()
        trace(part, calls, args.repeats)
        del calls
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "wall", "seconds": time.perf_counter() - t0}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
