"""ImageNet classification pretraining of the OS2D backbone: the twin of
`os2d_tpu/pretrain/train_imagenet.py` (the reference's
data/ImageNet-RepMet/pretrain/train_imagenet.py, which pretrained ResNet101
with RepMet's episode test classes left out).

The recipe is JAX's: RandomResizedCrop(224) and a horizontal flip, SGD with
momentum 0.9 and weight decay 1e-4, lr 0.1 divided by 10 at epochs 30 and
60, 90 epochs, top-1 and top-5 accuracy. The step runs the convolutions in
bf16 and BatchNorm and the log-softmax in fp32 (`make_train_step`); the
optimizer is optax's chain over every parameter (`ChainSGD`). `train` is data
parallel over os2d_torch/parallel: every rank draws the same global batch,
runs its own rows, takes BatchNorm's statistics over the global batch and
averages the gradients, as JAX's step over a sharded batch computes them.
The trained classifier exports in torchvision's names
(`export_torchvision_state_dict`, backbone_torchvision.pkl), which
`models.checkpoint.load_checkpoint_file` loads into the detector's backbone.

    python -m os2d_torch.pretrain.train_imagenet DATA/train \\
        --repmet-exclude repmet_test_classes.txt [--arch resnet101] [--device cuda]
    torchrun --nproc_per_node=N -m os2d_torch.pretrain.train_imagenet DATA/train ...
"""

from __future__ import annotations

import argparse
import math
import os
import pickle
import random
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from PIL import Image

from ..models.resnet import FrozenBatchNorm2d, ResNetClassifier
from ..parallel.mesh import (
    all_reduce_sum_,
    init_distributed,
    launched_world_size,
    local_rows,
    make_mesh,
    primary_host,
)
from ..utils.logger import setup_logger
from ..utils.upload import uploader_for

IMG_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMG_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


# ---------------------------------------------------------------------------
# data: ImageFolder-style host loader with RepMet class exclusion
# (os2d_tpu/pretrain/train_imagenet.py:43-119, the same PIL and numpy code)
# ---------------------------------------------------------------------------

class ImageFolderDataset:
    """train/<class_dir>/*.JPEG layout; classes sorted; exclusions applied."""

    def __init__(self, root, classes_to_exclude=(), extensions=(".jpeg", ".jpg", ".png")):
        self.root = root
        class_dirs = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)) and d not in classes_to_exclude
        )
        self.class_to_idx = {c: i for i, c in enumerate(class_dirs)}
        self.samples = []
        for c in class_dirs:
            for fname in sorted(os.listdir(os.path.join(root, c))):
                if fname.lower().endswith(extensions):
                    self.samples.append((os.path.join(root, c, fname), self.class_to_idx[c]))

    def __len__(self):
        return len(self.samples)

    @property
    def num_classes(self):
        return len(self.class_to_idx)


def random_resized_crop(img, size=224, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3), rng=random):
    """torchvision RandomResizedCrop semantics. The draws come from `rng`
    (the module-level `random` by default, as JAX's do), in JAX's order."""
    w, h = img.size
    area = w * h
    for _ in range(10):
        target_area = rng.uniform(*scale) * area
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        ar = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * ar)))
        ch = int(round(math.sqrt(target_area / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            x = rng.randint(0, w - cw)
            y = rng.randint(0, h - ch)
            img = img.crop((x, y, x + cw, y + ch))
            return img.resize((size, size), Image.BILINEAR)
    # fallback: center crop
    s = min(w, h)
    img = img.crop(((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2))
    return img.resize((size, size), Image.BILINEAR)


def load_train_image(path, size=224, rng=random):
    """A normalized [size, size, 3] float32 crop of the image at `path`,
    flipped with probability 0.5 (the flip's draw from `rng` too)."""
    with open(path, "rb") as f:
        img = Image.open(f)
        if img.mode != "RGB":
            img = img.convert("RGB")
        img.load()
    img = random_resized_crop(img, size, rng=rng)
    if rng.random() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - IMG_MEAN) / IMG_STD


def batch_iterator(dataset, batch_size, size=224, seed=0, rng=random):
    """Endless (images [B, size, size, 3] float32, labels [B] int32) batches:
    the order reshuffled each epoch by random.Random(seed), the crops and
    flips drawn from `rng`; a partial last batch of an epoch is dropped."""
    order_rng = random.Random(seed)
    order = list(range(len(dataset)))
    while True:
        order_rng.shuffle(order)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            idxs = order[start: start + batch_size]
            images = np.stack([load_train_image(dataset.samples[i][0], size, rng) for i in idxs])
            labels = np.asarray([dataset.samples[i][1] for i in idxs], np.int32)
            yield images, labels


# ---------------------------------------------------------------------------
# model, optimizer, train step
# ---------------------------------------------------------------------------

def init_classifier(arch="resnet101", num_classes=1000, device=None, seed=0):
    """A `ResNetClassifier` initialized from `seed` (init_resnet_classifier_
    params' distributions) on `device` (the card by default). TF32 is off,
    so that fp32 convolutions and matmuls are fp32, as on the JAX side."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the pretrainer targets CUDA by default and no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = ResNetClassifier(arch, num_classes, device)
    model.reset_parameters(torch.Generator(device=device).manual_seed(seed))
    return model


def piecewise_constant_schedule(init_value, boundaries_and_scales):
    """optax.piecewise_constant_schedule as an fp32 number per step count:
    init_value times every scale whose boundary the count has reached,
    multiplied in fp32 in the boundaries' order, as optax rounds it."""
    def schedule(count):
        v = np.float32(init_value)
        for threshold, scale in sorted(boundaries_and_scales.items()):
            if count >= threshold:
                v = np.float32(scale) * v
        return v

    return schedule


class ChainSGD:
    """The JAX pretrainer's optimizer, optax.chain(add_decayed_weights(wd),
    trace(momentum), scale_by_schedule(-schedule)) (os2d_tpu/pretrain/
    train_imagenet.py:208-213): per tensor p with gradient g,
        t = (g + wd * p) + momentum * t;   p = base + (-lr(count)) * t
    with the trace starting at zero and the count at 0.

    Like the JAX chain it runs over every parameter, BatchNorm's running
    mean and var included: their gradient is zero (the train-mode forward
    does not read them), but weight decay and momentum still move them, and
    their update is added to the statistics after the step's running-average
    update, `base` (os2d_tpu/pretrain/train_imagenet.py:143-148 applies the
    updates to the forward's new params). The same quirk as the detector's
    TrainStep (ROADMAP Queue 3), copied on purpose so that the two packages
    train the same weights."""

    def __init__(self, params, schedule, momentum=0.9, weight_decay=1e-4):
        self.params = list(params)
        self.schedule = schedule
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.trace = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, base=None):
        """One update from the parameters' .grad (None counts as zero).
        `base` maps id(parameter) to the tensor its update is added to in
        place of the parameter itself."""
        base = base or {}
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        decayed = torch._foreach_mul(self.params, self.weight_decay)
        torch._foreach_add_(decayed, grads)
        torch._foreach_mul_(self.trace, self.momentum)
        torch._foreach_add_(self.trace, decayed)
        updates = torch._foreach_mul(self.trace, float(-self.schedule(self.count)))
        self.count += 1
        for p, u in zip(self.params, updates):
            if id(p) in base:
                p.copy_(base[id(p)] + u)
            else:
                p.add_(u)


def make_train_step(model, optimizer, compute_dtype=torch.bfloat16, mesh=None):
    """step(images [B, H, W, 3] normalized float, labels [B] int) -> {"loss",
    "top1", "top5"} (0-dim tensors) of the global batch, after one update of
    `model` by `optimizer` (a ChainSGD over model.parameters())
    (os2d_tpu/pretrain/train_imagenet.py:125-149). The convolutions run in
    `compute_dtype`, BatchNorm in train mode and the log-softmax in fp32;
    the loss is the mean cross-entropy. Over a `mesh` every rank passes the
    global batch and runs its own rows: BatchNorm's statistics are the
    global batch's, and the gradients and metrics are averaged over the
    ranks, so every rank takes the update of the whole batch."""
    bns = {name: m for name, m in model.named_modules() if isinstance(m, FrozenBatchNorm2d)}

    def step(images, labels):
        if mesh is not None:
            rows = local_rows(mesh, images.shape[0])
            images, labels = images[rows], labels[rows]
        labels = labels.long()
        for p in model.parameters():
            p.grad = None
        logits, stats = model(images, train_bn=True, mesh=mesh, compute_dtype=compute_dtype)
        logp = F.log_softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)),
                             dim=-1)
        loss = -logp.gather(1, labels[:, None]).mean()
        loss.backward()
        with torch.no_grad():
            top1 = (logits.argmax(-1) == labels).float().mean()
            top5_idx = logits.topk(min(5, logits.shape[-1]), dim=-1).indices
            top5 = (top5_idx == labels[:, None]).any(dim=1).float().mean()
            metrics = torch.stack([loss.detach(), top1, top5])
        if mesh is not None:
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            all_reduce_sum_(mesh, grads + [metrics])
            torch._foreach_div_(grads + [metrics], float(mesh.size))
        base = {}
        for name, (mean, var) in stats.items():
            base[id(bns[name].running_mean)] = mean
            base[id(bns[name].running_var)] = var
        optimizer.step(base)
        return dict(zip(("loss", "top1", "top5"), metrics))

    return step


def export_torchvision_state_dict(model):
    """The classifier's weights as a torchvision-named numpy state dict
    (os2d_tpu/pretrain/train_imagenet.py:151-183: conv1, bn1, layer1-4, fc
    with weight [num_classes, 2048]), the file that initializes the detector
    or serves torch users."""
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def train(data_root, repmet_exclude_file=None, arch="resnet101", batch_size=256, epochs=90,
          base_lr=0.1, momentum=0.9, weight_decay=1e-4, image_size=224, steps_per_epoch=None,
          output_path="output/imagenet", n_devices=None, log_every=50, seed=0, device=None,
          mesh=None):
    """Pretrain a classifier on an ImageFolder tree (os2d_tpu/pretrain/
    train_imagenet.py:186-240); returns the model. The crops and flips come
    from random.Random(seed + 1), so that every rank draws the same batches.
    With a process group up (torchrun) and no `mesh`, the mesh is
    `make_mesh(n_devices)`; each rank runs its rows of every global batch of
    `batch_size`. Only rank 0 writes <output_path>/backbone_torchvision.pkl,
    at the end of every epoch."""
    logger = setup_logger("OS2D.pretrain")
    if mesh is None and dist.is_initialized():
        mesh = make_mesh(n_devices, device)
        if mesh is None:  # a rank outside the first n_devices: no work
            return None
    if mesh is not None:
        device = mesh.device
        logger.info(f"Data-parallel pretraining over {mesh.size} ranks")
    excluded = set()
    if repmet_exclude_file:
        with open(repmet_exclude_file) as f:
            excluded = {line.strip() for line in f if line.strip()}
        logger.info(f"Excluding {len(excluded)} RepMet test classes")

    dataset = ImageFolderDataset(data_root, excluded)
    logger.info(f"{len(dataset)} images, {dataset.num_classes} classes")
    steps_per_epoch = steps_per_epoch or len(dataset) // batch_size

    model = init_classifier(arch, dataset.num_classes, device, seed)
    schedule = piecewise_constant_schedule(
        base_lr, {steps_per_epoch * 30: 0.1, steps_per_epoch * 60: 0.1})
    optimizer = ChainSGD(model.parameters(), schedule, momentum, weight_decay)
    step_fn = make_train_step(model, optimizer, mesh=mesh)
    uploader = uploader_for(model.fc.weight.device)

    it = batch_iterator(dataset, batch_size, image_size, seed, random.Random(seed + 1))
    t_start = time.time()
    for step_i in range(epochs * steps_per_epoch):
        images, labels = next(it)
        metrics = step_fn(uploader.upload(images), uploader.upload(labels))
        if step_i % log_every == 0:
            logger.info(f"step {step_i}: loss={float(metrics['loss']):.4f} "
                        f"top1={float(metrics['top1']):.4f} "
                        f"top5={float(metrics['top5']):.4f} "
                        f"({time.time() - t_start:.0f}s)")
        if output_path and (step_i + 1) % steps_per_epoch == 0 and primary_host():
            os.makedirs(output_path, exist_ok=True)
            with open(os.path.join(output_path, "backbone_torchvision.pkl"), "wb") as f:
                pickle.dump(export_torchvision_state_dict(model), f)
    return model


def main(argv=None):
    parser = argparse.ArgumentParser(description="ImageNet pretraining (PyTorch port)")
    parser.add_argument("data", help="ImageFolder root (train split)")
    parser.add_argument("--repmet-exclude", default=None,
                        help="repmet_test_classes.txt to exclude")
    parser.add_argument("--arch", default="resnet101")
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--epochs", type=int, default=90)
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--output", default="output/imagenet")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; under torchrun cuda:LOCAL_RANK) or cpu")
    args = parser.parse_args(argv)
    device = args.device
    joined = launched_world_size() > 1
    if joined:
        device = init_distributed(device=None if device == "cuda" else device)
    try:
        train(args.data, args.repmet_exclude, args.arch, args.batch_size, args.epochs, args.lr,
              output_path=args.output, device=device)
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
