"""OS2D's training step in plain PyTorch (aosokin/os2d: os2d/engine/train.py,
objective.py, modeling/box_coder.py), at the recipe of a traffic file:
targets matched to the anchors, classification targets remapped on the
predicted boxes, the RLL objective with smooth-L1 localization, the
gradient of every tensor of the state dict (BatchNorm's four included, as
the port's trainer differentiates them), the global-norm clip, and SGD with
momentum and weight decay. It imports nothing of the port and nothing of
JAX.
"""

from __future__ import annotations

import math

import torch

from . import model as ref
from .decode import box_iou


def match(ious, gt_valid, gt_difficult, high, low):
    """Anchor -> GT row per (image, label): ious [B, L, G, A], gt_valid and
    gt_difficult [B, L, G]. Returns [B, L, A]: the matched row (the first
    of the best), -1 below `low`, -2 between the thresholds or on a
    difficult GT."""
    masked = torch.where(gt_valid[..., None], ious, -1.0)
    best = masked.amax(2)
    rows = masked.argmax(2)
    index = torch.where(best < low, -1, torch.where(best < high, -2, rows))
    difficult = torch.gather(gt_difficult, 2, rows)
    return torch.where((index >= 0) & difficult, -2, index)


def targets(gt, anchors, num_labels, obj):
    """(loc targets [B, L, A, 4], cls targets [B, L, A] in {1, 0, -1})."""
    boxes, labels, difficult, valid = gt
    lab = torch.arange(num_labels, device=boxes.device)
    valid_l = valid[:, None, :] & (labels[:, None, :] == lab[None, :, None])  # [B, L, G]
    diff_l = difficult[:, None, :].expand_as(valid_l)
    ious = box_iou(boxes[:, None, :, None, :], anchors[None, None, None])  # [B, 1, G, A]
    index = match(ious.expand(-1, num_labels, -1, -1), valid_l, diff_l,
                  obj["positive_iou_threshold"], obj["negative_iou_threshold"])
    first = valid_l.int().argmax(-1, keepdim=True)
    rows = torch.where(index >= 0, index, first)
    matched = torch.gather(boxes[:, None].expand(-1, num_labels, -1, -1), 2,
                           rows[..., None].expand(-1, -1, -1, 4))
    loc = ref.encode(ref.clip_to_min_size(matched), ref.clip_to_min_size(anchors))
    has = valid_l.any(-1)[..., None]
    cls = torch.where(has, 1 + index.clamp(-2, 0), 0)
    return torch.where(has[..., None], loc, 0.0), cls


def remapped(loc_pred, gt, anchors, obj):
    """Classification targets of the predicted boxes matched to GT at the
    remap thresholds: [B, L, A] in {1, 0, -1}."""
    boxes, labels, difficult, valid = gt
    num_labels = loc_pred.shape[1]
    lab = torch.arange(num_labels, device=boxes.device)
    valid_l = valid[:, None, :] & (labels[:, None, :] == lab[None, :, None])
    pred = ref.decode(loc_pred, anchors)  # [B, L, A, 4]
    ious = box_iou(boxes[:, None, :, None, :], pred[:, :, None])  # [B, L, G, A]
    index = match(ious, valid_l, difficult[:, None, :].expand_as(valid_l),
                  obj["remap_iou_pos"], obj["remap_iou_neg"])
    return torch.where(valid_l.any(-1)[..., None], 1 + index.clamp(-2, 0), 0)


def objective(loc, loc_t, cls, cls_t, cls_r, cls_neg, obj):
    """The RLL objective: {"loss", "loc_smoothL1", "cls_RLL", "cls_RLL_pos",
    "cls_RLL_neg"}. loc, loc_t [B, L, A, 4]; cls, cls_neg (scores on the
    detached grid, used for negatives) [B, L, A]; cls_t, cls_r targets."""
    pos_reg = cls_t > 0
    num_pos_reg = pos_reg.sum()
    if obj["remap_classification_targets"]:
        cls_t = cls_r
    pos = cls_t > 0
    ignored = cls_t == -1
    neg = ~(ignored | pos)
    num_pos = pos.sum()
    zero = cls.new_zeros(())
    scores = torch.where(pos, cls, zero) + torch.where(neg, cls_neg, zero)
    d = loc - loc_t
    smooth = torch.where(d.abs() < 1.0, 0.5 * d * d, d.abs() - 0.5).sum(-1)
    loc_loss = torch.where(pos_reg, smooth, zero).sum()
    loss_neg = torch.where(neg, 0.5 * torch.clamp(scores - obj["neg_margin"], min=0.0), zero)
    loss_pos = torch.where(pos, 0.5 * torch.clamp(obj["pos_margin"] - scores, min=0.0), zero)
    # positives: rescaled by the share that has a loss
    nontrivial = ((loss_pos > 0) & pos).sum().float()
    loss_pos = torch.where(nontrivial > 0, loss_pos * (num_pos / nontrivial.clamp(min=1.0)), zero)
    # negatives: exponential weights with a temperature per label
    active = (loss_neg > 0) & neg
    detached = loss_neg.detach()
    top = detached.amax(2, keepdim=True).amax(0, keepdim=True)  # [1, L, 1]
    has_loss = top > 1e-5
    temp = torch.where(has_loss, -math.log(obj["rll_neg_weight_ratio"]) / top.clamp(min=1e-20),
                       zero)
    w = torch.exp((detached - top) * temp) * active.float()
    total = w.sum(2, keepdim=True).sum(0, keepdim=True)
    norm = 1.0 / torch.clamp(total * has_loss.float().sum(), min=1e-30)
    norm = torch.where((norm <= 1e-8) | ~has_loss, zero, norm)
    w = torch.where(has_loss, w, zero) * norm * num_pos.clamp(min=1).float()
    loss_neg = torch.where(w > 1e-8, loss_neg, zero) * w
    cls_loss = torch.where(neg, loss_neg, zero) + torch.where(pos, loss_pos, zero)
    n_pos = num_pos.clamp(min=1).float()
    pos_sum = torch.where(pos, cls_loss, zero).sum() / n_pos
    neg_sum = torch.where(~(ignored | pos), cls_loss, zero).sum() / n_pos
    loc_loss = loc_loss / num_pos_reg.clamp(min=1).float()
    cls_total = pos_sum + neg_sum * obj["class_neg_weight"]
    return {"loss": cls_total + loc_loss * obj["loc_weight"], "loc_smoothL1": loc_loss,
            "cls_RLL": cls_total, "cls_RLL_pos": pos_sum, "cls_RLL_neg": neg_sum}


def forward_loss(params, batch, config, traffic, dtype):
    """The step's losses on one batch. params: the state dict's tensors
    (leaves that require grad); batch: the host batch's tensors on the
    device (images uint8 [B, H, W, 3], class_images uint8 [Cp, h, w, 3]
    padded with zero images, class_valid [Cp], gt_* [B, G, ...])."""
    obj = traffic["objective"]
    images = ref.normalize_u8(batch["images"], config)
    fm = ref.backbone(images, params, config, dtype)
    feats = ref.class_features(ref.normalize_u8(batch["class_images"], config), params, config,
                               dtype)
    loc, cls, cls_det = ref.head(fm, feats, params, config, dtype, detached=True)
    loc, cls, cls_det = loc.float(), cls.float(), cls_det.float()
    fh, fw = fm.shape[-2:]
    anchors = ref.image_anchors(fh, fw, config, images.device)
    gt = (batch["gt_boxes"], batch["gt_labels"], batch["gt_difficult"], batch["gt_valid"])
    num_labels = cls.shape[1]
    loc_t, cls_t = targets(gt, anchors, num_labels, obj)
    cls_r = remapped(loc.detach(), gt, anchors, obj)
    cvalid = batch["class_valid"][None, :, None]
    cls_t = torch.where(cvalid, cls_t, -1)
    cls_r = torch.where(cvalid, cls_r, -1)
    cls_neg = cls if obj["train_transform_on_negs"] else cls_det
    return objective(loc, loc_t, cls, cls_t, cls_r, cls_neg, obj)


def train_steps(state, batches, config, traffic, dtype=torch.float32):
    """Follow len(batches) steps from `state` (a state dict, not changed).
    Returns {"losses": [per step], "grads": {name: norm after the first
    step's clip}, "updates": {name: the norm of its momentum buffers summed
    over the steps, the change of the tensor before its rounding},
    "changes": {name: the norm of the fp32 tensor's change over the steps,
    in fp64}, "flip_shares": {name: the most by which one value's change of
    one fp32 spacing moves that norm, as a share of it: max |d_i| s_i /
    |d|^2 over the change d and the spacings s of the last values; inf for
    a tensor that did not move}}."""
    opt = traffic["optim"]
    params = {k: v.detach().clone().requires_grad_(True) for k, v in state.items()}
    momentum, bufs = {}, {}
    losses, first_grad = [], None
    for i, batch in enumerate(batches):
        out = forward_loss(params, batch, config, traffic, dtype)
        grads = torch.autograd.grad(out["loss"], list(params.values()), allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g.float()
                 for g, p in zip(grads, params.values())]
        norm = torch.sqrt(torch.stack([g.square().sum() for g in grads]).sum())
        scale = torch.clamp(opt["max_grad_norm"] / (norm + 1e-6), max=1.0)
        grads = [g * scale for g in grads]
        losses.append(float(out["loss"].detach()))
        if i == 0:
            first_grad = {k: float(g.norm()) for k, g in zip(params, grads)}
        if not math.isfinite(float(norm)):
            continue
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                d = g + opt["weight_decay"] * p
                buf = momentum[k] = d if k not in momentum else momentum[k] * opt["momentum"] + d
                bufs.setdefault(k, []).append(buf)
                p -= opt["lr"] * buf
    applied = {k: float(sum(bufs[k]).norm()) if bufs.get(k) else 0.0 for k in params}
    changes, flip_shares = {}, {}
    for k, p in params.items():
        last = p.detach().float()
        d = last.double() - state[k].detach().double()
        mag = last.abs()
        spacing = (torch.nextafter(mag, torch.full_like(mag, math.inf)) - mag).double()
        square = float(d.square().sum())
        changes[k] = math.sqrt(square)
        flip_shares[k] = float((d.abs() * spacing).max()) / square if square > 0 else math.inf
    return {"losses": losses, "grads": first_grad, "updates": applied, "changes": changes,
            "flip_shares": flip_shares}
