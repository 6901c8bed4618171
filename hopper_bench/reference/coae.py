"""CoAE's forward pass in plain PyTorch, one (image, query) pair at a time,
written from the paper (Hsieh, Lo, Chen, Liu, NeurIPS 2019, arXiv
1911.12529) and its public code (timy90022/One-Shot-Object-Detection:
lib/model/faster_rcnn/faster_rcnn.py `match_block`, `ChannelGate`; jwyang's
rpn/rpn.py, rpn/proposal_layer.py, generate_anchors.py, bbox_transform.py,
faster_rcnn/resnet.py `_head_to_tail`) at the numerics of
`hopper_bench/configs/coae-r50.json`. It imports nothing of the port and
nothing of JAX; it reads a state dict with the public code's key names (the
backbone's torchvision's). Every function takes the dtype it computes in:
float32 for the reference (TF32 off), bfloat16 for the control.

- `anchors`: py-faster-rcnn's nine base anchors, shifted over the map.
- `co_attention`: match_block and the ChannelGate of one pair, NCHW.
- `rpn_candidates`: every anchor's decoded, clipped box and its foreground
  probability, in (H, W, A) order: the set the RPN's NMS chooses from.
- `propose`: the top `rpn_pre_nms`, greedy NMS, the first `rpn_post_nms`.
- `roi_align`: RoIAlign written as a loop over the RoIs, each RoI's
  samples laid out in a grid of their own (legacy coordinates, adaptive
  sampling; coordinates in numpy float32).
- `second_stage`: RoIAlign, layer4 and the spatial mean, the box and score
  predictors of one pair's RoIs.
- `detect_pair`: all of it, with the final NMS and the top K.
Departures from the code, as the configuration's `assumed` lists them: the
ResNet is torchvision's v1.5 (stride on the 3x3), the images are
normalized by ImageNet's mean and std, NMS's IoU has no +1.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .decode import nms_topk
from .model import conv, frozen_bn


def base_anchors(config):
    """py-faster-rcnn's generate_anchors: [A, 4], ratios outer, scales inner."""
    base = config["feat_stride"]

    def whctrs(a):
        w, h = a[2] - a[0] + 1, a[3] - a[1] + 1
        return w, h, a[0] + 0.5 * (w - 1), a[1] + 0.5 * (h - 1)

    def make(ws, hs, x, y):
        return np.stack([x - 0.5 * (ws - 1), y - 0.5 * (hs - 1), x + 0.5 * (ws - 1),
                         y + 0.5 * (hs - 1)], -1)

    w, h, x, y = whctrs(np.array([1, 1, base, base], np.float64) - 1)
    ratios = np.array(config["anchor_ratios"], np.float64)
    ws = np.round(np.sqrt(w * h / ratios))
    hs = np.round(ws * ratios)
    out = []
    for a in make(ws, hs, x, y):
        aw, ah, ax, ay = whctrs(a)
        scales = np.array(config["anchor_scales"], np.float64)
        out.append(make(aw * scales, ah * scales, ax, ay))
    return np.concatenate(out)


def anchors(h, w, config, device):
    """[H * W * A, 4] anchors of an H x W map, (H, W, A) order."""
    s = config["feat_stride"]
    sx, sy = np.meshgrid(np.arange(w) * s, np.arange(h) * s)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], -1)
    a = base_anchors(config)[None] + shifts[:, None]
    return torch.tensor(a.reshape(-1, 4), dtype=torch.float32, device=device)


def bbox_transform_inv(boxes, deltas):
    widths = boxes[:, 2] - boxes[:, 0] + 1.0
    heights = boxes[:, 3] - boxes[:, 1] + 1.0
    ctr_x = boxes[:, 0] + 0.5 * widths
    ctr_y = boxes[:, 1] + 0.5 * heights
    pred_ctr_x = deltas[:, 0] * widths + ctr_x
    pred_ctr_y = deltas[:, 1] * heights + ctr_y
    pred_w = torch.exp(deltas[:, 2]) * widths
    pred_h = torch.exp(deltas[:, 3]) * heights
    return torch.stack([pred_ctr_x - 0.5 * pred_w, pred_ctr_y - 0.5 * pred_h,
                        pred_ctr_x + 0.5 * pred_w, pred_ctr_y + 0.5 * pred_h], 1)


def clip_boxes(boxes, image_hw):
    h, w = image_hw
    return torch.stack([boxes[:, 0].clamp(0, w - 1), boxes[:, 1].clamp(0, h - 1),
                        boxes[:, 2].clamp(0, w - 1), boxes[:, 3].clamp(0, h - 1)], 1)


def linear(x, sd, name, dtype):
    return F.linear(x, sd[name + ".weight"].to(dtype), sd[name + ".bias"].to(dtype))


def co_attention(x, a, sd, dtype, prefix="match_net."):
    """One pair: scene map x [1, F, H, W] and query map a [1, F, h, w] ->
    (non_det, act_det [1, F, H, W], act_aim [1, F, h, w]), as match_block's
    forward and the ChannelGate compute them."""
    _, c, hd, wd = x.shape
    _, _, ha, wa = a.shape
    x, a = x.to(dtype), a.to(dtype)
    d_x = conv(x, sd, prefix + "g", dtype, bias=True).view(1, -1, hd * wd).permute(0, 2, 1)
    a_x = conv(a, sd, prefix + "g", dtype, bias=True).view(1, -1, ha * wa).permute(0, 2, 1)
    theta_x = conv(a, sd, prefix + "theta", dtype, bias=True).view(1, -1, ha * wa).permute(0, 2, 1)
    phi_x = conv(x, sd, prefix + "phi", dtype, bias=True).view(1, -1, hd * wd)
    f = torch.matmul(theta_x, phi_x)  # [1, N_a, N_d]
    non_aim = torch.matmul(f / f.size(-1), d_x).permute(0, 2, 1).reshape(1, -1, ha, wa)
    non_aim = frozen_bn(conv(non_aim, sd, prefix + "W.0", dtype, bias=True), sd,
                        prefix + "W.1.", dtype) + a
    fi = f.permute(0, 2, 1)
    non_det = torch.matmul(fi / fi.size(-1), a_x).permute(0, 2, 1).reshape(1, -1, hd, wd)
    non_det = frozen_bn(conv(non_det, sd, prefix + "Q.0", dtype, bias=True), sd,
                        prefix + "Q.1.", dtype) + x

    def mlp(v):
        g = prefix + "ChannelGate.mlp."
        return linear(F.relu(linear(v.flatten(1), sd, g + "1", dtype)), sd, g + "3", dtype)

    pooled = (F.avg_pool2d(non_aim, (ha, wa), stride=(ha, wa)),
              F.max_pool2d(non_aim, (ha, wa), stride=(ha, wa)))
    weight = torch.sigmoid(mlp(pooled[0]) + mlp(pooled[1]))[:, :, None, None]
    return non_det, non_det * weight, non_aim * weight


def rpn_candidates(non_det, sd, image_hw, config, dtype, prefix="RCNN_rpn."):
    """(boxes [H*W*A, 4], foreground probabilities [H*W*A]) of one pair, fp32,
    (H, W, A) order: jwyang's _RPN and the decode and clip of its
    _ProposalLayer."""
    _, _, h, w = non_det.shape
    n_a = len(config["anchor_scales"]) * len(config["anchor_ratios"])
    hidden = F.relu(conv(non_det.to(dtype), sd, prefix + "RPN_Conv", dtype, 1, 1, bias=True))
    score = conv(hidden, sd, prefix + "RPN_cls_score", dtype, bias=True)  # [1, 2A, H, W]
    prob = F.softmax(score.view(1, 2, n_a * h, w), 1).view(1, 2 * n_a, h, w)
    fg = prob[:, n_a:].permute(0, 2, 3, 1).reshape(-1).float()
    deltas = conv(hidden, sd, prefix + "RPN_bbox_pred", dtype, bias=True)
    deltas = deltas.permute(0, 2, 3, 1).reshape(-1, 4).float()
    boxes = clip_boxes(bbox_transform_inv(anchors(h, w, config, non_det.device), deltas),
                       image_hw)
    return boxes, fg


def propose(boxes, scores, config):
    """(rois [post, 4], scores [post], valid [post]): the top rpn_pre_nms,
    greedy NMS at rpn_nms_iou, the first rpn_post_nms kept."""
    b, s, v = nms_topk(boxes[None], scores[None], config["rpn_nms_iou"], config["rpn_pre_nms"],
                       config["rpn_post_nms"])
    return b[0], s[0], v[0]


def _axis(coords, size):
    """Per sample coordinate (numpy float32): inside, lo, hi, weight of lo,
    weight of hi, as torchvision's bilinear_interpolate."""
    inside = ~((coords < -1.0) | (coords > size))
    v = np.where(coords <= 0, np.float32(0), coords).astype(np.float32)
    lo = v.astype(np.int64)
    last = lo >= size - 1
    lo = np.where(last, size - 1, lo)
    hi = np.where(last, lo, lo + 1)
    v = np.where(last, lo.astype(np.float32), v)
    l = (v - lo.astype(np.float32)).astype(np.float32)
    return inside, lo, hi, (np.float32(1) - l).astype(np.float32), l


def roi_align(fm, rois, pool, scale):
    """fm [C, H, W] of one pair, rois [R, 4] in image pixels -> [R, C, pool,
    pool]: per RoI, its start, size (at least 1), bins and ceil(size / pool)
    samples a bin side in float32, the bilinear value of every sample, each
    bin the mean of its samples."""
    c, h, w = fm.shape
    f32 = np.float32
    out = []
    for x1, y1, x2, y2 in rois.float().cpu().numpy():
        sw, sh = f32(x1) * f32(scale), f32(y1) * f32(scale)
        rw = max(f32(x2) * f32(scale) - sw, f32(1))
        rh = max(f32(y2) * f32(scale) - sh, f32(1))
        bw, bh = f32(rw / f32(pool)), f32(rh / f32(pool))
        gw, gh = int(np.ceil(rw / f32(pool))), int(np.ceil(rh / f32(pool)))
        ys = np.array([sh + f32(p) * bh + (f32(i) + f32(0.5)) * bh / f32(gh)
                       for p in range(pool) for i in range(gh)], np.float32)
        xs = np.array([sw + f32(p) * bw + (f32(i) + f32(0.5)) * bw / f32(gw)
                       for p in range(pool) for i in range(gw)], np.float32)
        iny, ylo, yhi, hy, ly = (torch.as_tensor(t, device=fm.device) for t in _axis(ys, h))
        inx, xlo, xhi, hx, lx = (torch.as_tensor(t, device=fm.device) for t in _axis(xs, w))
        hy, ly, hx, lx = (t.to(fm.dtype) for t in (hy, ly, hx, lx))

        def at(rows, cols):
            return fm[:, rows][:, :, cols]  # [C, len(ys), len(xs)]

        val = (hy[:, None] * hx[None] * at(ylo, xlo) + hy[:, None] * lx[None] * at(ylo, xhi)
               + ly[:, None] * hx[None] * at(yhi, xlo) + ly[:, None] * lx[None] * at(yhi, xhi))
        val = val * (iny[:, None] & inx[None]).to(fm.dtype)
        out.append(val.reshape(c, pool, gh, pool, gw).sum((2, 4)) / max(gh * gw, 1))
    return torch.stack(out) if out else fm.new_zeros((0, c, pool, pool))


def layer4(x, sd, dtype, prefix="RCNN_top."):
    """torchvision's layer4 (v1.5: stride 2 on the first block's 3x3) on NCHW
    x: 3 bottlenecks of width 512, frozen BatchNorm."""
    x = x.to(dtype)
    for bi in range(3):
        p = f"{prefix}{bi}."
        stride = 2 if bi == 0 else 1
        out = F.relu(frozen_bn(conv(x, sd, p + "conv1", dtype), sd, p + "bn1.", dtype))
        out = F.relu(frozen_bn(conv(out, sd, p + "conv2", dtype, stride, 1), sd, p + "bn2.",
                               dtype))
        out = frozen_bn(conv(out, sd, p + "conv3", dtype), sd, p + "bn3.", dtype)
        if bi == 0:
            x = frozen_bn(conv(x, sd, p + "downsample.0", dtype, stride), sd,
                          p + "downsample.1.", dtype)
        x = F.relu(out + x)
    return x


def second_stage(act_det, act_aim, rois, valid, sd, image_hw, config, dtype):
    """One pair's RoIs [R, 4] (image pixels) -> (boxes [R, 4], scores [R],
    fp32; -inf where a RoI is not valid): RoIAlign on act_det [1, F, H, W],
    layer4 and the mean (r), the query's vector q from act_aim, the box
    deltas times the stds decoded on the RoI and clipped, the score
    softmax(cls_score([r; q]))[1]."""
    pool, stride = config["pool_size"], config["feat_stride"]
    pooled = roi_align(act_det[0].to(dtype), rois, pool, 1.0 / stride)
    r = layer4(pooled, sd, dtype).mean(3).mean(2)
    q = layer4(act_aim, sd, dtype).mean(3).mean(2)
    stds = torch.tensor(config["box_stds"], dtype=dtype, device=r.device)
    deltas = linear(r, sd, "RCNN_bbox_pred", dtype) * stds
    boxes = clip_boxes(bbox_transform_inv(rois.float(), deltas.float()), image_hw)
    feat = torch.cat([r, q.expand(r.shape[0], -1)], 1)
    logits = linear(linear(feat, sd, "RCNN_cls_score.0", dtype), sd, "RCNN_cls_score.1", dtype)
    scores = F.softmax(logits, 1)[:, 1].float()
    return boxes, torch.where(valid, scores, float("-inf"))


def detect_pair(x, a, sd, image_hw, config, nms_iou, top_k, dtype):
    """One pair from its maps x [1, F, H, W], a [1, F, h, w]: (proposals,
    their scores and valid, final boxes [top_k, 4], scores, valid)."""
    non_det, act_det, act_aim = co_attention(x, a, sd, dtype)
    rois, roi_scores, roi_valid = propose(*rpn_candidates(non_det, sd, image_hw, config, dtype),
                                          config)
    boxes, scores = second_stage(act_det, act_aim, rois, roi_valid, sd, image_hw, config, dtype)
    fb, fs, fv = nms_topk(boxes[None], scores[None], nms_iou, boxes.shape[0], top_k)
    return rois, roi_scores, roi_valid, fb[0], fs[0], fv[0]
