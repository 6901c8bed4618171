"""CoAE, the co-attention and co-excitation one-shot detector (Hsieh, Lo,
Chen, Liu, "One-Shot Object Detection with Co-Attention and Co-Excitation",
NeurIPS 2019, arXiv 1911.12529; code github.com/timy90022/One-Shot-Object-
Detection on jwyang/faster-rcnn.pytorch), on the port's ResNet50-C4, for
inference through `engine/evaluate.py: Evaluator.detect_images`.

For one scene I and one query p, at the published widths:

1. x = phi(I) [1024, H, W], a = phi(p) [1024, h, w]: `ResNetC4` (frozen
   BatchNorm), shared by both branches; N_d = H W, N_a = h w.
2. Non-local co-attention (the code's `match_block`, inter 512, the dot
   product form: no softmax): g, theta, phi_ 1x1 convolutions 1024 -> 512
   with bias; f = theta(a)^T phi_(x) [N_a, N_d];
   non_aim = a + W((f / N_d) g(x)), non_det = x + Q((f^T / N_a) g(a)), W
   and Q a 1x1 convolution 512 -> 1024 with bias, then a frozen BatchNorm.
3. Co-excitation (CBAM's ChannelGate, reduction 16):
   c = sigmoid(MLP(avgpool(non_aim)) + MLP(maxpool(non_aim))), MLP
   Linear(1024, 64), ReLU, Linear(64, 1024); act_aim = c * non_aim,
   act_det = c * non_det.
4. RPN on non_det (jwyang's `_RPN`, `_ProposalLayer`, test settings): a 3x3
   convolution 1024 -> 512 and ReLU; cls 1x1 -> 18, anchor a's foreground
   probability softmax(s[a], s[9 + a])[1]; bbox 1x1 -> 36; py-faster-rcnn's
   anchors (base 16, ratios 0.5/1/2, scales 8/16/32) shifted by 16 px in
   (H, W, A) order; `bbox_transform_inv` (+1 widths, no clamp on dw),
   clipped to [0, w - 1] x [0, h - 1]; the top `rpn_pre_nms` by score, NMS
   at `rpn_nms_iou`, the first `rpn_post_nms` kept. No min-size filter.
5. RoI head on act_det: RoIAlign 7x7 at 1/16 (`ops/roi_align.py`, legacy
   coordinates, adaptive sampling), ResNet50's layer4 (`build_layer4`) and
   the spatial mean: r [2048] a RoI; q, the query's vector, the spatial
   mean of layer4(act_aim); box deltas Linear(2048, 4) (class-agnostic)
   times (0.1, 0.1, 0.2, 0.2), decoded on the RoI and clipped as in 4; the
   score softmax(Linear(8, 2)(Linear(4096, 8)([r; q])))[1].
6. Per (image, query): NMS and the top K, in the evaluator's decode.

Batched: the scene-only terms phi_(x), g(x) once per image
(`extract_features`, a `CoaeScene`), the query-only terms theta(a), g(a)
once per query in the class bank (`build_class_head_from_images`, a
`QueryBank`); `apply_head` takes a class chunk and runs steps 2-5 on all
of its (image, query) pairs at once, pair p = image * chunk + query. It
returns per pair the `post` proposals' boxes, scores and validity and the
RoI head's boxes and scores ({"boxes", "scores", "valid", "proposals",
"proposal_scores"}, each [B, chunk, post, ...]); the evaluator's decode
takes NMS and the top K of each pair. fp32 with TF32 off, as `Os2dModel`.

Spans (`utils/profiling.py: annotate`): `os2d.coae.attention` (steps 2-3:
once per image batch for the scene terms in `extract_features`, once per
class chunk for the pairs), `os2d.coae.rpn` (step 4, its NMS included) and
`os2d.coae.roi_head` (step 5), each once per class chunk. Counters
(`counters`): `pairs` and `proposals` (the proposals kept after the RPN's
NMS, summed on the device: reading it waits for the card), besides
`ops.roi_align.KERNEL.launches` and `ops.nms.fixpoint_sweeps`.

Parameter names follow the public code's (`match_net.*`, `RCNN_rpn.*`,
`RCNN_top.*`, `RCNN_bbox_pred`, `RCNN_cls_score.*`); the backbone's are
torchvision's, as `ResNetC4`'s.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.frozen_bn import FrozenBatchNorm2d
from ..ops.nms import nms_topk, top_k_stable
from ..ops.roi_align import roi_align
from ..utils.profiling import annotate, host_constant
from .head import ShapeConstantCache
from .resnet import Conv2d, Linear, ResNetC4, _he_normal_, build_layer4


@dataclasses.dataclass(frozen=True)
class CoaeConfig:
    """CoAE's sizes as published (the public code's `match_block`, CBAM's
    ChannelGate, jwyang's RPN and RoI head at their test settings); fp32
    throughout."""

    backbone_arch: str = "resnet50"
    inter_channels: int = 512
    gate_reduction: int = 16
    rpn_channels: int = 512
    anchor_scales: tuple = (8, 16, 32)
    anchor_ratios: tuple = (0.5, 1.0, 2.0)
    feat_stride: int = 16
    rpn_pre_nms: int = 6000
    rpn_post_nms: int = 300
    rpn_nms_iou: float = 0.7
    pool_size: int = 7
    box_stds: tuple = (0.1, 0.1, 0.2, 0.2)


# channels of the C4 features (ResNetC4's output) and of layer4's output
C4_CHANNELS, LAYER4_CHANNELS = 1024, 2048


class QueryBank(NamedTuple):
    """The class bank of CoAE: per query its map and its query-only terms."""

    feats: torch.Tensor  # [C, h, w, F] a = phi(p)
    theta: torch.Tensor  # [C, h * w, inter] theta(a)
    g: torch.Tensor  # [C, h * w, inter] g(a)


class CoaeScene(NamedTuple):
    """A scene batch's features and its scene-only terms."""

    feats: torch.Tensor  # [B, H, W, F] x = phi(I)
    phi: torch.Tensor  # [B, H * W, inter] phi_(x)
    g: torch.Tensor  # [B, H * W, inter] g(x)
    image_hw: Tuple[int, int]  # the level's image size


class CoaeCounters:
    """`pairs` (host) and `proposals` (summed on the device) since the last
    `reset`; `proposals_kept()` reads the sum, waiting for the card."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.pairs = 0
        self._proposals = None

    def add(self, pairs: int, kept):
        self.pairs += pairs
        total = kept.sum()
        self._proposals = total if self._proposals is None else self._proposals + total

    def proposals_kept(self) -> int:
        return 0 if self._proposals is None else int(self._proposals)


counters = CoaeCounters()


def generate_anchors(base_size: int = 16, ratios=(0.5, 1.0, 2.0), scales=(8, 16, 32)):
    """py-faster-rcnn's `generate_anchors`: [len(ratios) * len(scales)]
    (x1, y1, x2, y2) around the cell [0, base_size - 1]^2, ratios outer,
    scales inner; widths rounded half to even, as numpy rounds."""

    def whctrs(a):
        w, h = a[2] - a[0] + 1, a[3] - a[1] + 1
        return w, h, a[0] + 0.5 * (w - 1), a[1] + 0.5 * (h - 1)

    def make(w, h, cx, cy):
        return [cx - 0.5 * (w - 1), cy - 0.5 * (h - 1), cx + 0.5 * (w - 1), cy + 0.5 * (h - 1)]

    w, h, cx, cy = whctrs([0.0, 0.0, base_size - 1.0, base_size - 1.0])
    out = []
    for ratio in ratios:
        ws = float(round((w * h / ratio) ** 0.5))
        rw, rh, rcx, rcy = whctrs(make(ws, float(round(ws * ratio)), cx, cy))
        out += [make(rw * s, rh * s, rcx, rcy) for s in scales]
    return out


def bbox_transform_inv(boxes, deltas):
    """jwyang's `bbox_transform_inv`: deltas (dx, dy, dw, dh) [..., 4]
    applied to boxes [..., 4] with the +1 widths; dw, dh not clamped."""
    widths = boxes[..., 2] - boxes[..., 0] + 1.0
    heights = boxes[..., 3] - boxes[..., 1] + 1.0
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights
    pred_ctr_x = deltas[..., 0] * widths + ctr_x
    pred_ctr_y = deltas[..., 1] * heights + ctr_y
    pred_w = torch.exp(deltas[..., 2]) * widths
    pred_h = torch.exp(deltas[..., 3]) * heights
    return torch.stack([pred_ctr_x - 0.5 * pred_w, pred_ctr_y - 0.5 * pred_h,
                        pred_ctr_x + 0.5 * pred_w, pred_ctr_y + 0.5 * pred_h], -1)


def clip_boxes(boxes, image_hw):
    """jwyang's `clip_boxes`: x into [0, w - 1], y into [0, h - 1]."""
    h, w = image_hw
    return torch.stack([boxes[..., 0].clamp(0, w - 1), boxes[..., 1].clamp(0, h - 1),
                        boxes[..., 2].clamp(0, w - 1), boxes[..., 3].clamp(0, h - 1)], -1)


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


class ChannelGate(nn.Module):
    """CBAM's ChannelGate: the MLP of the average and of the max pool, summed,
    through a sigmoid; [P, F] weights of [P, F, h, w] maps."""

    def __init__(self, channels: int, reduction: int, device=None):
        super().__init__()
        hidden = channels // reduction
        self.mlp = nn.Sequential(nn.Flatten(), Linear(channels, hidden, device), nn.ReLU(),
                                 Linear(hidden, channels, device))

    def forward(self, x):
        return torch.sigmoid(self.mlp(x.mean((2, 3))) + self.mlp(x.amax((2, 3))))


class MatchBlock(nn.Module):
    """The public code's `match_block`: g, theta, phi; W and Q (a 1x1
    convolution and a frozen BatchNorm each); the ChannelGate."""

    def __init__(self, channels: int, inter: int, reduction: int, device=None):
        super().__init__()
        for name in ("g", "theta", "phi"):
            self.add_module(name, Conv2d(channels, inter, 1, bias=True, device=device))
        for name in ("W", "Q"):
            self.add_module(name, nn.Sequential(Conv2d(inter, channels, 1, bias=True,
                                                       device=device),
                                                FrozenBatchNorm2d(channels, device)))
        self.ChannelGate = ChannelGate(channels, reduction, device)

    def flat(self, conv, feats_nhwc):
        """A 1x1 convolution of [N, h, w, F] maps -> [N, h * w, out]."""
        n, h, w, _ = feats_nhwc.shape
        return _nhwc(conv(_nchw(feats_nhwc))).reshape(n, h * w, -1)


class Rpn(nn.Module):
    """jwyang's `_RPN`: RPN_Conv (3x3, ReLU), RPN_cls_score, RPN_bbox_pred."""

    def __init__(self, channels: int, hidden: int, anchors: int, device=None):
        super().__init__()
        self.RPN_Conv = Conv2d(channels, hidden, 3, 1, 1, bias=True, device=device)
        self.RPN_cls_score = Conv2d(hidden, 2 * anchors, 1, bias=True, device=device)
        self.RPN_bbox_pred = Conv2d(hidden, 4 * anchors, 1, bias=True, device=device)


class CoaeModel(nn.Module):
    """The CoAE network (see the module docstring) on `device`, by default
    "cuda" (raises without it; device="cpu" runs the plain versions of the
    kernels). Weights filled from `seed` (He-normal convolutions, identity
    BatchNorms, torch's default Linear ranges), replaceable with
    load_state_dict. Inference only: no parameter requires a gradient."""

    def __init__(self, config: CoaeConfig = CoaeConfig(), device=None, seed: int = 0):
        super().__init__()
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CoaeModel targets CUDA by default and no CUDA device is "
                               "available; pass device='cpu' to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.config = config
        self.device = device
        c, n_anchors = C4_CHANNELS, len(config.anchor_scales) * len(config.anchor_ratios)
        self.backbone = ResNetC4(config.backbone_arch, device)
        self.match_net = MatchBlock(c, config.inter_channels, config.gate_reduction, device)
        self.RCNN_rpn = Rpn(c, config.rpn_channels, n_anchors, device)
        self.RCNN_top = build_layer4(config.backbone_arch, device, c)
        self.RCNN_bbox_pred = Linear(LAYER4_CHANNELS, 4, device)
        self.RCNN_cls_score = nn.Sequential(Linear(2 * LAYER4_CHANNELS, 8, device),
                                            Linear(8, 2, device))
        self._anchors = ShapeConstantCache(self._make_anchors)
        self.reset_parameters(seed)
        self.requires_grad_(False)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, seed: int):
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self.backbone.reset_parameters(generator)
        heads = [m for child in self.children() if child is not self.backbone
                 for m in child.modules()]
        for module in heads:
            if isinstance(module, Conv2d):
                _he_normal_(module.weight, generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, FrozenBatchNorm2d):
                module.reset_parameters()
            elif isinstance(module, Linear):
                bound = 1.0 / module.weight.shape[1] ** 0.5
                module.weight.uniform_(-bound, bound, generator=generator)
                module.bias.uniform_(-bound, bound, generator=generator)

    def anchors(self, h: int, w: int):
        """[H * W * A, 4] anchors of an H x W map in image pixels, (H, W, A)
        order; built once per device and map size (one host copy), held as
        the OS2D head's constants are (`head.ShapeConstantCache`)."""
        return self._anchors.lookup(self.device, h, w)

    def _make_anchors(self, device, h, w):
        cfg = self.config
        base = host_constant(generate_anchors(cfg.feat_stride, cfg.anchor_ratios,
                                              cfg.anchor_scales),
                             dtype=torch.float32, device=device)
        sy = torch.arange(h, device=device, dtype=torch.float32) * cfg.feat_stride
        sx = torch.arange(w, device=device, dtype=torch.float32) * cfg.feat_stride
        yy, xx = torch.meshgrid(sy, sx, indexing="ij")
        shifts = torch.stack([xx, yy, xx, yy], -1).reshape(h * w, 1, 4)
        return (base[None] + shifts).reshape(-1, 4)

    def extract_features(self, images_nhwc) -> CoaeScene:
        """[B, H, W, 3] normalized images -> the scene's features and its
        scene-only terms."""
        x = self.backbone(images_nhwc)
        with annotate("os2d.coae.attention"):
            m = self.match_net
            return CoaeScene(x, m.flat(m.phi, x), m.flat(m.g, x),
                             (int(images_nhwc.shape[1]), int(images_nhwc.shape[2])))

    @torch.no_grad()
    def build_class_head_from_images(self, class_images) -> QueryBank:
        """Query images (a list of [h, w, 3] normalized tensors or arrays,
        all of one size) -> QueryBank: their maps, as the backbone gives
        them (no resize, no L2 norm), and theta(a), g(a)."""
        shapes = {tuple(img.shape) for img in class_images}
        if len(shapes) != 1:
            raise ValueError(f"CoAE's queries must share one size, got {sorted(shapes)}")
        batch = torch.stack([torch.as_tensor(img, device=self.device) for img in class_images])
        a = self.backbone(batch)
        m = self.match_net
        return QueryBank(a, m.flat(m.theta, a), m.flat(m.g, a))

    def attend(self, scene: CoaeScene, bank: QueryBank):
        """Step 2 on every (image, query) pair: (non_det [P, H, W, F],
        non_aim [P, h, w, F]), pair p = image * C + query."""
        m = self.match_net
        b, h, w, f = scene.feats.shape
        c, qh, qw, _ = bank.feats.shape
        n_d, n_a = h * w, qh * qw
        # f = theta(a)^T phi_(x): [B, C, N_a, N_d]
        corr = torch.matmul(bank.theta[None], scene.phi[:, None].transpose(-1, -2))
        non_aim = torch.matmul(corr / n_d, scene.g[:, None])  # [B, C, N_a, inter]
        non_det = torch.matmul(corr.transpose(-1, -2) / n_a, bank.g[None])  # [B, C, N_d, inter]
        del corr
        p = b * c
        non_aim = m.W[1](m.W[0](_nchw(non_aim.reshape(p, qh, qw, -1))))
        non_aim = _nhwc(non_aim).reshape(b, c, qh, qw, f) + bank.feats[None]
        non_det = m.Q[1](m.Q[0](_nchw(non_det.reshape(p, h, w, -1))))
        non_det = _nhwc(non_det).reshape(b, c, h, w, f) + scene.feats[:, None]
        return non_det.reshape(p, h, w, f), non_aim.reshape(p, qh, qw, f)

    def excite(self, non_det, non_aim):
        """Step 3: (act_det, act_aim), each map times its pair's gate."""
        gate = self.match_net.ChannelGate(_nchw(non_aim))[:, None, None]  # [P, 1, 1, F]
        return non_det * gate, non_aim * gate

    def propose(self, non_det, image_hw):
        """Step 4: (rois [P, post, 4], scores [P, post], valid [P, post]) in
        the level's image pixels, sorted by score."""
        cfg, rpn = self.config, self.RCNN_rpn
        p, h, w, _ = non_det.shape
        hidden = F.relu(rpn.RPN_Conv(_nchw(non_det)))
        n_a = len(cfg.anchor_scales) * len(cfg.anchor_ratios)
        logits = _nhwc(rpn.RPN_cls_score(hidden)).reshape(p, h, w, 2, n_a)
        scores = torch.softmax(logits, dim=3)[:, :, :, 1].reshape(p, -1)  # (H, W, A)
        deltas = _nhwc(rpn.RPN_bbox_pred(hidden)).reshape(p, -1, 4)
        boxes = clip_boxes(bbox_transform_inv(self.anchors(h, w)[None], deltas), image_hw)
        top_scores, top_idx = top_k_stable(scores, min(cfg.rpn_pre_nms, scores.shape[1]))
        top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
        rois, roi_scores, valid, _ = nms_topk(top_boxes, top_scores,
                                              torch.ones_like(top_scores, dtype=torch.bool),
                                              cfg.rpn_nms_iou, cfg.rpn_post_nms)
        return rois, roi_scores, valid

    def pool_rois(self, act_det, rois):
        """RoIAlign of each pair's rois [P, post, 4] on its act_det [P, H, W,
        F] -> [P * post, pool, pool, F]."""
        p, post = rois.shape[:2]
        index = torch.arange(p, device=rois.device, dtype=rois.dtype).repeat_interleave(post)
        return roi_align(act_det.contiguous(), torch.cat([index[:, None], rois.reshape(-1, 4)], 1),
                         self.config.pool_size, 1.0 / self.config.feat_stride)

    def head_to_tail(self, pooled_nhwc):
        """layer4 and the spatial mean: [N, s, s, F] -> [N, 2048]."""
        x = _nchw(pooled_nhwc)
        for block in self.RCNN_top:
            x = block(x)
        return x.mean((2, 3))

    def query_vectors(self, act_aim):
        """q of each pair: [P, 2048]."""
        return self.head_to_tail(act_aim)

    def score_rois(self, act_det, act_aim, rois, image_hw):
        """Step 5: (boxes [P, post, 4] clipped to the level's image, scores
        [P, post])."""
        cfg = self.config
        p, post = rois.shape[:2]
        r = self.head_to_tail(self.pool_rois(act_det, rois))  # [P * post, 2048]
        q = self.query_vectors(act_aim)  # [P, 2048]
        d = self.RCNN_bbox_pred(r)
        deltas = torch.stack([d[:, k] * cfg.box_stds[k] for k in range(4)], -1)
        boxes = clip_boxes(bbox_transform_inv(rois.reshape(-1, 4), deltas), image_hw)
        logits = self.RCNN_cls_score(torch.cat([r, q.repeat_interleave(post, 0)], 1))
        scores = torch.softmax(logits, dim=1)[:, 1]
        return boxes.reshape(p, post, 4), scores.reshape(p, post)

    @torch.no_grad()
    def apply_head(self, scene: CoaeScene, bank: QueryBank):
        """Steps 2-5 on every (image, query) pair of a class chunk: {"boxes"
        [B, C, post, 4], "scores" [B, C, post], "valid" [B, C, post],
        "proposals" [B, C, post, 4], "proposal_scores" [B, C, post]}, boxes in
        the level's image pixels. Runs in spans `os2d.coae.attention`,
        `os2d.coae.rpn`, `os2d.coae.roi_head`."""
        b, c = scene.feats.shape[0], bank.feats.shape[0]
        with annotate("os2d.coae.attention"):
            non_det, non_aim = self.attend(scene, bank)
            act_det, act_aim = self.excite(non_det, non_aim)
        with annotate("os2d.coae.rpn"):
            rois, roi_scores, valid = self.propose(non_det, scene.image_hw)
            del non_det
        with annotate("os2d.coae.roi_head"):
            boxes, scores = self.score_rois(act_det, act_aim, rois, scene.image_hw)
        counters.add(b * c, valid)
        post = rois.shape[1]
        return {"boxes": boxes.reshape(b, c, post, 4), "scores": scores.reshape(b, c, post),
                "valid": valid.reshape(b, c, post), "proposals": rois.reshape(b, c, post, 4),
                "proposal_scores": roi_scores.reshape(b, c, post)}
