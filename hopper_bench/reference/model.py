"""OS2D's forward pass in plain PyTorch, written from the model's equations
(aosokin/os2d: os2d/modeling/model.py, head.py, feature_extractor.py) at the
numerics the benchmark's configurations state. It imports nothing of the
port and nothing of JAX; it reads a state dict with torchvision's and
OS2D's key names and a configuration of `hopper_bench/configs/`.

Every function takes the dtype it computes in: float32 for the reference
(TF32 off), bfloat16 for the control that must come out as not correct.

- `backbone`: ResNet-C4 (torchvision v1.5 bottlenecks), NCHW, every norm
  slot frozen BatchNorm or, where the configuration sets `use_group_norm`,
  GroupNorm(32) (`group_norm`: per sample and group of C/32 channels, the
  mean and the biased variance over (C/32, H, W), eps 1e-5, then the
  per-channel weight and bias; the statistics of the activations, so the
  gradient goes through them).
- `class_features`: class images through the backbone, resized to the
  15x15 template with align_corners, L2-normalized over channels
  (eps 1e-5 added to the norm).
- `head`: the dense correlation of the L2-normalized feature map with every
  template point, the TransformNet (ReLU, channel L2 norm eps 1e-6, conv
  7x7 -> BN -> ReLU -> conv 5x5 -> BN -> ReLU -> conv 5x5), theta (V2: six
  outputs, inverted; V1: four outputs [sx, tx, sy, ty], not inverted), the
  resample of the correlation at theta's grid over the template's interior
  (border 2 masked), pooled with the mask's weight 1/121, and the box of
  each anchor from theta's envelope, SSD-encoded against 240/16 anchors.
- The resample at the `default` tier: each value corr * mask and each row
  hat weight rounded to bf16, the column hat weights and every sum fp32;
  where a graph is recorded its gradient is the fp32 hat form's (the value
  is the rounded one).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
GN_GROUPS = 32
BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
BBOX_XFORM_CLIP = math.log(1000.0 / 16)


def set_exact_float32():
    """TF32 off for cuDNN and cuBLAS, and no reduced-precision bf16 sums."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def frozen_bn(x, sd, prefix, dtype):
    """x * (w / sqrt(var + eps)) + (b - mean * w / sqrt(var + eps)), NCHW."""
    scale = sd[prefix + "weight"].to(dtype) * torch.rsqrt(sd[prefix + "running_var"].to(dtype)
                                                        + BN_EPS)
    shift = sd[prefix + "bias"].to(dtype) - sd[prefix + "running_mean"].to(dtype) * scale
    return x * scale[:, None, None] + shift[:, None, None]


def group_norm(x, sd, prefix, dtype):
    """(x - mean) / sqrt(var + eps) * w + b, the mean and the biased
    variance of each sample's group of C/32 channels over (C/32, H, W),
    in two passes, NCHW."""
    n, c, h, w = x.shape
    g = x.to(dtype).reshape(n, GN_GROUPS, c // GN_GROUPS * h * w)
    d = g - g.mean(-1, keepdim=True)
    y = (d * torch.rsqrt(d.square().mean(-1, keepdim=True) + BN_EPS)).reshape(n, c, h, w)
    return (y * sd[prefix + "weight"].to(dtype)[:, None, None]
            + sd[prefix + "bias"].to(dtype)[:, None, None])


def conv(x, sd, name, dtype, stride=1, padding=0, bias=False):
    w = sd[name + ".weight"].to(dtype)
    b = sd[name + ".bias"].to(dtype) if bias else None
    return F.conv2d(x, w, b, stride, padding)


def backbone(images_nchw, sd, config, dtype, prefix="backbone."):
    """Normalized images [N, 3, H, W] -> C4 features [N, 1024, H/16, W/16]."""
    norm = group_norm if config.get("use_group_norm", False) else frozen_bn
    x = images_nchw.to(dtype)
    x = F.relu(norm(conv(x, sd, prefix + "conv1", dtype, 2, 3), sd, prefix + "bn1.", dtype))
    x = F.max_pool2d(x, 3, 2, 1)
    for li, blocks in enumerate(config["backbone_blocks"]):
        for bi in range(blocks):
            p = f"{prefix}layer{li + 1}.{bi}."
            stride = 2 if (li > 0 and bi == 0) else 1
            out = F.relu(norm(conv(x, sd, p + "conv1", dtype), sd, p + "bn1.", dtype))
            out = F.relu(norm(conv(out, sd, p + "conv2", dtype, stride, 1), sd, p + "bn2.",
                              dtype))
            out = norm(conv(out, sd, p + "conv3", dtype), sd, p + "bn3.", dtype)
            if bi == 0:
                x = norm(conv(x, sd, p + "downsample.0", dtype, stride), sd,
                         p + "downsample.1.", dtype)
            x = F.relu(out + x)
    return x


def l2_normalize(x, eps, dim):
    return x / (torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True)) + eps)


def normalize_u8(images_u8_nhwc, config, dtype=torch.float32):
    """uint8 [N, H, W, 3] -> normalized [N, 3, H, W] in `dtype`."""
    dev = images_u8_nhwc.device
    mean = torch.tensor(config["normalization_mean"], dtype=torch.float32, device=dev)
    std = torch.tensor(config["normalization_std"], dtype=torch.float32, device=dev)
    x = (images_u8_nhwc.float() / 255.0 - mean) / std
    return x.permute(0, 3, 1, 2).to(dtype)


def antialias_matrix(n_in, n_out, device):
    """[n_out, n_in] weights of a bilinear resize with antialiasing (the
    triangle kernel widened by the downscale factor, each output's weights
    normalized to sum 1, zero for samples outside the input), as the port's
    pyramid and jax.image.resize define it."""
    inv = n_in / n_out
    kscale = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float64, device=device) + 0.5) * inv - 0.5
    dist = (sample[:, None] - torch.arange(n_in, dtype=torch.float64, device=device)[None]).abs()
    w = torch.clamp(1.0 - dist / kscale, min=0.0)
    total = w.sum(1, keepdim=True)
    w = torch.where(total > 0, w / torch.where(total > 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, None], w, 0.0).float()


def pyramid_level(x_nchw, out_h, out_w):
    """Resize normalized fp32 images to (out_h, out_w), an axis that keeps its
    size untouched."""
    _, _, h, w = x_nchw.shape
    if out_h != h:
        x = torch.einsum("oh,nchw->ncow", antialias_matrix(h, out_h, x_nchw.device), x_nchw)
    else:
        x = x_nchw
    if out_w != w:
        x = torch.einsum("pw,nchw->nchp", antialias_matrix(w, out_w, x.device), x)
    return x


def class_features(class_images_nchw, sd, config, dtype):
    """Normalized class images [C, 3, h, w] -> [C, 15, 15, F] template
    features, L2-normalized over F."""
    fm = backbone(class_images_nchw, sd, config, dtype)
    n = config["template_size"]
    if fm.shape[-2:] != (n, n):
        fm = F.interpolate(fm.float(), size=(n, n), mode="bilinear",
                           align_corners=True).to(dtype)
    return l2_normalize(fm.permute(0, 2, 3, 1), 1e-5, -1)


def transform_net(corr_nchw, sd, config, dtype, prefix="transform_net."):
    """[N, 225, H, W] correlation maps -> [N, P, H, W] transform parameters."""
    k0, k1, k2 = config["transform_kernels"]
    x = l2_normalize(F.relu(corr_nchw), 1e-6, 1)
    x = F.relu(frozen_bn(conv(x, sd, prefix + "conv0", dtype, 1, k0 // 2, bias=True), sd,
                         prefix + "bn0.", dtype))
    x = F.relu(frozen_bn(conv(x, sd, prefix + "conv1", dtype, 1, k1 // 2, bias=True), sd,
                         prefix + "bn1.", dtype))
    return conv(x, sd, prefix + "linear", dtype, 1, k2 // 2, bias=True)


def theta_from_params(p, config):
    """[..., P] -> [..., 2, 3] affine matrices (x_in = t00 x + t01 y + t02)."""
    if config["use_simplified_affine_model"]:
        z = torch.zeros_like(p[..., 0])
        rows = [p[..., 0], z, p[..., 1], z, p[..., 2], p[..., 3]]
        theta = torch.stack(rows, -1).reshape(p.shape[:-1] + (2, 3))
    else:
        theta = p.reshape(p.shape[:-1] + (2, 3))
    if config["use_inverse_geom_model"]:
        theta = invert_affine(theta)
    return theta


def invert_affine(theta, reg=1e-5):
    """Inverse of [[A, t], [0, 1]]: [[A^-1, -A^-1 t]]; where |det A| < 1e-12
    the matrix is first regularized by reg on the diagonal of the 3x3."""
    a, b, c = theta[..., 0, 0], theta[..., 0, 1], theta[..., 0, 2]
    d, e, f = theta[..., 1, 0], theta[..., 1, 1], theta[..., 1, 2]
    bad = torch.abs(a * e - b * d) < 1e-12
    a = torch.where(bad, a + reg, a)
    e = torch.where(bad, e + reg, e)
    s = torch.where(bad, torch.full_like(a, 1.0 / (1.0 + reg)), torch.ones_like(a))
    det = a * e - b * d
    ia, ib, id_, ie = e / det, -b / det, -d / det, a / det
    ic = -(ia * c + ib * f) * s
    if_ = -(id_ * c + ie * f) * s
    return torch.stack([torch.stack([ia, ib, ic], -1), torch.stack([id_, ie, if_], -1)], -2)


def template_lattice(config, device):
    """The interior template points' local coordinates in [-1, 1] and the
    corr channel of each: point (x, y) of the n x n template is channel
    x * n + y; the border of width pool_border is left out (its mask is 0)."""
    n, bw = config["template_size"], config["pool_border"]
    coords = torch.tensor([-1.0 + 2.0 * k / (n - 1) for k in range(n)], dtype=torch.float64,
                          device=device).float()
    inner = range(bw, n - bw)
    pts = [(x, y) for x in inner for y in inner]
    ux = torch.stack([coords[x] for x, _ in pts])
    uy = torch.stack([coords[y] for _, y in pts])
    channels = torch.tensor([x * n + y for x, y in pts], device=device)
    return ux, uy, channels


def _hat_gather(vals, px, py, h, w, round_rows):
    """sum over the <= 2x2 cells around (px, py) of hat(py - i) * v[i, j] *
    hat(px - j), cells outside the map dropped. vals [B, C, T, H*W]; px, py
    [B, C, T, A] -> [B, C, T, A]."""
    x0 = torch.floor(px).detach()
    y0 = torch.floor(py).detach()
    out = torch.zeros_like(px)
    for dy in (0, 1):
        yi = y0 + dy
        wy = torch.clamp(1.0 - (py - yi).abs(), min=0.0)
        if round_rows:
            wy = wy.to(torch.bfloat16).to(px.dtype)
        row = y0.long() + dy
        for dx in (0, 1):
            xi = x0 + dx
            wx = torch.clamp(1.0 - (px - xi).abs(), min=0.0)
            col = x0.long() + dx
            inside = (col >= 0) & (col < w) & (row >= 0) & (row < h)
            v = torch.gather(vals, 3, row.clamp(0, h - 1) * w + col.clamp(0, w - 1))
            out = out + torch.where(inside, (wy * v) * wx, 0.0)
    return out


def resample(corr, px, py, mask, dtype):
    """Scores [B, C, A] = sum_t resample(corr[..., t] * mask[t]) at (px, py).

    corr [B, C, T, H, W] (the interior channels), px, py [B, C, T, A] in
    pixels of the map, mask [T]. At float32 (the `default` tier) the values
    corr * mask and the row weights are rounded to bf16 and the sums are
    fp32; the gradient, where a graph is recorded, is that of the fp32 form.
    At another dtype every step runs in it."""
    b, c, t, h, w = corr.shape
    vals = (corr * mask[:, None, None]).reshape(b, c, t, h * w)
    if dtype != torch.float32:
        return _hat_gather(vals, px, py, h, w, False).sum(2)
    rounded = vals.to(torch.bfloat16).to(torch.float32)
    with torch.no_grad():
        value = _hat_gather(rounded, px, py, h, w, True).sum(2)
    if not torch.is_grad_enabled() or not any(x.requires_grad for x in (corr, px, py)):
        return value
    exact = _hat_gather(vals, px, py, h, w, False).sum(2)
    return exact + (value - exact).detach()


def anchor_centers(h, w, stride, device, dtype):
    ys = (torch.arange(h, dtype=dtype, device=device) + 0.5) * stride
    xs = (torch.arange(w, dtype=dtype, device=device) + 0.5) * stride
    cy, cx = torch.meshgrid(ys, xs, indexing="ij")
    return cx.reshape(-1), cy.reshape(-1)


def clip_to_min_size(boxes, min_size=1.0):
    """Sides below min_size grow from the top-left corner; in that branch the
    box takes no gradient."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    need_w = (x1 + min_size) > x2
    need_h = (y1 + min_size) > y2
    x1d, y1d = x1.detach(), y1.detach()
    return torch.stack([torch.where(need_w, x1d, x1), torch.where(need_h, y1d, y1),
                        torch.where(need_w, x1d + min_size, x2),
                        torch.where(need_h, y1d + min_size, y2)], -1)


def encode(boxes, anchors):
    """SSD-style regression codes of xyxy boxes against xyxy anchors."""
    aw, ah = anchors[..., 2] - anchors[..., 0], anchors[..., 3] - anchors[..., 1]
    acx, acy = anchors[..., 0] + 0.5 * aw, anchors[..., 1] + 0.5 * ah
    gw, gh = boxes[..., 2] - boxes[..., 0], boxes[..., 3] - boxes[..., 1]
    gcx, gcy = boxes[..., 0] + 0.5 * gw, boxes[..., 1] + 0.5 * gh
    wx, wy, ww, wh = BOX_WEIGHTS
    return torch.stack(torch.broadcast_tensors(
        wx * (gcx - acx) / aw, wy * (gcy - acy) / ah,
        ww * torch.log(gw / aw), wh * torch.log(gh / ah)), -1)


def decode(codes, anchors):
    """Inverse of `encode`, with dw and dh clipped at log(1000 / 16)."""
    aw, ah = anchors[..., 2] - anchors[..., 0], anchors[..., 3] - anchors[..., 1]
    acx, acy = anchors[..., 0] + 0.5 * aw, anchors[..., 1] + 0.5 * ah
    wx, wy, ww, wh = BOX_WEIGHTS
    cx = codes[..., 0] / wx * aw + acx
    cy = codes[..., 1] / wy * ah + acy
    pw = torch.exp(torch.clamp(codes[..., 2] / ww, max=BBOX_XFORM_CLIP)) * aw
    ph = torch.exp(torch.clamp(codes[..., 3] / wh, max=BBOX_XFORM_CLIP)) * ah
    return torch.stack([cx - 0.5 * pw, cy - 0.5 * ph, cx + 0.5 * pw, cy + 0.5 * ph], -1)


def image_anchors(h, w, config, device):
    """[H*W, 4] anchors of the feature map's cells in image pixels."""
    cx, cy = anchor_centers(h, w, float(config["anchor_stride"]), device, torch.float32)
    half = config["anchor_box"] / 2.0
    return torch.stack([cx - half, cy - half, cx + half, cy + half], -1)


def head(fm_nchw, class_feats, sd, config, dtype, detached=False):
    """Backbone features [B, F, H, W] and template features [C, n, n, F] ->
    (loc [B, C, A, 4] codes, cls [B, C, A]), A = H * W, anchor a = y * W + x;
    with `detached` also cls_detached, the same scores with the sample grid
    detached (training scores negatives on it)."""
    b, f, h, w = fm_nchw.shape
    c, n = class_feats.shape[0], config["template_size"]
    a = h * w
    dev = fm_nchw.device
    fmn = l2_normalize(fm_nchw.to(dtype), 1e-5, 1).permute(0, 2, 3, 1).reshape(b * a, f)
    # template point (x, y) -> channel x * n + y
    feats = class_feats.to(dtype).permute(0, 2, 1, 3).reshape(c * n * n, f)
    corr = (fmn @ feats.T).reshape(b, h, w, c, n * n).permute(0, 3, 4, 1, 2)  # [B, C, T, H, W]
    params = transform_net(corr.reshape(b * c, n * n, h, w), sd, config, dtype)
    params = params.permute(0, 2, 3, 1).reshape(b, c, a, -1)
    theta = theta_from_params(params, config)  # [B, C, A, 2, 3]

    ux, uy, channels = template_lattice(config, dev)
    ux, uy = ux.to(dtype)[:, None], uy.to(dtype)[:, None]  # [T, 1]
    fcx, fcy = anchor_centers(h, w, 1.0, dev, dtype)  # feature-map anchors, box 15, stride 1
    half = (config["template_size"] / 2.0)
    px, py = [], []
    for th in (theta, theta.detach())[:2 if detached else 1]:
        t = th[:, :, None]  # [B, C, 1, A, 2, 3]
        lx = t[..., 0, 0] * ux + t[..., 0, 1] * uy + t[..., 0, 2]
        ly = t[..., 1, 0] * ux + t[..., 1, 1] * uy + t[..., 1, 2]
        gx = torch.clamp((lx * half + fcx) / (w - 1) * 2.0 - 1.0, -1.0, 1.0)
        gy = torch.clamp((ly * half + fcy) / (h - 1) * 2.0 - 1.0, -1.0, 1.0)
        px.append((gx + 1.0) * 0.5 * (w - 1))
        py.append((gy + 1.0) * 0.5 * (h - 1))
    inner = corr[:, :, channels]
    mask = torch.full((channels.numel(),), 1.0 / channels.numel(), dtype=dtype, device=dev)
    cls = resample(inner, px[0], py[0], mask, dtype)
    cls_detached = resample(inner, px[1], py[1], mask, dtype) if detached else None

    anchors = image_anchors(h, w, config, dev).to(dtype)
    ext_x = theta[..., 0, 0].abs() + theta[..., 0, 1].abs()
    ext_y = theta[..., 1, 0].abs() + theta[..., 1, 1].abs()
    half_box = config["anchor_box"] / 2.0
    acx = (anchors[:, 0] + anchors[:, 2]) / 2.0
    acy = (anchors[:, 1] + anchors[:, 3]) / 2.0
    boxes = torch.stack([(theta[..., 0, 2] - ext_x) * half_box + acx,
                         (theta[..., 1, 2] - ext_y) * half_box + acy,
                         (theta[..., 0, 2] + ext_x) * half_box + acx,
                         (theta[..., 1, 2] + ext_y) * half_box + acy], -1)
    loc = encode(clip_to_min_size(boxes), clip_to_min_size(anchors))
    return (loc, cls, cls_detached) if detached else (loc, cls)
