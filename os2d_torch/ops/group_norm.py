"""GroupNorm of the port's backbone: on the card, the CUDA kernels of
`csrc/group_norm_nhwc.cu`; on the CPU, F.group_norm.

`group_norm(x, groups, weight, bias, eps)` is the one entry. For a CUDA x
it takes the kernels, on x made channels-last and 16-byte aligned (a copy
only where x is not already: every activation of `models/resnet.py:
ResNetC4` is an NCHW view of NHWC memory), with fp32 weight and bias on
its device; any other dtype there is refused. Where autograd records, it
goes through an autograd Function whose forward and backward are one
launch each of a C entry point (`FORWARD.launches`, `BACKWARD.launches`),
else through the forward's launch alone. A tensor off the card goes to
F.group_norm and is counted in `fallbacks["cpu"]` (the CPU tests' and the
CPU's main case).

The kernels' statistics are Welford's, merged by Chan's rule in a fixed
order (the source's header); the backward's sums are fixed-order sums with
no atomics, so two calls give the same bits; both directions launch on the
current stream, allocate only through PyTorch's caching allocator and
never synchronise, so `engine/train_graphs.py: BackboneGraphs` captures
them.

`group_norm_reference` and `group_norm_backward_reference` are the plain
versions of the kernels' arithmetic (two-pass statistics; the backward's
sums and coefficients as the kernels form them), for the tests.

Counters since import, read and reset by whoever measures them:
`fallbacks` (calls that took F.group_norm, by reason: "cpu").
"""

from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from .cuda import CudaKernel, aligned

# rows a thread walks in one chunk of a row-parallel kernel (a multiple of
# the kernels' kRowBatch, 4)
ROWS_PER_THREAD = 16
# threads of a row-parallel block where a row needs fewer (C / 4 each)
BLOCK_THREADS = 256
MAX_ROW_THREADS = 512

_P = ctypes.c_void_p
_I = ctypes.c_int
# x, gamma, beta, y, mean, rstd, partial, batch, rows, channels, groups,
# rows_par, chunk_rows, chunks, eps, stream
FORWARD = CudaKernel("group_norm_nhwc.cu", "os2d_group_norm_forward",
                     [_P] * 7 + [_I] * 7 + [ctypes.c_float, _P])
# dy, x, gamma, mean, rstd, dx, dgamma, dbeta, partial, sums, coef, batch,
# rows, channels, groups, rows_par, chunk_rows, chunks, stream
BACKWARD = CudaKernel("group_norm_nhwc.cu", "os2d_group_norm_backward",
                      [_P] * 11 + [_I] * 7 + [_P])

fallbacks = collections.Counter()


def group_norm(x, groups: int, weight, bias, eps: float):
    """F.group_norm(x, groups, weight, bias, eps): on the kernels for a CUDA
    x, else F.group_norm (see the module docstring)."""
    if x.device.type != "cuda":
        fallbacks["cpu"] += 1
        return F.group_norm(x, groups, weight, bias, eps)
    x = aligned(x, torch.channels_last)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias)):
        return _GroupNormChannelsLast.apply(x, groups, weight, bias, eps)
    return group_norm_forward(x, groups, weight, bias, eps)[0]


def refusal(*tensors):
    """Why the kernels do not take these tensors (x first, then vectors),
    or None: each must be fp32, x channels-last contiguous and each 16-byte
    aligned, and all on a CUDA device."""
    x = tensors[0]
    if any(t.dtype != torch.float32 for t in tensors):
        return "fp32 tensors"
    if (x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last)
            or any(t.data_ptr() % 16 for t in tensors)):
        return "channels-last x and 16-byte aligned tensors"
    if any(t.device.type != "cuda" for t in tensors):
        return "CUDA tensors"
    return None


def row_tiling(channels: int, rows: int):
    """(rows_par, chunk_rows, chunks) of the row-parallel kernels: C / 4
    threads on a row, as many rows at once as fill BLOCK_THREADS (one where
    a row needs more), ROWS_PER_THREAD rows a thread in a chunk."""
    vecs = channels // 4
    if vecs > MAX_ROW_THREADS:
        raise ValueError(f"the GroupNorm kernels take at most {4 * MAX_ROW_THREADS} channels, "
                         f"got {channels}")
    rows_par = max(1, BLOCK_THREADS // vecs)
    chunk_rows = rows_par * ROWS_PER_THREAD
    return rows_par, chunk_rows, -(-rows // chunk_rows)


def _check(x, groups, weight, bias=None):
    n, c, h, w = x.shape
    if c % groups or c % 4:
        raise ValueError(f"the GroupNorm kernels need channels divisible by the group count "
                         f"and by 4, got {c} channels in {groups} groups")
    if n * h * w == 0:
        raise ValueError(f"the GroupNorm kernels take no empty input, got {tuple(x.shape)}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and (tuple(t.shape) != (c,) or not t.is_contiguous()
                              or t.device != x.device):
            raise ValueError(f"{name} must be a contiguous [{c}] tensor on {x.device}")
    return n, c, h * w


def group_norm_forward(x, groups: int, weight, bias, eps: float):
    """(y, mean [N*groups], rstd [N*groups]) of channels-last fp32 CUDA x,
    through the forward kernels; y in x's memory format."""
    need = refusal(x, weight, bias)
    if need is not None:
        raise ValueError(f"group_norm_forward takes {need}")
    n, c, rows = _check(x, groups, weight, bias)
    rows_par, chunk_rows, chunks = row_tiling(c, rows)
    y = torch.empty_like(x)
    mean = torch.empty(n * groups, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    partial = torch.empty(n * chunks * groups * 3, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        FORWARD.launch(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
                       mean.data_ptr(), rstd.data_ptr(), partial.data_ptr(), n, rows, c,
                       groups, rows_par, chunk_rows, chunks, float(eps),
                       torch.cuda.current_stream(x.device).cuda_stream)
    return y, mean, rstd


def group_norm_backward(dy, x, groups: int, weight, mean, rstd):
    """(dx, dweight, dbias) of the forward at x for the cotangent dy (both
    channels-last fp32 CUDA), through the backward kernels."""
    need = refusal(dy, weight, mean, rstd) or refusal(x)
    if need is not None:
        raise ValueError(f"group_norm_backward takes {need}")
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} and x {tuple(x.shape)} differ")
    n, c, rows = _check(x, groups, weight)
    rows_par, chunk_rows, chunks = row_tiling(c, rows)
    dx = torch.empty_like(x)
    dweight = torch.empty_like(weight)
    dbias = torch.empty_like(weight)
    partial = torch.empty(2 * n * chunks * c, dtype=torch.float32, device=x.device)
    sums = torch.empty(2 * n * c, dtype=torch.float32, device=x.device)
    coef = torch.empty(2 * n * groups, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        BACKWARD.launch(dy.data_ptr(), x.data_ptr(), weight.data_ptr(), mean.data_ptr(),
                        rstd.data_ptr(), dx.data_ptr(), dweight.data_ptr(), dbias.data_ptr(),
                        partial.data_ptr(), sums.data_ptr(), coef.data_ptr(), n, rows, c,
                        groups, rows_par, chunk_rows, chunks,
                        torch.cuda.current_stream(x.device).cuda_stream)
    return dx, dweight, dbias


class _GroupNormChannelsLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, weight, bias, eps):
        y, mean, rstd = group_norm_forward(x, groups, weight, bias, eps)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.groups = groups
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        dy = aligned(dy, torch.channels_last)
        dx, dweight, dbias = group_norm_backward(dy, x, ctx.groups, weight, mean, rstd)
        need_x, _, need_w, need_b = ctx.needs_input_grad[:4]
        return (dx if need_x else None, None, dweight if need_w else None,
                dbias if need_b else None, None)


def group_norm_reference(x, groups: int, weight, bias, eps: float):
    """The plain version of the forward on NCHW x of any memory format and
    float dtype: (y, mean [N*groups], rstd [N*groups]), two-pass
    statistics, y formed as the kernel forms it."""
    n, c = x.shape[:2]
    g = x.reshape(n, groups, -1)
    mean = g.mean(-1)
    var = (g - mean[..., None]).square().mean(-1)
    rstd = 1 / torch.sqrt(var + eps)
    m = mean.repeat_interleave(c // groups, 1)[:, :, None, None]
    r = rstd.repeat_interleave(c // groups, 1)[:, :, None, None]
    y = (x - m) * r * weight[:, None, None] + bias[:, None, None]
    return y, mean.reshape(-1), rstd.reshape(-1)


def group_norm_backward_reference(dy, x, groups: int, weight, mean, rstd):
    """The plain version of the backward: (dx, dweight, dbias) from the
    per-(n, c) sums of dy and dy * (x - mean) as the kernels form them."""
    n, c, h, w = x.shape
    cg = c // groups
    m = mean.reshape(n, groups).repeat_interleave(cg, 1)  # [N, C]
    r = rstd.reshape(n, groups).repeat_interleave(cg, 1)
    xc = x - m[:, :, None, None]
    sdy = dy.sum((2, 3))
    sdyx = (dy * xc).sum((2, 3))
    a = (weight * sdy).reshape(n, groups, cg).sum(-1)
    b = (weight * sdyx).reshape(n, groups, cg).sum(-1)
    rg = rstd.reshape(n, groups)
    inv_m = 1.0 / (h * w * cg)
    k1 = (rg * a * inv_m).repeat_interleave(cg, 1)[:, :, None, None]
    k2 = (rg * rg * rg * b * inv_m).repeat_interleave(cg, 1)[:, :, None, None]
    dx = (weight[:, None, None] * r[:, :, None, None]) * dy - k1 - xc * k2
    return dx, (sdyx * r).sum(0), sdy.sum(0)
