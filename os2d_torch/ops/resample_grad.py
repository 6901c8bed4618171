"""The correlation resample + masked pool with its gradient.

`resample_correlation_autograd` is a `torch.autograd.Function`, the head's
one way to the resample, in eval (under no_grad, where it records nothing)
and in training. Its forward is
the tier's forward (the bf16 hat kernel `ops/hat_resample.py` at
"default", the fp32 gather `ops/resample.py` at "high"/"highest", the int8
hat kernel `ops/int8_resample.py` at "int8"; their plain versions on CPU
tensors), its backward the CUDA kernels of
`csrc/resample_backward.cu` on the card and its plain version
`ops/sampling.resample_backward_reference` on the CPU. The backward is the
gradient of the hat form under JAX's rules, fp32, at every tier: the JAX
trainer differentiates that form whatever the forward's precision. The
int8 tier has no gradient (it rounds the sample coordinates' hat weights):
where a graph is recorded the "default" tier runs in its place, as JAX's
head falls back in train mode (os2d_tpu/models/head.py:248-251); under
no_grad (eval, eval loss metrics, mining) int8 runs.

It returns the scores twice, as cls and cls_detached (the JAX head's second
resample with px/py detached, os2d_tpu/models/head.py:300-302; the values are
equal): one forward launch. The gradient of cls reaches corr, px and py; that
of cls_detached reaches corr only. The backward is one launch per step of
the C entry point, which enqueues a memset and two kernels: a scatter that
computes dpx, dpy and dcorr's channels < T into a [B*C, T, H*W] scratch,
and a transpose that writes dcorr whole from it.

Backward contract (the kernel's):
  g, g_sum  [B, C, A] float32 contiguous (the gradient of cls; that of cls
            plus cls_detached);
  corr      [B, C, H, W, T_full] float32 contiguous, channels < T read;
  px, py    [B, C, T, A] float32 contiguous, A = H * W; mask_t [C, T].
Returns dcorr shaped like corr (channels >= T zero), dpx, dpy.
A CUDA tensor goes to the kernel, or the call raises; a CPU tensor goes to
the plain version. There is no path from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda import CudaKernel
from .hat_resample import resample_correlation_hat
from .int8_resample import resample_correlation_int8
from .resample import check_contract, resample_correlation
from .sampling import resample_backward_reference

# g, g_sum, corr, px, py, mask, scratch, dcorr, dpx, dpy, bc_count, num_classes,
# h, w, t_count, t_full, stream
ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_int64, ctypes.c_void_p]
KERNEL = CudaKernel("resample_backward.cu", "os2d_resample_correlation_backward", ARGTYPES)

# the resample tiers of the JAX package, by their forward: "default" the
# bf16 hat-weight form (csrc/hat_resample.cu), "high" and "highest" the
# fp32 gather (csrc/resample.cu), "int8" the int8 hat-weight form
# (csrc/int8_hat_resample.cu, no gradient)
FORWARD = {"default": resample_correlation_hat, "high": resample_correlation,
           "highest": resample_correlation, "int8": resample_correlation_int8}


def resample_correlation_backward(g, g_sum, corr, px, py, mask_t):
    """(dcorr, dpx, dpy): the kernel on CUDA tensors, the plain version on
    CPU tensors (see the module docstring for the contract)."""
    t = px.shape[2]
    check_contract(corr[..., :t], px, py, mask_t)
    b, c, h, w, t_full = corr.shape
    for name, x in (("g", g), ("g_sum", g_sum)):
        if tuple(x.shape) != (b, c, h * w) or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be float32 contiguous {(b, c, h * w)}, "
                             f"got {x.dtype} {tuple(x.shape)}")
        if x.device != corr.device:
            raise ValueError(f"{name} is on {x.device}, corr on {corr.device}")
    if not corr.is_contiguous():
        raise ValueError("corr must be contiguous")
    if corr.device.type == "cpu":
        return resample_backward_reference(g, g_sum, corr, px, py, mask_t, t)
    if corr.device.type != "cuda":
        raise ValueError(f"no resample backward kernel for device {corr.device}")
    # the scatter's sums in the library's layout; the entry point clears it
    scratch = torch.empty((b * c, t, h * w), dtype=torch.float32, device=corr.device)
    dcorr = torch.empty_like(corr)
    dpx = torch.empty_like(px)
    dpy = torch.empty_like(py)
    with torch.cuda.device(corr.device):
        KERNEL.launch(
            g.data_ptr(), g_sum.data_ptr(), corr.data_ptr(), px.data_ptr(), py.data_ptr(),
            mask_t.data_ptr(), scratch.data_ptr(), dcorr.data_ptr(), dpx.data_ptr(),
            dpy.data_ptr(),
            b * c, c, h, w, t, t_full, torch.cuda.current_stream(corr.device).cuda_stream,
        )
    return dcorr, dpx, dpy


class _ResampleTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, corr, px, py, mask_t, precision):
        t = px.shape[2]
        cls = FORWARD[precision](corr[..., :t], px, py, mask_t)
        ctx.save_for_backward(corr, px, py, mask_t)
        return cls, cls.clone()

    @staticmethod
    def backward(ctx, g_cls, g_detached):
        corr, px, py, mask_t = ctx.saved_tensors
        b, c, h, w, _ = corr.shape
        zeros = torch.zeros((b, c, h * w), dtype=torch.float32, device=corr.device)
        g = zeros if g_cls is None else g_cls.reshape(b, c, h * w).contiguous()
        g_sum = g if g_detached is None else g + g_detached.reshape(b, c, h * w)
        dcorr, dpx, dpy = resample_correlation_backward(g, g_sum.contiguous(), corr, px, py,
                                                        mask_t)
        return dcorr, dpx, dpy, None, None


def resample_correlation_autograd(corr, px, py, mask_t, precision: str):
    """(cls, cls_detached), each [B, C, H, W], from the full corr tensor
    [B, C, H, W, T_full] (the prefix t < T = px.shape[2] is read) at the
    tier `precision`, differentiable by corr, px and py; "int8" runs as
    "default" where a graph is recorded (see the module docstring)."""
    if precision not in FORWARD:
        raise ValueError(f"unknown resample_precision {precision!r}")
    if precision == "int8" and torch.is_grad_enabled() and (
            corr.requires_grad or px.requires_grad or py.requires_grad):
        precision = "default"
    return _ResampleTrain.apply(corr, px, py, mask_t, precision)
