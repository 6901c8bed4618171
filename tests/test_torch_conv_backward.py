"""The port's convolution with repeatable gradients
(`os2d_torch.models.resnet.conv2d`), on the CPU.

- Its forward and gradients equal F.conv2d's under autograd to the bit, at
  the port's kinds of convolution (1x1 and 3x3 at strides 1 and 2, the 7x7
  stem without an input gradient, the TransformNet's biased 7x7 and 5x5),
  on channels-last and contiguous inputs; fp32 through its own backward,
  bf16 through F.conv2d's. Without autograd it is F.conv2d itself.
- The card's rule (`_repeatable_backward`: the 1x1 weight gradient as
  batched GEMMs in a fixed sum, the strided input gradient as forward
  convolutions of its phases, cuDNN's deterministic algorithms for the
  others) run on the CPU gives ATen's gradients: the GEMMs and the phases
  within fp32 rounding of ATen's sums, the rest to the bit; the cuDNN flags
  are restored on every exit.
- Every convolution of the port goes through it (no other F.conv2d).
"""

import ast
import pathlib

import pytest
import torch
import torch.nn.functional as F

from os2d_torch.models import resnet
from os2d_torch.models.resnet import conv2d, conv2d_backward, wgrad_1x1_gemm

ROOT = pathlib.Path(__file__).resolve().parents[1]
# (N, Cin, H, W, Cout, kernel, stride, padding, bias, input needs a gradient)
CASES = {
    "1x1": (2, 16, 9, 7, 8, 1, 1, 0, False, True),
    "1x1_stride2": (2, 16, 9, 7, 8, 1, 2, 0, False, True),
    "3x3": (2, 8, 9, 7, 6, 3, 1, 1, False, True),
    "3x3_stride2": (2, 8, 9, 7, 6, 3, 2, 1, False, True),
    "stem_7x7_stride2": (2, 3, 17, 15, 8, 7, 2, 3, False, False),
    "transform_7x7_bias": (3, 12, 6, 5, 8, 7, 1, 3, True, True),
    "transform_5x5_bias": (3, 8, 6, 5, 6, 5, 1, 2, True, True),
}


def _inputs(case, dtype, channels_last, seed=0):
    n, cin, h, w, cout, k, stride, padding, bias, input_grad = CASES[case]
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, cin, h, w, generator=gen).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    weight = torch.randn(cout, cin, k, k, generator=gen).to(dtype)
    b = torch.randn(cout, generator=gen).to(dtype) if bias else None
    return x.requires_grad_(input_grad), weight, b, stride, padding


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("channels_last", [True, False], ids=["nhwc", "nchw"])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_gradients_equal_autograd(case, channels_last, dtype):
    outs = []
    for fn in (F.conv2d, conv2d):
        x, w, b, stride, padding = _inputs(case, dtype, channels_last)
        w.requires_grad_()
        if b is not None:
            b.requires_grad_()
        y = fn(x, w, b, stride, padding)
        g = torch.randn(y.shape, generator=torch.Generator().manual_seed(1)).to(dtype)
        y.backward(g.contiguous(memory_format=torch.channels_last) if channels_last else g)
        outs.append((y, x.grad, w.grad, None if b is None else b.grad))
    # fp32 takes the repeatable backward; bf16 keeps F.conv2d's own
    assert (type(outs[1][0].grad_fn).__name__ == "_RepeatableConv2dBackward") == (
        dtype == torch.float32)
    for got, want in zip(*outs[::-1]):
        assert (got is None) == (want is None)
        if want is not None:
            assert torch.equal(got, want)


def test_without_autograd_it_is_f_conv2d():
    x, w, b, stride, padding = _inputs("transform_7x7_bias", torch.float32, True)
    w.requires_grad_()
    with torch.no_grad():
        y = conv2d(x, w, b, stride, padding)
    assert y.grad_fn is None
    assert torch.equal(y, F.conv2d(x.detach(), w.detach(), b, stride, padding))
    y = conv2d(x.detach(), w.detach(), b, stride, padding)  # nothing needs a gradient
    assert y.grad_fn is None


@pytest.mark.parametrize("case", list(CASES))
def test_card_rule_gives_atens_gradients(case):
    x, w, b, stride, padding = _inputs(case, torch.float32, True)
    x = x.detach()
    y = F.conv2d(x, w, b, stride, padding)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(2)).contiguous(
        memory_format=torch.channels_last)
    mask = (CASES[case][-1], True, b is not None)
    want = conv2d_backward(g, x, w, b is not None, stride, padding, mask)
    bias_sizes = [w.shape[0]] if b is not None else None

    def aten(m):
        return torch.ops.aten.convolution_backward(g, x, w, bias_sizes, [stride] * 2,
                                                   [padding] * 2, [1, 1], False, [0, 0], 1, m)

    torch.backends.cudnn.deterministic = False
    got = resnet._repeatable_backward(aten, g, x, w, stride, padding, mask)
    assert torch.backends.cudnn.deterministic is False
    for part, a, e in zip(("dx", "dw", "db"), got, want):
        assert (a is None) == (e is None), part
        if e is None:
            continue
        if (part == "dw" and w.shape[2:] == (1, 1)) or (
                part == "dx" and stride > 1 and w.shape[2:] != (1, 1)):
            # GEMMs, or the phases' forward convolutions, against ATen's
            # convolution backward: fp32 sums in another order
            torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-5 * float(e.abs().max()))
            assert a.shape == e.shape and a.dtype == e.dtype
        else:
            assert torch.equal(a, e), part


@pytest.mark.parametrize("stride", [1, 2])
def test_wgrad_1x1_gemm(stride):
    """Odd sizes (a stride-2 output of ceil(H/2) rows), both layouts, bf16;
    and additive over the halves of a batch, to the bit, with each image's
    rows in one run and in two (an odd batch of 5 as well)."""
    gen = torch.Generator().manual_seed(3)
    for channels_last in (True, False):
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            x = torch.randn(3, 24, 11, 9, generator=gen)
            w = torch.randn(40, 24, 1, 1, generator=gen)
            y = F.conv2d(x, w, stride=stride)
            g = torch.randn(y.shape, generator=gen)
            want = torch.ops.aten.convolution_backward(
                g, x, w, None, [stride] * 2, [0, 0], [1, 1], False, [0, 0], 1,
                [False, True, False])[1]
            if channels_last:
                x, g = (t.contiguous(memory_format=torch.channels_last) for t in (x, g))
            got = wgrad_1x1_gemm(g.to(dtype), x.to(dtype), stride)
            assert got.dtype == dtype and got.shape == w.shape
            torch.testing.assert_close(got.float(), want, rtol=tol,
                                       atol=tol * float(want.abs().max()))
    # 11x9 rows in one run, 2 * 64 x 70 rows (above 2 * WGRAD_MIN_ROWS) in two
    for h, w in ((11, 9), (64 * stride, 70 * stride)):
        x = torch.randn(4, 24, h, w, generator=gen)
        g = torch.randn(4, 40, *F.conv2d(x, torch.zeros(40, 24, 1, 1), stride=stride).shape[2:],
                        generator=gen)
        want = torch.ops.aten.convolution_backward(
            g, x, torch.zeros(40, 24, 1, 1), None, [stride] * 2, [0, 0], [1, 1], False, [0, 0],
            1, [False, True, False])[1]
        got = wgrad_1x1_gemm(g, x, stride)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
        halves = wgrad_1x1_gemm(g[:2], x[:2], stride) + wgrad_1x1_gemm(g[2:], x[2:], stride)
        assert torch.equal(got, halves)
        odd = wgrad_1x1_gemm(torch.cat([g, g[:1]]), torch.cat([x, x[:1]]), stride)
        assert torch.equal(odd, got + wgrad_1x1_gemm(g[:1], x[:1], stride))


# (N, Cin, H, W, Cout, kernel, stride, padding): the backbones' strided 3x3
# at odd and even sizes, the stem's 7x7, a stride of 3, an even kernel
PHASE_CASES = [(2, 8, 150, 150, 6, 3, 2, 1), (2, 8, 75, 75, 6, 3, 2, 1), (2, 8, 9, 7, 6, 3, 2, 1),
               (2, 3, 17, 15, 8, 7, 2, 3), (2, 8, 10, 11, 6, 3, 3, 1), (2, 5, 6, 6, 4, 4, 2, 1)]


@pytest.mark.parametrize("case", PHASE_CASES, ids=lambda c: "x".join(map(str, c)))
def test_dgrad_by_phases_equals_atens(case):
    n, cin, h, w, cout, k, stride, padding = case
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(n, cin, h, w, generator=gen).contiguous(memory_format=torch.channels_last)
    weight = torch.randn(cout, cin, k, k, generator=gen)
    g = torch.randn(F.conv2d(x, weight, stride=stride, padding=padding).shape, generator=gen)
    want = torch.ops.aten.convolution_backward(
        g, x, weight, None, [stride] * 2, [padding] * 2, [1, 1], False, [0, 0], 1,
        [True, False, False])[0]
    got = resnet.dgrad_by_phases(g, weight, stride, padding, x)
    assert got.shape == want.shape and got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_cudnn_flags_restored_on_error():
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    with pytest.raises(RuntimeError):
        with resnet._cudnn_deterministic():
            assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
            raise RuntimeError("inside")
    assert (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) == saved


def test_every_convolution_of_the_port_goes_through_conv2d():
    calls = []
    for path in sorted((ROOT / "os2d_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("conv2d", "conv_transpose2d", "convolution")
                    and not (isinstance(node.func.value, ast.Name)
                             and node.func.value.id == "self")):
                calls.append((path.relative_to(ROOT).as_posix(), node.lineno))
    # the forwards inside resnet.conv2d and its Function, and the phases of
    # dgrad_by_phases
    assert [p for p, _ in calls] == ["os2d_torch/models/resnet.py"] * 3, calls
