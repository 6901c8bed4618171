"""The int8 options of the port against the JAX package: int8 class banks
(`quantize_class_head`, cfg.tpu.quantize_class_feats) and the int8
resample tier (`resample_precision="int8"`), on the CPU, where the tier's
wrapper runs its plain version `int8_hat_resample_reference`; the CUDA
kernel (csrc/int8_hat_resample.cu) is held against that plain version on
the card by tests/test_torch_kernels_card.py and tests/test_torch_eval_card.py.

- `quantize_class_head`: int8 values equal to JAX's, scales within rtol
  1e-7; the dequantized bank equal.
- The plain version against JAX's `resample_correlation_from_pxpy(...,
  precision="int8")` at rtol 1e-5, atol 1e-6 (JAX sums each chunk of 8
  template points before adding it, and may contract a product into an
  FMA), on uniform coordinates, half-way hat weights (px, py at .5) and the
  map's border rows and columns; and the banded form the kernel computes
  equal to it to the bit.
- The head at "int8" against JAX's head at "int8" (cls atol 1e-5); with a
  graph recorded the head runs "default", as JAX's train mode does.
- The theta source (`resample_correlation_int8_theta`, the interior-first
  head's): its plain version equals the int8 form on the px/py of the
  head's former chain (written out here) to the bit, on identity,
  near-identity, random and outside-the-map theta and maps of width 1, 5,
  40 and 50; the head at "int8" with no graph hands the wrapper theta and
  never calls the coordinate function (no [B, C, T, A] px/py), and calls
  it at "default" and with a graph.
- `prescreen_margin("int8", ...)` equal to JAX's in both compute dtypes
  (tests/test_torch_numeric_modes.py holds the other tiers).
- A quantized bank through `Evaluator` equals its dequantized bank to the
  bit, is refused by the prescreen, and is dequantized up front over a
  mesh.
- `evaluate()` with cfg.tpu.quantize_class_feats at "highest" equals JAX's
  in mAP and detections (scores 1e-4, boxes 1e-2 px), without the prescreen.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from os2d_tpu.config import get_default_cfg as jax_cfg
from os2d_tpu.data.dataloader import DataloaderOneShotDetection as JaxLoader
from os2d_tpu.data.dataset import DatasetOneShotDetection as JaxDataset
from os2d_tpu.engine import evaluate as jeval
from os2d_tpu.models import head as jhead
from os2d_tpu.models import os2d as jos2d
from os2d_tpu.models.transform_net import init_transform_net_params
from os2d_tpu.ops.sampling import resample_correlation_from_pxpy
from os2d_torch.config import get_default_cfg
from os2d_torch.data.dataloader import DataloaderOneShotDetection
from os2d_torch.data.dataset import DatasetOneShotDetection
from os2d_torch.engine import evaluate as teval
from os2d_torch.models import Os2dConfig, Os2dModel, TransformNet
from os2d_torch.models import head as thead
from os2d_torch.models.from_jax import state_dict_from_jax, transform_net_state_dict_from_jax
from os2d_torch.ops.int8_resample import resample_correlation_int8, resample_correlation_int8_theta
from os2d_torch.ops.sampling import (
    INT8_ROW_SCALE,
    int8_hat_resample_reference,
    quantize_int8,
)
from os2d_torch.structures.feature_map import FeatureMapSize
from test_end_to_end_eval import IMG_W, make_synthetic_dataset

RTOL, ATOL = 1e-5, 1e-6
HEAD_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """These tests run many small torch ops; with one intra-op thread they
    do not wait on OpenMP barriers when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _class_maps(rng, f=64):
    return [rng.randn(h, w, f).astype(np.float32) for h, w in ((15, 15), (9, 12), (4, 5))]


def test_quantize_class_head_matches_jax():
    """On the same bank (JAX's, as numpy): the two packages' banks differ in
    the last bits, which may move a value across a rounding point."""
    rng = np.random.RandomState(0)
    j_head = jhead.build_class_head([jnp.asarray(m) for m in _class_maps(rng)])
    j_q = jhead.quantize_class_head(j_head)
    t_q = thead.quantize_class_head(thead.ClassHead(
        torch.from_numpy(np.array(j_head.class_feats)),
        torch.from_numpy(np.array(j_head.pool_mask))))
    assert t_q.class_feats_q.dtype == torch.int8 and t_q.scales.dtype == torch.float32
    np.testing.assert_array_equal(t_q.class_feats_q.numpy(), np.asarray(j_q.class_feats_q))
    np.testing.assert_allclose(t_q.scales.numpy(), np.asarray(j_q.scales), rtol=1e-7, atol=0)
    np.testing.assert_array_equal(t_q.pool_mask.numpy(), np.asarray(j_q.pool_mask))
    # every class uses its full int8 range at its absmax
    assert (t_q.class_feats_q.abs().amax(dim=(1, 2, 3)) == 127).all()
    np.testing.assert_allclose(thead.dequantize_class_head(t_q).class_feats.numpy(),
                               np.asarray(jhead.dequantize_class_head(j_q).class_feats),
                               rtol=1e-7, atol=0)


def _coords(kind, b, c, h, w, t, rng):
    a = h * w
    px = rng.uniform(0, w - 1, (b, c, t, a)).astype(np.float32)
    py = rng.uniform(0, h - 1, (b, c, t, a)).astype(np.float32)
    if kind == "half":  # half-way hat weights: 127 * 0.5 rounds half to even
        px = np.floor(px) + 0.5
        py = np.floor(py) + 0.5
        px[..., ::3] = np.minimum(px[..., ::3], w - 1)
    elif kind == "border":  # the first and last rows and columns, and integers
        px[:, :, :30], px[:, :, 30:60] = 0.0, w - 1.0
        py[:, :, 15:45], py[:, :, 45:75] = 0.0, h - 1.0
        px[:, :, 75:], py[:, :, 90:] = np.floor(px[:, :, 75:]), np.floor(py[:, :, 90:])
    return np.minimum(px, w - 1).astype(np.float32), np.minimum(py, h - 1).astype(np.float32)


INT8_CASES = [("uniform", 2, 3, 6, 7), ("half", 1, 2, 9, 11), ("border", 2, 2, 5, 8),
              ("uniform", 1, 2, 1, 7), ("border", 1, 2, 6, 1)]


@pytest.mark.parametrize("kind,b,c,h,w", INT8_CASES)
def test_int8_plain_matches_jax(kind, b, c, h, w):
    rng = np.random.RandomState(1)
    t = 121
    corr = np.tanh(rng.randn(b, c, h, w, 225)).astype(np.float32)
    px, py = _coords(kind, b, c, h, w, t, rng)
    mask = rng.rand(c, t).astype(np.float32)
    mask /= mask.sum(1, keepdims=True)
    want = np.asarray(resample_correlation_from_pxpy(
        jnp.asarray(corr[..., :t]), jnp.asarray(px), jnp.asarray(py), jnp.asarray(mask),
        precision="int8"))
    got = resample_correlation_int8(torch.from_numpy(corr)[..., :t], torch.from_numpy(px),
                                    torch.from_numpy(py), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def _banded_int8(corr, px, py, mask_t):
    """The int8 hat form on its non-zero weights only, as
    csrc/int8_hat_resample.cu computes it: corners quantized as read,
    r(x) = wq0*q[y0, x] + wq1*q[y0+1, x] in integers, then
    (r(x0)*K)*wx0 + (r(x0+1)*K)*wx1, acc += that * mask, t in order; a term
    whose row or column lies outside the map is left out."""
    b, c, h, w, _ = corr.shape
    f32 = torch.float32
    q = quantize_int8(corr[..., :px.shape[2]]).to(torch.int64).reshape(b, c, h * w, -1)

    def hat(p, i):
        return torch.clamp(1.0 - (p - i.to(f32)).abs(), min=0.0)

    acc = torch.zeros((b, c, h * w), dtype=f32)
    for t in range(px.shape[2]):
        x, y = px[:, :, t], py[:, :, t]
        x0, y0 = torch.floor(x).long(), torch.floor(y).long()
        zero = torch.zeros_like(x)

        def r(xi):
            total = torch.zeros_like(xi)
            for yi in (y0, y0 + 1):
                inside = (yi >= 0) & (yi < h)
                wq = torch.where(inside, torch.round(hat(y, yi) * 127.0), zero).to(torch.int64)
                idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
                total = total + wq * torch.gather(q[..., t], 2, idx)
            return total.to(f32) * torch.tensor(INT8_ROW_SCALE, dtype=f32)

        s = [torch.where((xi >= 0) & (xi < w), r(xi) * hat(x, xi), zero) for xi in (x0, x0 + 1)]
        acc = acc + (s[0] + s[1]) * mask_t[None, :, t, None]
    return acc.reshape(b, c, h, w)


@pytest.mark.parametrize("kind,b,c,h,w", INT8_CASES + [("outside", 1, 2, 6, 7)])
def test_int8_banded_form_equals_plain_to_the_bit(kind, b, c, h, w):
    rng = np.random.RandomState(2)
    t = 121
    corr = np.tanh(rng.randn(b, c, h, w, 225)).astype(np.float32)
    if kind == "outside":  # up to 0.5 outside each border
        px = rng.uniform(-0.5, w - 0.5, (b, c, t, h * w)).astype(np.float32)
        py = rng.uniform(-0.5, h - 0.5, (b, c, t, h * w)).astype(np.float32)
    else:
        px, py = _coords(kind, b, c, h, w, t, rng)
    mask = rng.rand(c, t).astype(np.float32)
    corr, px, py, mask = (torch.from_numpy(v) for v in (corr, px, py, mask))
    torch.testing.assert_close(_banded_int8(corr, px, py, mask),
                               int8_hat_resample_reference(corr[..., :t], px, py, mask),
                               rtol=0, atol=0)


def _former_head_coords(theta, anchor_boxes, h, w):
    """px, py [B, C, 121, A] as the interior-first head formed them before
    the int8 tier took theta (models/head.py of the previous release), from
    theta [B, C, A, 2, 3]."""
    from os2d_torch.ops.geometry import clip_jax_grad
    from os2d_torch.ops.sampling import linspace

    b, c, a = theta.shape[:3]
    ts = slice(2, 13)
    th6 = theta.reshape(b, c, 1, a, 2, 3)
    xs_int = linspace(-1.0, 1.0, 15)[ts]
    ys_int = linspace(-1.0, 1.0, 15)[ts]
    ux = xs_int.repeat_interleave(11)[None, None, :, None]
    uy = ys_int.repeat(11)[None, None, :, None]
    lx = th6[..., 0, 0] * ux + th6[..., 0, 1] * uy + th6[..., 0, 2]
    ly = th6[..., 1, 0] * ux + th6[..., 1, 1] * uy + th6[..., 1, 2]
    fb = anchor_boxes.reshape(1, 1, 1, a, 4)
    fx_a = (fb[..., 2] - fb[..., 0]) / 2.0
    fx_b = (fb[..., 2] + fb[..., 0]) / 2.0
    fy_a = (fb[..., 3] - fb[..., 1]) / 2.0
    fy_b = (fb[..., 3] + fb[..., 1]) / 2.0
    gx = clip_jax_grad((lx * fx_a + fx_b) / (w - 1) * 2.0 - 1.0, -1.0, 1.0)
    gy = clip_jax_grad((ly * fy_a + fy_b) / (h - 1) * 2.0 - 1.0, -1.0, 1.0)
    return (gx + 1.0) * 0.5 * (w - 1), (gy + 1.0) * 0.5 * (h - 1)


def _theta(kind, b, c, a, rng):
    theta = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), (b, c, a, 1))
    if kind == "near_identity":
        theta += (rng.rand(b, c, a, 6).astype(np.float32) - 0.5) * 0.1
    elif kind == "random":
        theta = rng.uniform(-1, 1, (b, c, a, 6)).astype(np.float32)
    elif kind == "outside":  # translations of up to 3 box half-widths: many clipped samples
        theta[..., 2] += rng.uniform(-3, 3, (b, c, a)).astype(np.float32)
        theta[..., 5] += rng.uniform(-3, 3, (b, c, a)).astype(np.float32)
    return theta


THETA_CASES = [(kind, b, c, h, w) for kind in ("identity", "near_identity", "random", "outside")
               for b, c, h, w in ((1, 2, 3, 1), (1, 2, 2, 5), (1, 1, 2, 40), (1, 1, 2, 50))]


@pytest.mark.parametrize("kind,b,c,h,w", THETA_CASES)
def test_int8_theta_plain_equals_the_former_pxpy_path(kind, b, c, h, w):
    from os2d_torch.ops.sampling import linspace
    from os2d_torch.structures.boxes import strided_anchor_grid

    rng = np.random.RandomState(4)
    a = h * w
    corr = torch.from_numpy(np.tanh(rng.randn(b, c, h, w, 225)).astype(np.float32))
    theta = torch.from_numpy(_theta(kind, b, c, a, rng))
    mask = torch.from_numpy(rng.rand(c, 121).astype(np.float32))
    boxes = strided_anchor_grid(w, h, 15.0, 15.0, 1.0, 1.0)
    lattice = torch.stack([linspace(-1.0, 1.0, 15)[2:13]] * 2)
    px, py = _former_head_coords(theta.reshape(b, c, a, 2, 3), boxes, h, w)
    want = int8_hat_resample_reference(corr[..., :121], px.contiguous(), py.contiguous(), mask)
    got = resample_correlation_int8_theta(corr[..., :121], theta, boxes, lattice, mask)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_head_int8_hands_the_kernel_theta(monkeypatch):
    """No graph at "int8": the wrapper gets theta [B, C, A, 6] and the
    head's coordinate function (the [B, C, T, A] px/py) is not called; at
    "default", and at "int8" with a graph, it is called once."""
    fm, maps, _, net = _head_inputs()
    head = thead.build_class_head([torch.from_numpy(m) for m in maps])
    fm = torch.from_numpy(fm)
    coords, thetas = [], []
    original_coords = thead.interior_sample_coords
    original_int8 = thead.resample_correlation_int8_theta

    def counted_coords(*args):
        coords.append(args[0].shape)
        return original_coords(*args)

    def recorded_int8(corr, theta, *args):
        thetas.append(tuple(theta.shape))
        return original_int8(corr, theta, *args)

    monkeypatch.setattr(thead, "interior_sample_coords", counted_coords)
    monkeypatch.setattr(thead, "resample_correlation_int8_theta", recorded_int8)
    with torch.no_grad():
        out = thead.head_forward(net, fm, head, resample_precision="int8")
    b, h, w, _ = fm.shape
    assert coords == [] and thetas == [(b, len(maps), h * w, 6)]
    assert out["cls"].shape == (b, len(maps), h * w)
    with torch.no_grad():
        thead.head_forward(net, fm, head, resample_precision="default")
    assert len(coords) == 1
    net.requires_grad_(True)
    thead.head_forward(net, fm, head, resample_precision="int8")
    assert len(coords) == 2 and len(thetas) == 1


def _tn_params(seed):
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        np.asarray, init_transform_net_params(jax.random.PRNGKey(seed), 6))
    params["linear"]["w"] = (0.02 * rng.randn(*params["linear"]["w"].shape)).astype(np.float32)
    return params


def _head_inputs(seed=3, b=2, h=6, w=7, f=64):
    rng = np.random.RandomState(seed)
    fm = rng.randn(b, h, w, f).astype(np.float32)
    maps = _class_maps(rng, f)
    params = _tn_params(seed + 1)
    net = TransformNet(6, device="cpu")
    net.load_state_dict(transform_net_state_dict_from_jax(params))
    return fm, maps, params, net


@pytest.mark.parametrize("interior_first", [True, False])
def test_head_int8_matches_jax(interior_first):
    fm, maps, params, net = _head_inputs()
    want = jhead.head_forward(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(fm),
        jhead.build_class_head([jnp.asarray(m) for m in maps]), resample_precision="int8",
        corr_interior_first=interior_first)
    with torch.no_grad():
        got = thead.head_forward(net, torch.from_numpy(fm),
                                 thead.build_class_head([torch.from_numpy(m) for m in maps]),
                                 resample_precision="int8",
                                 corr_interior_first=interior_first)
    for key, rtol in (("loc", 0.0), ("cls", 0.0), ("corners", 1e-5)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=HEAD_ATOL,
                                   rtol=rtol, err_msg=key)


def test_head_int8_with_a_graph_runs_default():
    fm, maps, _, net = _head_inputs()
    head = thead.build_class_head([torch.from_numpy(m) for m in maps])
    fm = torch.from_numpy(fm)
    net.requires_grad_(True)
    outs = {p: thead.head_forward(net, fm, head, resample_precision=p)
            for p in ("int8", "default")}
    assert outs["int8"]["cls"].requires_grad
    for key in ("cls", "cls_detached", "loc"):
        torch.testing.assert_close(outs["int8"][key], outs["default"][key], rtol=0, atol=0)
    with torch.no_grad():
        eval_int8 = thead.head_forward(net, fm, head, resample_precision="int8")
    assert not torch.equal(eval_int8["cls"], outs["default"]["cls"])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_int8_prescreen_margin_matches_jax(compute_dtype):
    assert teval.prescreen_margin("int8", compute_dtype) == jeval.prescreen_margin(
        "int8", jnp.dtype(compute_dtype))


def _cpu_model(precision="highest"):
    return Os2dModel(Os2dConfig(resample_precision=precision), device="cpu", seed=0)


def test_quantized_bank_through_evaluator_equals_dequantized():
    rng = np.random.RandomState(4)
    model = _cpu_model("int8")
    cfg = get_default_cfg()
    cfg.tpu.eval_class_chunk = 2
    cfg.tpu.eval_pre_top_k = 64
    cfg.tpu.eval_top_k = 8
    ev = teval.Evaluator(model, cfg)
    classes = [rng.randn(64, 64, 3).astype(np.float32) for _ in range(3)]
    head, _ = ev.build_class_heads(classes)
    qhead = thead.quantize_class_head(head)
    deq = thead.dequantize_class_head(qhead)
    images = rng.randint(0, 255, (1, 96, 128, 3), np.uint8)
    norm = {"mean": model.config.normalization_mean, "std": model.config.normalization_std}
    sizes = [FeatureMapSize(w=128, h=96), FeatureMapSize(w=96, h=72)]
    inv = [(1.0, 1.0), (128 / 96, 96 / 72)]
    got = ev.detect_images(images, qhead, sizes, inv, norm)
    want = ev.detect_images(images, deq, sizes, inv, norm)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    pyramid = [np.asarray(rng.randn(1, 64, 80, 3), np.float32)]
    got = ev.score_pyramid(pyramid, qhead, want_corners=True)[0]
    want = ev.score_pyramid(pyramid, deq, want_corners=True)[0]
    for key in ("loc", "cls", "corners"):
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
    cfg.eval.nms_score_threshold = 0.5
    assert ev.prescreen_applicable(deq) and not ev.prescreen_applicable(qhead)
    with pytest.raises(ValueError, match="QuantizedClassHead"):
        ev.detect_images_prescreened(images, qhead, sizes, inv, norm)
    # over a mesh the bank is dequantized up front, as JAX's class shards
    # move fp32 chunks; on one device it stays int8
    from os2d_torch.parallel import Mesh

    assert ev._bank(qhead) is qhead
    meshed = teval.Evaluator(model, cfg, mesh=Mesh(None, 0, 2, torch.device("cpu")))._bank(qhead)
    assert isinstance(meshed, thead.ClassHead)
    torch.testing.assert_close(meshed.class_feats, deq.class_feats, rtol=0, atol=0)


@pytest.fixture(scope="module")
def loaders(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_int8"))
    df = make_synthetic_dataset(root)
    kwargs = dict(gt_path=os.path.join(root, "classes", "images"),
                  image_path=os.path.join(root, "src"), name="synth-int8",
                  image_size=IMG_W, eval_scale=IMG_W, cache_images=True)
    jax_loader = JaxLoader(dataset=JaxDataset(df, **kwargs), batch_size=1,
                           pyramid_scales_eval=[1.0], do_augmentation=False)
    loader = DataloaderOneShotDetection(dataset=DatasetOneShotDetection(df, **kwargs),
                                        batch_size=1, pyramid_scales_eval=[1.0])
    return jax_loader, loader


def _eval_cfg(cfg, save_dir):
    cfg.eval.mAP_iou_thresholds = [0.5]
    cfg.eval.nms_score_threshold = 0.5  # finite: the prescreen would run on an fp32 bank
    cfg.tpu.quantize_class_feats = True
    cfg.tpu.eval_class_chunk = 4
    cfg.tpu.eval_pre_top_k = 256
    cfg.tpu.eval_top_k = 32
    cfg.visualization.eval.path_to_save_detections = str(save_dir)
    return cfg


def test_evaluate_quantized_bank_matches_jax(loaders, tmp_path):
    jax_loader, loader = loaders
    jconfig = jos2d.Os2dConfig(resample_precision="highest")
    params = jos2d.init_os2d_params(jax.random.PRNGKey(0), jconfig)
    want = jeval.evaluate(jax_loader, jos2d.Os2dModel(jconfig), params,
                          _eval_cfg(jax_cfg(), tmp_path / "jax"))
    model = _cpu_model()
    model.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    got = teval.evaluate(loader, model, _eval_cfg(get_default_cfg(), tmp_path / "torch"))

    assert want["mAP@0.50"] == 1.0
    assert "prescreen_pruned" not in got
    for key in ("mAP@0.50", "mAPw@0.50", "recall@0.50", "AP_joint_classes@0.50"):
        assert got[key] == want[key], (key, got[key], want[key])
    name = f"{loader.get_name()}_detections.pkl"
    dets = {}
    for side in ("jax", "torch"):
        with open(tmp_path / side / name, "rb") as f:
            dets[side] = pickle.load(f)
    assert dets["torch"]["image_ids"] == dets["jax"]["image_ids"]
    for i in range(len(dets["jax"]["image_ids"])):
        np.testing.assert_array_equal(dets["torch"]["labels"][i], dets["jax"]["labels"][i])
        np.testing.assert_allclose(dets["torch"]["scores"][i], dets["jax"]["scores"][i],
                                   atol=1e-4)
        np.testing.assert_allclose(dets["torch"]["boxes_xyxy"][i],
                                   dets["jax"]["boxes_xyxy"][i], atol=1e-2)
