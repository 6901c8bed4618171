"""The training path's small parts against the JAX package, on the CPU, from
numpy seeds:

- `clip_to_min_size`: the values, and the gradient with JAX's detach of x1 in
  the clamped branch (exact: the function only selects and adds);
- `match_anchors`, `encode_targets` and `remap_targets` on a seeded batch with
  padded GT, difficult boxes, a label with no GT and degenerate predictions:
  exact equality of the class targets and remapped targets, the loc targets
  within one ulp (rtol 1e-6) and the IoU maps within atol 1e-6;
- `compute_objective`: the losses and their gradients by the loc and cls
  predictions (and the detached-transform scores) for RLL and the
  contrastive loss, with and without cls_preds_for_neg and remapped targets:
  rtol 1e-5, atol 1e-6 (fp32 sums over the anchors in another order);
- the optimizers: one and three updates of each method against optax on a
  random parameter set (rtol 1e-5, atol 1e-7: one fp32 rounding order per
  update), frozen parameters left alone;
- the LR schedules of `setup_lr` against JAX's, call for call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from os2d_tpu.config import get_default_cfg as jax_default_cfg
from os2d_tpu.engine import objective as jobj
from os2d_tpu.engine import optimization as jopt
from os2d_tpu.engine import targets as jtargets
from os2d_tpu.structures import boxes as jboxes
from os2d_torch.config import get_default_cfg
from os2d_torch.engine.decode import default_boxes_for_image_size
from os2d_torch.engine import objective as tobj
from os2d_torch.engine import optimization as topt
from os2d_torch.engine import targets as ttargets
from os2d_torch.structures import boxes as tboxes
from os2d_torch.structures.feature_map import FeatureMapSize

RTOL, ATOL = 1e-5, 1e-6


def test_clip_to_min_size_value_and_gradient_match_jax():
    rng = np.random.RandomState(0)
    boxes = rng.rand(64, 4).astype(np.float32) * 10
    boxes[:20, 2] = boxes[:20, 0] + rng.rand(20).astype(np.float32) * 0.5  # too narrow
    boxes[10:30, 3] = boxes[10:30, 1] + rng.rand(20).astype(np.float32) * 0.5  # too short
    cot = rng.randn(64, 4).astype(np.float32)
    want, vjp = jax.vjp(lambda b: jboxes.clip_to_min_size(b, 1.0), jnp.asarray(boxes))
    (want_grad,) = vjp(jnp.asarray(cot))
    bt = torch.from_numpy(boxes).requires_grad_(True)
    got = tboxes.clip_to_min_size(bt, 1.0)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(bt.grad.numpy(), np.asarray(want_grad))
    assert (bt.grad.numpy()[:20, 0] == 0).all()  # the clamped x1 is detached


def _gt_batch(rng, b, g_pad, img=320.0):
    """Padded GT: a few valid boxes per image, some difficult, labels in
    [0, 3), padding rows with label -1."""
    boxes = np.zeros((b, g_pad, 4), np.float32)
    labels = np.full((b, g_pad), -1, np.int32)
    difficult = np.zeros((b, g_pad), bool)
    valid = np.zeros((b, g_pad), bool)
    for i in range(b):
        n = 2 + i
        xy = rng.rand(n, 2) * img * 0.6
        wh = 150 + rng.rand(n, 2) * 150
        boxes[i, :n] = np.concatenate([xy, np.minimum(xy + wh, img)], 1)
        labels[i, :n] = rng.randint(0, 3, n)
        difficult[i, :n] = rng.rand(n) < 0.3
        valid[i, :n] = True
    return boxes, labels, difficult, valid


def test_targets_and_remap_match_jax():
    rng = np.random.RandomState(1)
    num_labels, b, g_pad = 4, 3, 8  # label 3 has no GT anywhere
    gt = _gt_batch(rng, b, g_pad)
    default_boxes = np.array(jtargets_default_boxes(320))
    np.testing.assert_array_equal(
        default_boxes_for_image_size(FeatureMapSize(w=320, h=320)).numpy(),
        default_boxes)
    a = default_boxes.shape[0]
    loc_t_j, cls_t_j = jax.vmap(
        lambda gb, gl, gd, gv: jtargets.encode_targets_single_image(
            gb, gl, gd, gv, jnp.asarray(default_boxes), num_labels, 0.5, 0.1))(
        *[jnp.asarray(x) for x in gt])
    loc_t, cls_t = ttargets.encode_targets(*[torch.from_numpy(x) for x in gt],
                                           torch.from_numpy(default_boxes), num_labels, 0.5, 0.1)
    np.testing.assert_array_equal(cls_t.numpy(), np.asarray(cls_t_j))
    # the SSD encoding's divisions and logs round alike but for one ulp where
    # XLA fuses them (2% of the entries, 1.2e-7)
    np.testing.assert_allclose(loc_t.numpy(), np.asarray(loc_t_j), rtol=1e-6, atol=1e-7)
    assert set(np.unique(cls_t.numpy())) == {-1, 0, 1}

    loc_p = (rng.randn(b, num_labels, 4, a) * 0.5).astype(np.float32)
    loc_p[0, 0, 2:, :10] = -40.0  # degenerate (tiny) predicted boxes
    want = jtargets.remap_targets(jnp.asarray(loc_p), *[jnp.asarray(x) for x in gt],
                                  jnp.asarray(default_boxes), 0.8, 0.4)
    got = ttargets.remap_targets(torch.from_numpy(loc_p), *[torch.from_numpy(x) for x in gt],
                                 torch.from_numpy(default_boxes), 0.8, 0.4)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for x, y in zip(got[1:], want[1:]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6)


def jtargets_default_boxes(size):
    from os2d_tpu.engine.train import default_boxes_for_size
    from os2d_tpu.structures.feature_map import FeatureMapSize

    return default_boxes_for_size(FeatureMapSize(w=size, h=size))


def test_match_anchors_matches_jax():
    rng = np.random.RandomState(2)
    ious = rng.rand(5, 40).astype(np.float32)
    ious[1, :8] = ious[3, :8]  # ties: the first row wins
    valid = np.array([True, True, False, True, True])
    difficult = np.array([False, True, False, False, True])
    want = jboxes.match_anchors(jnp.asarray(ious), jnp.asarray(valid), jnp.asarray(difficult),
                                0.5, 0.1)
    got = tboxes.match_anchors(torch.from_numpy(ious), torch.from_numpy(valid),
                               torch.from_numpy(difficult), 0.5, 0.1)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def _objective_inputs(seed, b=2, l=3, a=50):
    rng = np.random.RandomState(seed)
    loc_p = rng.randn(b, l, 4, a).astype(np.float32)
    loc_t = rng.randn(b, l, 4, a).astype(np.float32)
    cls_p = np.tanh(rng.randn(b, l, a)).astype(np.float32)
    cls_p[0, 0, :4] = [0.5, 0.6, 0.5, 0.6]  # on the hinges' ties
    cls_det = np.tanh(rng.randn(b, l, a)).astype(np.float32)
    cls_t = rng.choice([-1, 0, 1], (b, l, a), p=[0.2, 0.6, 0.2]).astype(np.int32)
    cls_r = rng.choice([-1, 0, 1], (b, l, a), p=[0.2, 0.6, 0.2]).astype(np.int32)
    return loc_p, loc_t, cls_p, cls_det, cls_t, cls_r


OBJECTIVE_CASES = [("RLL", True, True), ("RLL", False, False), ("RLL", True, False),
                   ("ContrastiveLoss", True, True), ("ContrastiveLoss", False, False)]


@pytest.mark.parametrize("class_loss,for_neg,remap", OBJECTIVE_CASES)
def test_objective_and_gradients_match_jax(class_loss, for_neg, remap):
    loc_p, loc_t, cls_p, cls_det, cls_t, cls_r = _objective_inputs(seed=3)

    def jloss(lp, cp, cd):
        losses, _ = jobj.compute_objective(
            jobj.ObjectiveConfig(class_loss=class_loss), lp, jnp.asarray(loc_t), cp,
            jnp.asarray(cls_t), cls_targets_remapped=jnp.asarray(cls_r) if remap else None,
            cls_preds_for_neg=cd if for_neg else None)
        return losses["loss"], losses

    (_, want), grads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(loc_p), jnp.asarray(cls_p), jnp.asarray(cls_det))
    lp, cp, cd = (torch.from_numpy(x).requires_grad_(True) for x in (loc_p, cls_p, cls_det))
    got = tobj.compute_objective(
        tobj.ObjectiveConfig(class_loss=class_loss), lp, torch.from_numpy(loc_t), cp,
        torch.from_numpy(cls_t), cls_targets_remapped=torch.from_numpy(cls_r) if remap else None,
        cls_preds_for_neg=cd if for_neg else None)
    got["loss"].backward()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    for name, x, y in zip(("loc", "cls", "cls_for_neg"), (lp, cp, cd), grads):
        gx = np.zeros_like(np.asarray(y)) if x.grad is None else x.grad.numpy()
        np.testing.assert_allclose(gx, np.asarray(y), rtol=RTOL, atol=ATOL, err_msg=name)


OPTIMIZERS = ["sgd", "adagrad", "adadelta", "adam", "adamax", "rmsprop"]


@pytest.mark.parametrize("method", OPTIMIZERS)
def test_optimizer_updates_match_optax(method):
    rng = np.random.RandomState(4)
    shapes = {"a": (5, 3), "b": (7,), "frozen": (4,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]
    cfg = jax_default_cfg().train.optim
    cfg.optim_method = method
    cfg.lr = 0.01
    mask = {"a": True, "b": True, "frozen": False}
    tx = jopt.create_optimizer(cfg, mask)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    tcfg = get_default_cfg().train.optim
    tcfg.optim_method, tcfg.lr = method, 0.01
    opt = topt.create_optimizer(tcfg, [tp[k] for k in shapes if mask[k]])
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k in shapes:
            tp[k].grad = torch.from_numpy(g[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=RTOL,
                                       atol=1e-7, err_msg=f"{method} {k}")
    np.testing.assert_array_equal(tp["frozen"].detach().numpy(), params["frozen"])
    assert topt.get_learning_rate(opt) == pytest.approx(jopt.get_learning_rate(state))
    topt.set_learning_rate(opt, 0.5)
    assert topt.get_learning_rate(opt) == 0.5


SCHEDULES = [
    {"type": "none"},
    {"type": "MultiStepLR", "milestones": [2, 5], "gamma": 0.1},
    {"type": "ReduceLROnPlateau", "patience": 2, "cooldown": 1, "quantity_smoothness": 2,
     "reduce_factor": 0.5, "min_value": 1e-4, "quantity_to_monitor": "mAP"},
]


@pytest.mark.parametrize("schedule", SCHEDULES, ids=[s["type"] for s in SCHEDULES])
def test_lr_schedules_match_jax(schedule):
    jcfg = jax_default_cfg().train.optim.anneal_lr
    tcfg = get_default_cfg().train.optim.anneal_lr
    for c in (jcfg, tcfg):
        for k, v in schedule.items():
            c[k] = v
    rng = np.random.RandomState(5)
    jlog, tlog = {"mAP": []}, {"mAP": []}
    janneal = jopt.setup_lr(jlog, jcfg, eval_iter=1)
    tanneal = topt.setup_lr(tlog, tcfg, eval_iter=1)
    jlr = tlr = 0.1
    lrs = []
    for i in range(12):
        value = float(rng.rand() if i < 3 else 0.5)  # then a plateau
        jlog["mAP"].append(value)
        tlog["mAP"].append(value)
        jlr = janneal(i + 1, jlr, anneal_now=i > 0)
        tlr = tanneal(i + 1, tlr, anneal_now=i > 0)
        assert tlr == jlr
        lrs.append(tlr)
    if schedule["type"] != "none":
        assert lrs[-1] < 0.1  # the schedule did anneal
