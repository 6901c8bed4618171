"""The port's training path on the card, held against the CPU: the first
step at the default recipe (fp32, bf16, the grid path, GroupNorm, the
yuv420 wire), the backward kernel on the first step's own inputs,
trainval_loop, the convolutions' repeatable gradients, hard-patch mining,
mining inside trainval_loop with the device class cache, the cache itself,
the data-parallel mesh on one card and the checkpoint backends.

Without a card every test here skips. The file imports no JAX:

    python -m pytest --noconftest tests/test_torch_train_card.py -q

The data is tests/torch_card_scenes.py's planted training set, written
under a temporary directory by a fixture; the recipe is get_default_cfg()'s
with `Os2dConfig()` at full width. Random weights score every anchor above
the recipe's margin_pos 0.6, which leaves the cls gradient (the backward
kernel's dpx/dpy) zero, so the steps held against the CPU take RLL's
margin_pos at 1.0.
"""

import os

import numpy as np
import pytest
import torch

import torch_card_scenes as scenes_mod
from torch_card_scenes import (
    FIRST_STEP_MARGIN_POS,
    TRAIN_CLASSES,
    TRAIN_CPU_RTOL,
    TRAIN_IMAGES,
    TRAIN_STEPS,
    Launches,
    first_step,
    relative_errors,
    train_cfg,
    twin,
)

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1e-5, 1e-6  # the backward kernel against its plain version
TRAIN_EVAL_IMAGES = 2
# a whole train step's scalars at bf16 carry decorrelated rounding noise:
# |card - CPU| within BF16_STEP_RULE x |CPU bf16 - CPU fp32|, or within the
# fp32 tolerance where bf16 moves a scalar less than the devices differ
BF16_STEP_RULE = 3.0
WIRE_LOSS_RTOL = 2e-2  # the yuv420 first loss against rgb8's
GN_SLOTS = 43  # ResNet50-C4's norm slots
MINING_CPU_IMAGES, MINING_ATOL = 2, 1e-6
MINE_ITER = 2
CACHE_CHECK_BATCHES = 8
DIST_STEPS, DIST_SEED = 3, 2
DIST_LOSS_RTOL, DIST_PARAM_RTOL, DIST_PARAM_ATOL = 2e-5, 1e-4, 1e-6
DIST_SCORE_ATOL, DIST_BOX_ATOL = 1e-5, 1e-2
DIST_TIMEOUT_S = 300
# what prepare_batch_arrays reads of a train batch, sent to the ranks
DIST_BATCH_KEYS = ("images", "class_images", "class_ids", "gt_boxes", "gt_labels",
                   "gt_difficult", "gt_valid", "img_size")


@pytest.fixture(scope="module")
def train_set(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return scenes_mod.train_dataset(str(tmp_path_factory.mktemp("train")))


@pytest.fixture(scope="module")
def train_loader(train_set):
    from os2d_torch.data.dataloader import build_train_dataloader_from_config

    return build_train_dataloader_from_config(train_cfg(), train_set, seed=0)[0]


@pytest.fixture(scope="module")
def train_batch(train_loader):
    return train_loader.get_batch(0)


@pytest.fixture(scope="module")
def first_steps(train_batch):
    """The first step of seed-1 weights on the card and on the CPU, with the
    card's backward-kernel inputs captured."""
    from os2d_torch.models import Os2dConfig, Os2dModel
    from os2d_torch.ops import resample_grad

    card = Os2dModel(Os2dConfig(), seed=1)
    cpu = twin(card)
    captured = []
    original = resample_grad.resample_correlation_backward

    def capture(*args):
        captured.append(tuple(x.detach() for x in args))
        return original(*args)

    resample_grad.resample_correlation_backward = capture
    try:
        with Launches() as launched:
            metrics = first_step(card, train_cfg(), train_batch)
    finally:
        resample_grad.resample_correlation_backward = original
    return {"cuda": metrics, "cpu": first_step(cpu, train_cfg(), train_batch),
            "launches": launched, "backward_inputs": captured, "model": card}


def _assert_first_step(card, cpu, launched, rtol=TRAIN_CPU_RTOL):
    assert all(np.isfinite(v) for v in card.values()), card
    assert card["cls_RLL_pos"] > 0  # a positive below margin_pos: the cls gradient is not zero
    err = relative_errors(card, cpu)
    assert err["loss"] <= rtol and err["grad_norm"] <= rtol, (card, cpu)
    assert launched["hat"] == 1 and launched["backward"] == 1, launched


# ---- the first step ----

def test_first_step_matches_the_cpu(first_steps, record_property):
    """The first TrainStep at the default recipe on the card and the CPU
    from the same weights and batch: loss and gradient norm within rtol
    2e-3 (fp32 convolutions and their backward in another order, the bf16
    hat forward on both), a positive RLL loss, one launch of the hat and of
    the backward kernel, and a non-zero cls cotangent."""
    record_property("launches", dict(first_steps["launches"]))  # chip_smoke.py's kernels line
    _assert_first_step(first_steps["cuda"], first_steps["cpu"], first_steps["launches"])
    assert len(first_steps["backward_inputs"]) == 1
    assert float(first_steps["backward_inputs"][0][0].abs().max()) > 0


def test_backward_kernel_on_the_first_steps_inputs(first_steps):
    """The backward kernel on the inputs the first step passed it: dcorr,
    dpx and dpy at rtol 1e-5 and atol 1e-6 times each part's largest
    magnitude (the step's gradients are small), no part all zeros (it would
    hold the kernel to nothing); two calls equal to the bit."""
    from os2d_torch.ops import resample_grad
    from os2d_torch.ops.sampling import resample_backward_reference

    inputs = first_steps["backward_inputs"][0]
    got = resample_grad.resample_correlation_backward(*inputs)
    again = resample_grad.resample_correlation_backward(*inputs)
    want = resample_backward_reference(*inputs, inputs[3].shape[2])
    for part, x, y, z in zip(("dcorr", "dpx", "dpy"), got, want, again):
        scale = float(y.abs().max())
        assert scale > 0, part
        torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL * scale,
                                   msg=lambda m: f"{part}: {m}")
        assert torch.equal(x, z), part


def test_first_step_at_bf16_matches_the_cpu(first_steps, train_batch):
    """The first step with compute_dtype bfloat16, card against CPU: loss and
    gradient norm within BF16_STEP_RULE x |CPU bf16 - CPU fp32| or the fp32
    rtol, whichever is larger; one launch of each kernel."""
    from os2d_torch.models import Os2dConfig, Os2dModel

    card = Os2dModel(Os2dConfig(compute_dtype="bfloat16"), seed=1)
    cpu = twin(card)
    with Launches() as launched:
        got = first_step(card, train_cfg(), train_batch)
    want, want32 = first_step(cpu, train_cfg(), train_batch), first_steps["cpu"]
    assert all(np.isfinite(v) for v in got.values()), got
    for k in ("loss", "grad_norm"):
        bound = max(BF16_STEP_RULE * abs(want[k] - want32[k]), TRAIN_CPU_RTOL * abs(want[k]))
        assert abs(got[k] - want[k]) <= bound, (k, got[k], want[k], want32[k])
    assert launched["hat"] == 1 and launched["backward"] == 1, launched


@pytest.mark.parametrize("option", ["grid", "group_norm"])
def test_first_step_of_a_model_option_matches_the_cpu(option, train_batch, record_property):
    """The first step of seed-1 weights with corr_interior_first=False or
    use_group_norm=True, card against CPU as the default's; under GroupNorm
    (eager at first sight) the forward and the backward kernels once per
    slot and pass, 2 x 43 each."""
    from os2d_torch.models import Os2dConfig, Os2dModel

    config = (Os2dConfig(corr_interior_first=False) if option == "grid"
              else Os2dConfig(use_group_norm=True))
    card = Os2dModel(config, seed=1)
    cpu = twin(card)
    with Launches() as launched:
        got = first_step(card, train_cfg(), train_batch)
    record_property("launches", dict(launched))  # chip_smoke.py's kernels line
    _assert_first_step(got, first_step(cpu, train_cfg(), train_batch), launched)
    if option == "group_norm":
        assert launched["gn_forward"] == launched["gn_backward"] == 2 * GN_SLOTS, launched


def test_first_step_through_the_yuv420_wire(train_batch):
    """The first step through the yuv420 wire: prepare_batch_arrays uploads
    the packed wire, the loss within WIRE_LOSS_RTOL of rgb8's on the card,
    loss and gradient norm within rtol 2e-3 of the CPU's yuv420 step; one
    launch of the hat and of the backward kernel."""
    from os2d_torch.engine.train import prepare_batch_arrays
    from os2d_torch.models import Os2dConfig, Os2dModel
    from os2d_torch.ops.pixel_format import PackedYuv420

    start = Os2dModel(Os2dConfig(), seed=1)
    arrays, _ = prepare_batch_arrays(train_batch, start.device, pixel_format="yuv420")
    assert isinstance(arrays["images"], PackedYuv420)
    rgb8 = first_step(twin(start, device="cuda"), train_cfg(), train_batch, "rgb8")
    with Launches() as launched:
        yuv = first_step(twin(start, device="cuda"), train_cfg(), train_batch, "yuv420")
    cpu = first_step(twin(start), train_cfg(), train_batch, "yuv420")
    assert abs(yuv["loss"] - rgb8["loss"]) / rgb8["loss"] <= WIRE_LOSS_RTOL
    _assert_first_step(yuv, cpu, launched)


# ---- trainval_loop and the repeatable gradients ----

@pytest.fixture(scope="module")
def trained(train_set, train_loader):
    """trainval_loop at the recipe from seed-1 weights: TRAIN_STEPS steps and
    an eval with the objective as criterion before and after them, on
    TRAIN_EVAL_IMAGES images of the train set."""
    from os2d_torch.data.dataloader import DataloaderOneShotDetection
    from os2d_torch.engine.objective import ObjectiveConfig
    from os2d_torch.engine.optimization import create_optimizer
    from os2d_torch.engine.train import trainable_parameters, trainval_loop
    from os2d_torch.models import Os2dConfig, Os2dModel

    cfg = train_cfg()
    model = Os2dModel(Os2dConfig(), seed=1)
    watched = ("backbone.conv1.weight", "backbone.layer3.5.conv3.weight",
               "transform_net.linear.weight", "backbone.layer1.0.bn1.running_var")
    before = {k: model.state_dict()[k].clone() for k in watched}
    eval_loader = DataloaderOneShotDetection(train_set.copy_subset(TRAIN_EVAL_IMAGES),
                                             batch_size=1, pyramid_scales_eval=[1.0])
    optimizer = create_optimizer(cfg.train.optim, trainable_parameters(model, cfg.train))
    with Launches() as launched:
        log, _ = trainval_loop(train_loader, model, cfg, ObjectiveConfig(), optimizer,
                               dataloaders_eval=[eval_loader])
    moved = {k: float((model.state_dict()[k] - before[k]).abs().max()) for k in watched}
    return {"model": model, "optimizer": optimizer, "log": log, "launches": launched,
            "moved": moved, "eval_name": eval_loader.get_name()}


def test_trainval_loop_trains_at_the_default_recipe(trained):
    """trainval_loop's losses, gradient norms and eval losses are finite,
    the watched parameters moved, and each step launched the backward kernel
    once and the hat kernel at least once."""
    log = trained["log"]
    for k in ("train_loss", "train_grad_norm", f"loss_{trained['eval_name']}"):
        values = [v for v in log.get(k, []) if not np.isnan(v)]
        assert values and np.isfinite(values).all(), (k, log.get(k))
    assert all(v > 0 for v in trained["moved"].values()), trained["moved"]
    assert trained["launches"]["backward"] == TRAIN_STEPS
    assert trained["launches"]["hat"] >= TRAIN_STEPS


def test_every_convolution_of_a_train_step_repeats_under_the_ports_rule():
    """Every distinct convolution of one step at the default recipe's shapes
    (tools/trace_conv_determinism_torch.py): its input and weight gradients
    twice under the port's rule (models/resnet.py: conv2d_backward), equal
    to the bit."""
    from tools import trace_conv_determinism_torch as conv_trace

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, summary = conv_trace.trace("train", conv_trace.capture_train_step(), repeats=2,
                                  settings=("default", "port"), kernel_names=False, emit=None)
    assert summary["distinct"] > 0
    assert not any(summary["not_repeating"]["port"].values()), summary["not_repeating"]


# ---- mining and the device class cache ----

def test_mining_matches_the_cpu(train_set):
    """mine_hard_patches at get_default_cfg()'s mining recipe (2 random
    pyramid scales, all 16 classes as negatives, 10 patches an image, NMS
    IoU 0.5) at the default tier, seed-2 weights: on MINING_CPU_IMAGES
    images the card's records equal the CPU's (ids, order, roles, levels,
    labels, anchors, boxes exactly; losses and scores within rtol 2e-3, atol
    1e-6); on every image, records of both roles, finite values, and the hat
    kernel once per (batch, level, class chunk)."""
    from os2d_torch.config import get_default_cfg
    from os2d_torch.data.dataloader import build_train_dataloader_from_config
    from os2d_torch.engine.mining import mine_hard_patches
    from os2d_torch.engine.objective import ObjectiveConfig
    from os2d_torch.models import Os2dConfig, Os2dModel

    cfg = get_default_cfg()
    card = Os2dModel(Os2dConfig(), seed=2)
    subset = train_set.copy_subset(MINING_CPU_IMAGES)
    mined = {}
    for dev, m in (("cuda", card), ("cpu", twin(card))):
        loader, _ = build_train_dataloader_from_config(cfg, subset, seed=0)
        mined[dev] = mine_hard_patches(loader, m, cfg, ObjectiveConfig())
    assert scenes_mod.mined_records_disagree(mined["cuda"], mined["cpu"], TRAIN_CPU_RTOL,
                                             MINING_ATOL) is None
    loader, _ = build_train_dataloader_from_config(cfg, train_set, seed=0)
    with Launches() as launched:
        mined_all = mine_hard_patches(loader, card, cfg, ObjectiveConfig())
    records = [r for recs in mined_all.values() for r in recs]
    assert sorted(mined_all) == sorted(train_set.image_ids)
    assert {"neg", "pos"} <= {r["role"] for r in records}
    assert all(np.isfinite([r["loss"], r["loss_loc"], r["score"]]).all()
               and np.isfinite(r["transform_corners"]).all() for r in records)
    batches = -(-TRAIN_IMAGES // int(cfg.eval.batch_size))
    assert launched["hat"] == (batches * int(cfg.train.mining.num_random_pyramid_scales)
                               * -(-TRAIN_CLASSES // int(cfg.tpu.eval_class_chunk)))


def test_trainval_loop_mines_with_the_device_class_cache(train_set):
    """trainval_loop with do_mining, mine_hard_patches_iter 2, TRAIN_STEPS
    steps and cfg.tpu.device_class_cache "required": mining at iterations 0
    and 2, every batch cropped at mined records and holding their labels,
    class images from the cache, finite losses, one hat and one backward
    launch a step."""
    from os2d_torch.config import get_default_cfg
    from os2d_torch.data.dataloader import build_train_dataloader_from_config
    from os2d_torch.engine import train as train_module
    from os2d_torch.engine.objective import ObjectiveConfig
    from os2d_torch.engine.optimization import create_optimizer
    from os2d_torch.engine.train import trainable_parameters, trainval_loop
    from os2d_torch.models import Os2dConfig, Os2dModel

    cfg = get_default_cfg()
    cfg.train.optim.max_iter = TRAIN_STEPS
    cfg.eval.iter = TRAIN_STEPS
    cfg.train.mining.do_mining = True
    cfg.train.mining.mine_hard_patches_iter = MINE_ITER
    cfg.tpu.device_class_cache = "required"
    model = Os2dModel(Os2dConfig(), seed=2)
    loader, _ = build_train_dataloader_from_config(cfg, train_set, seed=0)
    optimizer = create_optimizer(cfg.train.optim, trainable_parameters(model, cfg.train))
    mined_at, steps, batch_checks, replayed = [], [], [], []
    orig_mine, orig_one = train_module.mine_hard_patches, train_module.train_one_batch
    orig_prepare, orig_transform = loader._prepare_batch, loader._transform_image

    def mine_counted(*args, **kwargs):
        mined_at.append(len(steps))
        return orig_mine(*args, **kwargs)

    def one_counted(batch, *args, **kwargs):
        with Launches() as launched:
            meters = orig_one(batch, *args, **kwargs)
        steps.append((meters["loss"], meters["grad_norm"], batch["class_images"] is None,
                      launched))
        return meters

    def transform_replayed(image_id, boxes, mined_data=None, **kwargs):
        if mined_data is not None:
            replayed.append(mined_data["label_global"])
        return orig_transform(image_id, boxes, mined_data=mined_data, **kwargs)

    def prepare_checked(image_ids):
        replayed.clear()
        batch = orig_prepare(image_ids)
        batch_checks.append((len(replayed), set(replayed) <= set(batch["class_ids"])))
        return batch

    train_module.mine_hard_patches, train_module.train_one_batch = mine_counted, one_counted
    loader._prepare_batch, loader._transform_image = prepare_checked, transform_replayed
    try:
        trainval_loop(loader, model, cfg, ObjectiveConfig(), optimizer)
    finally:
        train_module.mine_hard_patches, train_module.train_one_batch = orig_mine, orig_one
    assert mined_at == list(range(0, TRAIN_STEPS, MINE_ITER))
    assert loader.device_class_cache is not None
    assert batch_checks == [(cfg.train.batch_size, True)] * TRAIN_STEPS
    assert len(steps) == TRAIN_STEPS
    for loss, grad_norm, from_cache, launched in steps:
        assert np.isfinite([loss, grad_norm]).all() and from_cache
        assert launched["hat"] == 1 and launched["backward"] == 1, launched


def test_device_class_cache_equals_the_host_path(train_set, train_loader):
    """The device class cache of the default recipe: its gather on the card
    equal to its gather on the CPU for every method and flip; its class
    tensor equal to the host path's on unflipped batches, until all six
    resample methods are seen (at most CACHE_CHECK_BATCHES batches); a step
    from each path finite, with one hat and one backward launch."""
    from os2d_torch.config import get_default_cfg
    from os2d_torch.data.class_cache import DeviceClassCache
    from os2d_torch.data.dataloader import build_train_dataloader_from_config
    from os2d_torch.engine.objective import ObjectiveConfig
    from os2d_torch.engine.optimization import create_optimizer
    from os2d_torch.engine.train import TrainStep, prepare_batch_arrays, trainable_parameters
    from os2d_torch.models import Os2dConfig, Os2dModel

    cfg = get_default_cfg()
    loaders = {name: build_train_dataloader_from_config(cfg, train_set, seed=0)[0]
               for name in ("host", "cache")}
    cache = DeviceClassCache.build(loaders["cache"], "cuda",
                                   budget_mb=int(cfg.tpu.device_class_cache_budget_mb))
    loaders["cache"].attach_device_class_cache(cache)
    cpu_cache = DeviceClassCache(cache.class_ids, cache.index_of, cache.sizes, cache.stack.cpu())
    for m in range(6):
        for hf in (False, True):
            for vf in (False, True):
                args = (cache.class_ids, [m] * TRAIN_CLASSES, hf, vf, TRAIN_CLASSES)
                assert torch.equal(cache.gather(*args).cpu(), cpu_cache.gather(*args))
    seen, n = set(), 0
    while len(seen) < 6 and n < CACHE_CHECK_BATCHES:
        hb, cb = (loaders[k].get_batch(n % len(train_loader)) for k in ("host", "cache"))
        g = cb["class_gather"]
        ha, h_pad = prepare_batch_arrays(hb, "cuda")
        ca, c_pad = prepare_batch_arrays(cb, "cuda")
        n_real = len(hb["class_ids"])
        assert hb["class_ids"] == cb["class_ids"] and h_pad == c_pad
        assert not (g["hflip"] or g["vflip"])
        assert np.array_equal(hb["images"], cb["images"])
        assert torch.equal(ha["class_images"][:n_real], ca["class_images"][:n_real])
        assert torch.equal(ha["class_valid"], ca["class_valid"])
        seen.update(g["method_idx"])
        n += 1
    assert len(seen) == 6, seen
    model = Os2dModel(Os2dConfig(), seed=1)
    tcfg = train_cfg()
    step = TrainStep(model, ObjectiveConfig(), create_optimizer(
        tcfg.train.optim, trainable_parameters(model, tcfg.train)), tcfg.train)
    for name in ("host", "cache"):
        with Launches() as launched:
            metrics = step(*prepare_batch_arrays(loaders[name].get_batch(0), "cuda"))
        assert np.isfinite(metrics["loss"]), (name, metrics)
        assert launched["hat"] == 1 and launched["backward"] == 1, (name, launched)


# ---- the data-parallel mesh on one card ----

def _distributed_comparison(work, cfg, batches):
    """The plain step twice from seed DIST_SEED's weights on `batches` (the
    second run must repeat the first to the bit); (a) one nccl rank on
    cuda:0 and (b) two gloo ranks sharing it (NCCL refuses two ranks on one
    device) take the same data-parallel steps from those weights, then the
    planted eval at "highest" sharded by classes, and in (b) also by images.
    Returns every number the test holds."""
    from os2d_torch.engine.objective import ObjectiveConfig
    from os2d_torch.engine.optimization import create_optimizer
    from os2d_torch.engine.train import TrainStep, prepare_batch_arrays, trainable_parameters
    from os2d_torch.models import Os2dConfig, Os2dModel
    from os2d_torch.parallel.spawn import run_local_group

    start_path = os.path.join(work, "start.pth")
    runs = []
    for _ in range(2):
        model = Os2dModel(Os2dConfig(), seed=DIST_SEED)
        if not runs:
            torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, start_path)
        step = TrainStep(model, ObjectiveConfig(margin_pos=FIRST_STEP_MARGIN_POS),
                         create_optimizer(cfg.train.optim,
                                          trainable_parameters(model, cfg.train)), cfg.train)
        runs.append(([step(*prepare_batch_arrays(b, "cuda")) for b in batches], model))
    (ref_metrics, ref_model), (rerun_metrics, _) = runs
    ref_final = {k: v.detach().clone() for k, v in ref_model.state_dict().items()}
    del runs, ref_model
    eval_root = os.path.join(work, "planted")
    eval_df = scenes_mod.write_planted_dataset(eval_root)
    ref_eval = scenes_mod.detect_and_evaluate("cuda", eval_root, eval_df, "classes")
    torch.cuda.empty_cache()
    inputs = {"train_cfg": cfg, "batches": batches, "start_path": start_path,
              "eval_root": eval_root, "eval_df": eval_df}
    ranks = {
        "a": run_local_group(scenes_mod.distributed_rank, 1, (dict(
            inputs, final_path=os.path.join(work, "final_a.pth"), eval_axes=["classes"]),),
            devices=["cuda:0"], backend="nccl", timeout_s=DIST_TIMEOUT_S),
        "b": run_local_group(scenes_mod.distributed_rank, 2, (dict(
            inputs, final_path=os.path.join(work, "final_b.pth"),
            eval_axes=["classes", "images"]),), devices=["cuda:0"] * 2, backend="gloo",
            timeout_s=DIST_TIMEOUT_S)}
    loss_keys = [k for k in ref_metrics[0] if k != "grad_norm"]
    out = {"ref_metrics": ref_metrics, "rerun_metrics": rerun_metrics,
           "ref_map": ref_eval["mAP@0.50"]}
    for group, rs in ranks.items():
        got = torch.load(os.path.join(work, f"final_{group}.pth"), weights_only=True)
        out[group] = {
            "backends": [r["backend"] for r in rs],
            # the loss terms are held; the gradient norm is not (the
            # data-parallel step sums the gradients in another order)
            "loss_rel_err": max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12) for r in rs
                                for g, w in zip(r["metrics"], ref_metrics) for k in loss_keys),
            "weights_excess": max(float(((got[k].cuda() - w).abs() - (
                DIST_PARAM_ATOL + DIST_PARAM_RTOL * w.abs())).max()) for k, w in ref_final.items()),
            "digests": [r["digest"] for r in rs],
            "train_launches": [r["train_launches"] for r in rs],
            "eval": [r["eval"] for r in rs]}
    return out, ref_eval


def _packed_agree(got, want):
    valid = want[..., 5] > 0.5
    return (np.array_equal(got[..., 5], want[..., 5]) and valid.any()
            and float(np.abs(got[valid][:, 4] - want[valid][:, 4]).max()) <= DIST_SCORE_ATOL
            and float(np.abs(got[valid][:, :4] - want[valid][:, :4]).max()) <= DIST_BOX_ATOL)


def test_data_parallel_steps_and_sharded_evals_on_one_card(train_loader, tmp_path):
    """The mesh (os2d_torch/parallel), each rank a process of its own, on
    DIST_STEPS batches of the recipe from seed-2 weights: a second plain run
    equal to the first to the bit; (a) one nccl rank's loss terms within
    rtol 2e-5 of the plain step's, its weights within rtol 1e-4, atol 1e-6,
    its class-sharded eval at mAP@0.50 1.0 as the unsharded one with the
    planted batch's packed detections within scores 1e-5, boxes 1e-2 px and
    equal valid flags; (b) two gloo ranks at 2 images each: losses and
    weights as in (a), the ranks' weights equal to the bit, the class- and
    image-sharded evals held as in (a); each rank's steps launch the hat and
    the backward kernel once a step, each eval the gather. The whole
    comparison runs twice on the same batches and gives the same numbers to
    the bit."""
    batches = [{k: b[k] for k in DIST_BATCH_KEYS}
               for b in (train_loader.get_batch(i % len(train_loader))
                         for i in range(DIST_STEPS))]
    outs = []
    for i in range(2):
        work = tmp_path / f"run{i}"
        work.mkdir()
        outs.append(_distributed_comparison(str(work), train_cfg(), batches))
    (out, ref_eval), (again, _) = outs
    assert out["rerun_metrics"] == out["ref_metrics"]
    assert out["ref_map"] == 1.0
    for group in ("a", "b"):
        r = out[group]
        assert r["loss_rel_err"] <= DIST_LOSS_RTOL, (group, r["loss_rel_err"])
        assert r["weights_excess"] <= 0, (group, r["weights_excess"])
        for launches in r["train_launches"]:
            assert launches["hat"] == DIST_STEPS and launches["backward"] == DIST_STEPS
        for evals in r["eval"]:
            for axis, e in evals.items():
                assert e["mAP@0.50"] == out["ref_map"], (group, axis)
                assert _packed_agree(e["packed"], ref_eval["packed"]), (group, axis)
                assert e["launches"]["gather"] > 0
    assert out["a"]["backends"] == ["nccl"] and out["b"]["backends"] == ["gloo"] * 2
    assert len(set(out["b"]["digests"])) == 1
    assert again["ref_metrics"] == out["ref_metrics"]
    for group in ("a", "b"):
        for key in ("loss_rel_err", "weights_excess", "digests"):
            assert again[group][key] == out[group][key], (group, key)


# ---- the checkpoint backends ----

def test_checkpoint_backends_round_trip_a_trained_model(trained, tmp_path):
    """The trained model and its optimizer written with
    cfg.tpu.checkpoint_backend "orbax" (torch.distributed.checkpoint, a .dcp
    tree beside a stub) and "pickle", each read back: net and optimizer
    state bit-equal; through load_checkpoint_file into a card model and a
    fresh optimizer, bit-equal."""
    from os2d_torch.engine.optimization import create_optimizer
    from os2d_torch.engine.train import trainable_parameters
    from os2d_torch.models import Os2dConfig, Os2dModel
    from os2d_torch.models.checkpoint import load_checkpoint_file
    from os2d_torch.utils.logger import checkpoint_model, load_checkpoint

    def same(a, b):
        return (a is None and b is None) or (
            a is not None and b is not None and torch.equal(a.cpu(), b.cpu()))

    model, optimizer = trained["model"], trained["optimizer"]
    want_net, want_opt = model.state_dict(), optimizer.state_dict()
    assert want_opt["state"]
    paths = {}
    for backend in ("pickle", "orbax"):
        paths[backend] = checkpoint_model(model, optimizer, str(tmp_path), model_name=backend,
                                          backend=backend)
        payload = load_checkpoint(paths[backend])
        assert set(payload["net"]) == set(want_net)
        assert all(torch.equal(payload["net"][k], want_net[k].cpu()) for k in want_net)
        assert payload["optimizer"]["param_groups"] == want_opt["param_groups"]
        assert all(same(payload["optimizer"]["state"][i][k], v)
                   for i, s in want_opt["state"].items() for k, v in s.items())
    loaded = Os2dModel(Os2dConfig(), seed=3)
    state, opt_state = load_checkpoint_file(paths["orbax"], Os2dConfig(), loaded)
    loaded.load_state_dict(state)
    assert all(torch.equal(v, want_net[k]) for k, v in loaded.state_dict().items())
    cfg = train_cfg()
    restored = create_optimizer(cfg.train.optim, trainable_parameters(loaded, cfg.train))
    restored.load_state_dict(opt_state)
    assert all(same(restored.state_dict()["state"][i][k], v)
               for i, s in want_opt["state"].items() for k, v in s.items())
