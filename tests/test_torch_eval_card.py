"""The port's eval path on the card, held against the CPU and against its
plain kernels: planted patches, evaluate() to mAP, the class prescreen, the
benchmark's dispatch (with the head's constants from their cache) and the
kernels on its own inputs, the numeric modes, the model options (int8 tier
and bank, the grid path, GroupNorm and ResNet101), evaluate()'s host side
(producer thread, per-level class chunks, the figures) and the yuv420
upload wire.

Without a card every test here skips. The file imports no JAX:

    python -m pytest --noconftest tests/test_torch_eval_card.py -q

The model is `Os2dConfig()` at full width with seed-0 weights, its CPU twin
the same weights; scenes and datasets come from tests/torch_card_scenes.py,
written under a temporary directory by the fixtures.
"""

import os
import pickle
import sys
import types

import numpy as np
import pytest
import torch

import torch_card_scenes as scenes_mod
from torch_card_scenes import (
    BATCH,
    EVAL_PYRAMID,
    IMG_H,
    IMG_W,
    NUM_CLASSES,
    PLANTED,
    PYRAMID,
    Launches,
    detections_agree,
    eval_cfg,
    planted_cfg,
    planted_detections,
    planted_eval_loader,
    planted_found,
    planted_hits_agree,
    twin,
)

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1e-5, 1e-6  # the gather and int8 kernels against their plain versions
HAT_RTOL, HAT_ATOL = 1e-5, 1e-5
DEFAULT_TIER_MARGIN = 4e-3  # engine.evaluate.prescreen_margin("default")
FBN_SLOTS_PER_PASS = 40  # ResNet50-C4: the stem and 3 slots in each of 13 bottlenecks
PRESCREEN_CLASSES, PRESCREEN_W, PRESCREEN_H = 8, 320, 256
# the int8 tier's planted scores card against CPU: corr on the two devices
# differs in its last bits, which moves a value across a 1/127 rounding
# point now and then (one corner's step moves a score by at most 1/127 *
# 1/121 ~ 6.5e-5)
INT8_SCORE_ATOL = 4e-4
GRID_HEAD_ATOL = 1e-4
GN_CROP = (320, 240)
# ResNet101-C4 card against CPU, relative to the features' largest
# magnitude (random He weights under identity normalizations grow the
# residual stream of 23 blocks to ~1e4)
R101_RTOL_TO_MAX = 1e-4
HOST_CPU_SCENES = 4
CHUNK_CLASSES, CHUNK_SIZE = 256, 32
VIZ_ATOL = 1e-4  # score, IoU and loss maps, card against CPU
VIZ_GRAD_RTOL, VIZ_GRAD_ATOL = 1e-4, 1e-6
WIRE_LEVELS = [0.5, 1.0]


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from os2d_torch.models import Os2dConfig, Os2dModel

    return Os2dModel(Os2dConfig(), seed=0)


@pytest.fixture(scope="module")
def cpu_model(model):
    return twin(model)


@pytest.fixture(scope="module")
def planted_loader(model, tmp_path_factory):
    return planted_eval_loader(str(tmp_path_factory.mktemp("planted")))


def _evaluate_card_cpu(loader, model, cpu_model, cfg):
    """evaluate() on the card (its kernels' launches counted) and on the CPU."""
    from os2d_torch.engine.evaluate import evaluate

    with Launches() as launched:
        card = evaluate(loader, model, cfg)
    return card, evaluate(loader, cpu_model, cfg), launched


def _bench(model, cfg=None):
    """The benchmark's eval protocol: B=2 uint8 images of 1280x960, the
    7-level pyramid, 16 classes of random 240-px class images in one chunk;
    (evaluator, class head, level sizes, inverse scales, normalization,
    batches)."""
    from os2d_torch.config import get_default_cfg
    from os2d_torch.engine.evaluate import Evaluator
    from os2d_torch.structures.feature_map import FeatureMapSize

    if cfg is None:
        cfg = get_default_cfg()
        cfg.tpu.eval_class_chunk = NUM_CLASSES
    rng = np.random.RandomState(0)
    class_images = [rng.randn(240, 240, 3).astype(np.float32) for _ in range(NUM_CLASSES)]
    sizes = [FeatureMapSize(w=int(IMG_W * s), h=int(IMG_H * s)) for s in PYRAMID]
    inv = [(IMG_W / sz.w, IMG_H / sz.h) for sz in sizes]
    batches = [np.random.RandomState(i).randint(0, 255, (BATCH, IMG_H, IMG_W, 3), np.uint8)
               for i in range(2)]
    ev = Evaluator(model, cfg)
    head, _ = ev.build_class_heads(class_images)
    return types.SimpleNamespace(ev=ev, head=head, sizes=sizes, inv=inv,
                                 norm=scenes_mod.norm_of(model), batches=batches, cfg=cfg)


# ---- planted patches, evaluate(), the prescreen ----

def test_planted_patches_are_found_as_on_the_cpu(model, cpu_model):
    """Each planted patch is the top valid detection of its class (IoU >
    0.5) at the default tier, and the card's detections agree with the CPU's
    (scores 1e-4, boxes 1e-2 px)."""
    with Launches() as launched:
        card = planted_detections(model)
    assert all(planted_found(card))
    assert detections_agree(card, planted_detections(cpu_model))
    assert launched["hat"] > 0


def test_evaluate_reaches_the_cpus_map_through_the_prescreen(model, cpu_model, planted_loader):
    """evaluate() over the planted files at two levels, 8 TTA views a class
    and a finite nms_score_threshold: the prescreen runs, mAP@0.50 >= 0.9
    and equal to the CPU's."""
    card, cpu, launched = _evaluate_card_cpu(planted_loader, model, cpu_model, eval_cfg())
    assert "prescreen_pruned" in card
    assert card["mAP@0.50"] >= 0.9
    assert cpu["mAP@0.50"] == card["mAP@0.50"]
    assert launched["hat"] > 0


def test_the_prescreen_prunes_some_classes_as_on_the_cpu(model, cpu_model):
    """detect_images_prescreened with a one-hot bank (class k correlates with
    feature channel 240 + k, so its ceiling has real spread) and a threshold
    between the classes' best scores: some but not all classes pruned, the
    same ones as on the CPU; the survivors' detections match the full path
    (scores 1e-4, boxes 1e-3 px) and the CPU's."""
    from os2d_torch.engine.evaluate import Evaluator, unpack_detections
    from os2d_torch.models import head as head_module
    from os2d_torch.structures.feature_map import FeatureMapSize

    cfg = planted_cfg()
    cfg.tpu.eval_class_chunk = 2
    cfg.tpu.eval_top_k = 32
    feats = torch.zeros(PRESCREEN_CLASSES, 15, 15, 1024)
    for k in range(PRESCREEN_CLASSES):
        feats[k, :, :, 240 + k] = 1.0
    scene = np.random.RandomState(0).randint(0, 255, (1, PRESCREEN_H, PRESCREEN_W, 3), np.uint8)
    args = ([FeatureMapSize(w=PRESCREEN_W, h=PRESCREEN_H)], [(1.0, 1.0)],
            scenes_mod.norm_of(model))
    out, pruned, launched = {}, {}, {}
    for dev, m in (("cuda", model), ("cpu", cpu_model)):
        head = head_module.ClassHead(feats.to(dev), head_module.make_class_pool_mask(
            PRESCREEN_CLASSES, device=dev))
        ev = Evaluator(m, cfg)
        if dev == "cuda":
            cfg.eval.nms_score_threshold = float("-inf")
            full = unpack_detections(ev.detect_images(scene, head, *args))
            cfg.eval.nms_score_threshold = float(np.median(full["scores"][0].max(1)))
            out["full"] = unpack_detections(ev.detect_images(scene, head, *args))
        with Launches() as launched[dev]:
            out[dev] = unpack_detections(ev.detect_images_prescreened(scene, head, *args))
        pruned[dev] = ev.prescreen_pruned
    assert 0 < pruned["cuda"] < PRESCREEN_CLASSES
    assert pruned["cpu"] == pruned["cuda"]
    assert detections_agree(out["cuda"], out["full"], box_atol=1e-3)
    assert detections_agree(out["cuda"], out["cpu"])
    assert launched["cuda"]["hat"] > 0


def test_evaluate_through_the_host_pyramid_matches_the_cpu(model, cpu_model, planted_loader):
    """evaluate() with cfg.tpu.device_side_pyramid False: mAP@0.50 1.0 on the
    card and on the CPU, the hat kernel once per (image, level)."""
    from os2d_torch.config import get_default_cfg

    cfg = get_default_cfg()
    cfg.eval.mAP_iou_thresholds = [0.5]
    cfg.tpu.device_side_pyramid = False
    cfg.tpu.eval_pre_top_k = 256
    cfg.tpu.eval_top_k = 32
    card, cpu, launched = _evaluate_card_cpu(planted_loader, model, cpu_model, cfg)
    assert card["mAP@0.50"] == 1.0 == cpu["mAP@0.50"]
    assert launched["hat"] == len(PLANTED) * len(EVAL_PYRAMID)  # batch 1, one class chunk


# ---- the benchmark's dispatch and the kernels on its inputs ----

@pytest.mark.parametrize("option,kernel", [
    ("default", "hat"), ("highest", "gather"), ("int8", "int8"), ("fp32_fold", "hat"),
    ("bf16", "hat"), ("bf16_fold", "hat"), ("grid", "hat"), ("group_norm", "hat")])
def test_bench_dispatch_launches_its_kernels_once_a_level(option, kernel, model,
                                                          record_property):
    """One dispatch at the benchmark's protocol after a warm-up: the tier's
    resample kernel once a level; at the two tiers the frozen-BN kernel 40
    times a level, under GroupNorm its forward kernel; packed detections of
    shape [B, C, top_k, 6], finite, some valid. Options: the resample
    tiers, the numeric modes (fp32 with BatchNorm folded, bf16 unfolded and
    folded), corr_interior_first False, and use_group_norm (its own seed-0
    weights)."""
    from os2d_torch.engine.evaluate import unpack_detections
    from os2d_torch.models import Os2dConfig, Os2dModel

    if option == "group_norm":
        m = Os2dModel(Os2dConfig(use_group_norm=True), seed=0)
    elif option in ("fp32_fold", "bf16", "bf16_fold"):
        dtype = "float32" if option == "fp32_fold" else "bfloat16"
        m = twin(model, Os2dConfig(compute_dtype=dtype), "cuda", folded=option.endswith("fold"))
    else:
        config = (Os2dConfig(corr_interior_first=False) if option == "grid"
                  else Os2dConfig(resample_precision=option))
        m = twin(model, config, "cuda")
    b = _bench(m)
    b.ev.detect_images(b.batches[1], b.head, b.sizes, b.inv, b.norm)
    with Launches() as launched:
        out = b.ev.detect_images(b.batches[0], b.head, b.sizes, b.inv, b.norm)
    record_property("launches", dict(launched))  # chip_smoke.py's kernels line
    assert launched[kernel] == len(PYRAMID)
    if option in ("default", "highest"):
        assert launched["frozen_bn"] == FBN_SLOTS_PER_PASS * len(PYRAMID)
    if option == "group_norm":
        assert launched["gn_forward"] > 0
    assert tuple(out.shape) == (BATCH, NUM_CLASSES, int(b.cfg.tpu.eval_top_k), 6)
    d = unpack_detections(out)
    assert np.isfinite(d["boxes"]).all() and np.isfinite(d["scores"][d["valid"]]).all()
    assert d["valid"].any()


def test_bench_dispatch_reads_the_heads_constants_from_its_cache(model):
    """After one warm request, a dispatch at the benchmark's protocol looks
    the head's constants up once a level (`models/head.py:
    head_constants`) and builds none, and no `os2d.wait.constant` opens
    inside an `os2d.head`; its packed detections equal those of a dispatch
    on a cleared cache to the bit."""
    from torch.profiler import ProfilerActivity, profile

    from os2d_torch.models.head import head_constants

    b = _bench(model)
    b.ev.detect_images(b.batches[1], b.head, b.sizes, b.inv, b.norm)
    lookups, builds = head_constants.lookups, head_constants.builds
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        warm = b.ev.detect_images(b.batches[0], b.head, b.sizes, b.inv, b.norm)
        torch.cuda.synchronize()
    assert head_constants.lookups - lookups == len(PYRAMID)
    assert head_constants.builds == builds
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()]
    heads = [s for s in spans if s[2] == "os2d.head"]
    waits = [s for s in spans if s[2] == "os2d.wait.constant"]
    assert len(heads) == len(PYRAMID) and waits
    assert not [w for w in waits for h in heads if h[0] <= w[0] and w[1] <= h[1]]
    head_constants.clear()
    cold = b.ev.detect_images(b.batches[0], b.head, b.sizes, b.inv, b.norm)
    assert head_constants.builds - builds == len(PYRAMID)
    assert torch.equal(warm, cold)


def test_kernels_on_the_main_paths_inputs(model):
    """One default-tier dispatch at the benchmark's protocol with the head's
    resample inputs and its coordinate function's theta, boxes and lattice
    captured at every level: the gather at rtol 1e-5, atol 1e-6 of the
    exact plain version; the hat kernel's output at rtol 1e-5, atol 1e-5 of
    its plain version and within 4e-3 (the "default" prescreen margin) of
    the exact gather; the int8 kernel from theta equal to its plain version
    and to itself from the level's px/py to the bit."""
    from os2d_torch.models import head as head_module
    from os2d_torch.ops import int8_resample, resample, resample_grad
    from os2d_torch.ops.sampling import (
        hat_resample_reference,
        int8_hat_resample_theta_reference,
        resample_correlation_from_pxpy_reference,
    )

    b = _bench(model)
    captured, captured_theta = [], []
    original, original_coords = resample_grad.FORWARD["default"], head_module.interior_sample_coords

    def capture(corr, px, py, mask_t):
        out = original(corr, px, py, mask_t)
        captured.append((corr, px, py, mask_t, out))
        return out

    def capture_coords(theta, boxes, lattice, h, w):
        captured_theta.append((theta.contiguous(), boxes, lattice))
        return original_coords(theta, boxes, lattice, h, w)

    resample_grad.FORWARD["default"] = capture
    head_module.interior_sample_coords = capture_coords
    try:
        b.ev.detect_images(b.batches[0], b.head, b.sizes, b.inv, b.norm)
    finally:
        resample_grad.FORWARD["default"] = original
        head_module.interior_sample_coords = original_coords
    torch.cuda.synchronize()
    assert len(captured) == len(captured_theta) == len(PYRAMID)
    for (corr, px, py, mask_t, hat_out), (theta, boxes, lattice) in zip(captured, captured_theta):
        exact = resample_correlation_from_pxpy_reference(corr, px, py, mask_t)
        torch.testing.assert_close(resample.resample_correlation(corr, px, py, mask_t), exact,
                                   rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(hat_out, hat_resample_reference(corr, px, py, mask_t),
                                   rtol=HAT_RTOL, atol=HAT_ATOL)
        assert float((hat_out - exact).abs().max()) <= DEFAULT_TIER_MARGIN
        got8 = int8_resample.resample_correlation_int8_theta(corr, theta, boxes, lattice, mask_t)
        assert torch.equal(got8, int8_hat_resample_theta_reference(corr, theta, boxes, lattice,
                                                                   mask_t))
        assert torch.equal(got8, int8_resample.resample_correlation_int8(corr, px, py, mask_t))


# ---- the numeric modes ----

def test_folded_fp32_detects_as_unfolded(model):
    """fp32 with BatchNorm folded into the convolutions finds the planted
    patches as the unfolded model does (scores 1e-4, boxes 1e-2 px)."""
    with Launches() as launched:
        folded = planted_detections(twin(model, device="cuda", folded=True))
    assert detections_agree(folded, planted_detections(model))
    assert launched["hat"] > 0


def test_evaluate_with_fold_bn_matches_the_cpu(model, cpu_model, planted_loader):
    """evaluate() with cfg.tpu.fold_bn: mAP@0.50 >= 0.9 on the card, equal
    to the CPU's."""
    cfg = eval_cfg()
    cfg.tpu.fold_bn = True
    card, cpu, launched = _evaluate_card_cpu(planted_loader, model, cpu_model, cfg)
    assert card["mAP@0.50"] >= 0.9
    assert card["mAP@0.50"] == cpu["mAP@0.50"]
    assert launched["hat"] > 0


# ---- the model options ----

def test_int8_tier_finds_the_planted_patches_as_the_cpu(model):
    """resample_precision "int8": every planted patch found, the card's
    detections within INT8_SCORE_ATOL of the CPU's, the int8 kernel
    launched."""
    from os2d_torch.models import Os2dConfig

    config = Os2dConfig(resample_precision="int8")
    with Launches() as launched:
        card = planted_detections(twin(model, config, "cuda"))
    assert all(planted_found(card))
    assert detections_agree(card, planted_detections(twin(model, config)),
                            score_atol=INT8_SCORE_ATOL)
    assert launched["int8"] > 0


def test_int8_bank_reaches_map_1_as_the_cpu(model, cpu_model, planted_loader):
    """evaluate() with cfg.tpu.quantize_class_feats (no TTA, threshold 0.5):
    mAP@0.50 1.0 on the card and the CPU, the prescreen not applied to the
    int8 bank; the benchmark's bank quantizes to int8."""
    from os2d_torch.models.head import quantize_class_head

    cfg = eval_cfg()
    cfg.tpu.quantize_class_feats = True
    cfg.eval.class_image_augmentation = ""
    card, cpu, launched = _evaluate_card_cpu(planted_loader, model, cpu_model, cfg)
    assert card["mAP@0.50"] == 1.0 == cpu["mAP@0.50"]
    assert "prescreen_pruned" not in card
    assert quantize_class_head(_bench(model).head).class_feats_q.dtype == torch.int8
    assert launched["hat"] > 0


@pytest.mark.parametrize("tier,kernel", [("default", "hat"), ("highest", "gather")])
def test_grid_path_matches_the_cpu_and_the_interior_first_head(tier, kernel, model):
    """corr_interior_first=False: planted patches found, the card's
    detections as the CPU's; the head's cls and loc at full width on the
    card within GRID_HEAD_ATOL of the CPU's and of the interior-first
    head's."""
    from os2d_torch.engine.evaluate import Evaluator
    from os2d_torch.models import Os2dConfig

    config = Os2dConfig(corr_interior_first=False, resample_precision=tier)
    with Launches() as launched:
        card = planted_detections(twin(model, config, "cuda"))
    assert all(planted_found(card))
    assert detections_agree(card, planted_detections(twin(model, config)))
    assert launched[kernel] > 0
    scenes, patches = scenes_mod.planted_scenes()
    norm = scenes_mod.norm_of(model)
    scene = ((torch.as_tensor(scenes[:1]).float() / 255.0 - torch.tensor(norm["mean"]))
             / torch.tensor(norm["std"]))
    heads = {}
    for name, dev, first in (("cuda", "cuda", False), ("cpu", "cpu", False),
                             ("cuda_interior_first", "cuda", True)):
        m = twin(model, Os2dConfig(corr_interior_first=first, resample_precision=tier), dev)
        with torch.no_grad():
            bank, _ = Evaluator(m, planted_cfg()).build_class_heads(
                scenes_mod.normalized(model.config, patches))
            heads[name] = m.apply_head(m.extract_features(scene.to(dev)), bank)
    for key in ("cls", "loc"):
        for other in ("cpu", "cuda_interior_first"):
            err = float((heads["cuda"][key].cpu() - heads[other][key].cpu()).abs().max())
            assert err <= GRID_HEAD_ATOL, (key, other, err)


def test_grid_path_evaluate_reaches_map_1(model, planted_loader):
    """evaluate() as the planted eval, on the grid path: mAP@0.50 1.0, as the
    interior-first path."""
    from os2d_torch.engine.evaluate import evaluate
    from os2d_torch.models import Os2dConfig

    with Launches() as launched:
        grid = evaluate(planted_loader, twin(model, Os2dConfig(corr_interior_first=False),
                                             "cuda"), eval_cfg())
    assert grid["mAP@0.50"] == 1.0 == evaluate(planted_loader, model, eval_cfg())["mAP@0.50"]
    assert launched["hat"] > 0


def test_group_norm_model_detects_as_the_cpu(model):
    """Os2dConfig(use_group_norm=True) with its seed-0 weights: the planted
    detections on the card agree with the CPU's, the GroupNorm forward
    kernel launched."""
    from os2d_torch.models import Os2dConfig, Os2dModel

    gn = Os2dModel(Os2dConfig(use_group_norm=True), seed=0)
    with Launches() as launched:
        card = planted_detections(gn)
    assert detections_agree(card, planted_detections(twin(gn)))
    assert launched["gn_forward"] > 0 and launched["hat"] > 0


@pytest.mark.parametrize("gn", [False, True], ids=["batch_norm", "group_norm"])
def test_resnet101_c4_features_match_the_cpu(gn, model):
    """The ResNet101-C4 forward, BatchNorm and GroupNorm, on a 320x240 crop
    of the first planted scene: card against CPU within 1e-4 of the
    features' largest magnitude."""
    from os2d_torch.models import Os2dConfig, Os2dModel

    scenes, _ = scenes_mod.planted_scenes()
    norm = scenes_mod.norm_of(model)
    crop = ((torch.as_tensor(scenes[:1, :GN_CROP[1], :GN_CROP[0]]).float() / 255.0
             - torch.tensor(norm["mean"])) / torch.tensor(norm["std"]))
    m = Os2dModel(Os2dConfig(backbone_arch="resnet101", use_group_norm=gn), seed=3)
    with torch.no_grad():
        got, want = m.extract_features(crop.cuda()), twin(m).extract_features(crop)
    err = float((got.cpu() - want).abs().max())
    assert err <= R101_RTOL_TO_MAX * float(want.abs().max())


# ---- evaluate()'s host side: the producer thread, class chunks, figures ----

@pytest.fixture(scope="module")
def host_root(model, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("host"))
    return root, scenes_mod.write_host_dataset(root)


def _detections_file(loader, model, cfg, out_dir):
    from os2d_torch.engine.evaluate import evaluate

    cfg = cfg.clone()
    cfg.visualization.eval.path_to_save_detections = out_dir
    res = evaluate(loader, model, cfg)
    with open(os.path.join(out_dir, f"{loader.dataset.name}_detections.pkl"), "rb") as f:
        return res, pickle.load(f)


def test_eval_prefetch_equals_the_serial_loop_and_the_cpu(model, cpu_model, host_root):
    """evaluate() over HOST_SCENES planted 1280x960 files (batch 2,
    EVAL_PYRAMID, no TTA, threshold 0.5: the prescreen runs) with the
    producer thread (cfg.tpu.eval_prefetch_depth 1, pinned uploads on a copy
    stream) and with the serial loop (depth 0): detections bit-equal,
    mAP@0.50 1.0 in both. The card against the CPU on the first
    HOST_CPU_SCENES scenes: mAP@0.50 1.0 on both, the same hit on each
    planted patch (scores 1e-4, boxes 1 px) and as many detections an
    image."""
    from os2d_torch.data.dataloader import DataloaderOneShotDetection

    root, df = host_root
    cfg = eval_cfg()
    cfg.eval.class_image_augmentation = ""
    cfg.eval.batch_size = 2

    def loader(frame, name):
        return DataloaderOneShotDetection(scenes_mod.dataset(root, frame, name, IMG_W),
                                          batch_size=2, pyramid_scales_eval=EVAL_PYRAMID)

    full = loader(df, "planted-host")
    small = loader(df[df.imageid < HOST_CPU_SCENES], "planted-host-small")
    outs = {}
    with Launches() as launched:
        for name, depth in (("prefetch", 1), ("serial", 0)):
            cfg.tpu.eval_prefetch_depth = depth
            outs[name] = _detections_file(full, model, cfg, os.path.join(root, name))
    cfg.tpu.eval_prefetch_depth = 1
    card_res, card_dets = _detections_file(small, model, cfg, os.path.join(root, "small"))
    cpu_res, cpu_dets = _detections_file(small, cpu_model, cfg, os.path.join(root, "cpu"))
    (pre_res, pre_dets), (ser_res, ser_dets) = outs["prefetch"], outs["serial"]
    assert pre_res["mAP@0.50"] == ser_res["mAP@0.50"] == 1.0
    assert card_res["mAP@0.50"] == cpu_res["mAP@0.50"] == 1.0
    for key in ("boxes_xyxy", "scores", "labels"):
        assert all(np.array_equal(a, b) for a, b in zip(pre_dets[key], ser_dets[key])), key
    agree, diff = planted_hits_agree(card_dets, cpu_dets)
    assert agree, diff
    assert [len(a) for a in card_dets["scores"]] == [len(b) for b in cpu_dets["scores"]]
    assert launched["hat"] or launched["gather"]


def test_per_level_class_chunks_equal_uniform_chunks(model):
    """The benchmark's protocol at CHUNK_CLASSES classes (one template's
    features with noise), B=1, eval_class_chunk CHUNK_SIZE: per-level
    chunks' detections torch.equal to uniform ones; the hat kernel once per
    level and chunk of each mode; at "highest" with per-level chunks the
    gather once per level and chunk, with finite detections."""
    from os2d_torch.engine.evaluate import Evaluator, level_class_chunks, unpack_detections
    from os2d_torch.models import Os2dConfig
    from os2d_torch.models.head import ClassHead

    b = _bench(model)
    cfg = b.cfg.clone()
    cfg.tpu.eval_class_chunk = CHUNK_SIZE
    image = torch.as_tensor(b.batches[0][0], device="cuda")[None]
    # one random class image's features, CHUNK_CLASSES noisy copies
    base = model.build_class_head_from_images(
        [np.random.RandomState(0).randn(240, 240, 3).astype(np.float32)])
    feats = base.class_feats.repeat(CHUNK_CLASSES, 1, 1, 1)
    feats = feats + 0.01 * torch.randn(feats.shape, device="cuda",
                                       generator=torch.Generator("cuda").manual_seed(1))
    bank = ClassHead(feats, base.pool_mask.repeat(CHUNK_CLASSES, 1, 1))

    def detect(evaluator):
        return evaluator.detect_images(image, bank, b.sizes, b.inv, b.norm)

    chunks = level_class_chunks(b.sizes, CHUNK_SIZE, CHUNK_CLASSES)
    want = {"uniform": len(b.sizes) * -(-CHUNK_CLASSES // CHUNK_SIZE),
            "per_level": sum(-(-CHUNK_CLASSES // c) for c in chunks)}
    outs = {}
    for per_level in (False, True):
        mode = "per_level" if per_level else "uniform"
        mode_cfg = cfg.clone()
        mode_cfg.tpu.eval_class_chunk_per_level = per_level
        with Launches() as launched:
            outs[mode] = detect(Evaluator(model, mode_cfg))
        assert launched["hat"] == want[mode], mode
    assert torch.equal(outs["per_level"], outs["uniform"])
    highest = twin(model, Os2dConfig(resample_precision="highest"), "cuda")
    with Launches() as launched:
        d = unpack_detections(detect(Evaluator(highest, cfg)))
    assert launched["gather"] == want["per_level"]
    assert np.isfinite(d["scores"][d["valid"]]).all() and d["valid"].any()


class FigureRecorder:
    """Stands in for os2d_torch.utils.visualization while installed (a
    module of the same name in sys.modules, which the engine imports when it
    draws): keeps each call's arrays by (function, file name) and, with
    `draw`, writes the first figure of each function, with the real module
    where matplotlib is installed and else as an .npz of the figure's
    arrays."""

    NAME = "os2d_torch.utils.visualization"
    FUNCTIONS = ("show_detections", "show_gt_boxes", "show_class_heatmap",
                 "show_target_remapping")

    def __init__(self, draw):
        import importlib.util

        self.draw, self.calls = draw, {}
        self.matplotlib = importlib.util.find_spec("matplotlib") is not None

    def __enter__(self):
        import importlib

        self.real = importlib.import_module(self.NAME) if self.matplotlib else None
        self.saved = sys.modules.get(self.NAME)
        stub = types.ModuleType(self.NAME)
        for name in self.FUNCTIONS:
            setattr(stub, name, self._recorder(name))
        sys.modules[self.NAME] = stub
        return self

    def __exit__(self, *exc):
        if self.saved is None:
            del sys.modules[self.NAME]
        else:
            sys.modules[self.NAME] = self.saved

    def _recorder(self, name):
        def record(*args, **kwargs):
            path = kwargs["save_path"]
            first = not any(n == name for n, _ in self.calls)
            self.calls[(name, os.path.basename(path))] = (list(args), dict(kwargs))
            if self.draw and first:
                if self.real is not None:
                    return getattr(self.real, name)(*args, **kwargs)
                arrays = {f"arg{i}": np.asarray(a) for i, a in enumerate(args)
                          if not isinstance(a, list)}
                arrays.update({k: np.asarray(v) for k, v in kwargs.items()
                               if v is not None and k != "save_path"})
                np.savez(path + ".npz", **arrays)
            return path
        return record


def test_figures_of_the_visualization_flags_match_the_cpu(model, tmp_path):
    """evaluate() over the planted files with show_detections, show_gt_boxes
    and show_class_heatmaps, and trainval_loop at the train recipe with no
    step and show_gt_boxes_dataloader and show_target_remapping (margin_pos
    1.0), on the card and the CPU from the same weights: the same figures,
    the first of each kind written; heatmaps and the remapping's score, IoU
    and loss maps within VIZ_ATOL, targets equal, the loss gradients within
    VIZ_GRAD_RTOL, VIZ_GRAD_ATOL."""
    from os2d_torch.data.dataloader import build_train_dataloader_from_config
    from os2d_torch.engine.evaluate import evaluate
    from os2d_torch.engine.objective import ObjectiveConfig
    from os2d_torch.engine.optimization import create_optimizer
    from os2d_torch.engine.train import trainable_parameters, trainval_loop

    root = str(tmp_path)
    eval_loader = planted_eval_loader(os.path.join(root, "data"))
    train_set = scenes_mod.train_dataset(os.path.join(root, "train"))
    records = {}
    for on in ("cuda", "cpu"):
        m = model if on == "cuda" else twin(model)
        viz_cfg = eval_cfg()
        viz_cfg.eval.class_image_augmentation = ""
        viz_cfg.eval.batch_size = 1
        viz_cfg.output.path = os.path.join(root, on)
        flags = viz_cfg.visualization.eval
        flags.show_detections = flags.show_gt_boxes = flags.show_class_heatmaps = True
        train_cfg = scenes_mod.train_cfg()
        train_cfg.train.optim.max_iter = 0
        train_cfg.output.path = os.path.join(root, on)
        train_cfg.visualization.train.show_gt_boxes_dataloader = True
        train_cfg.visualization.train.show_target_remapping = True
        train_model = twin(model, device=on)
        train_loader, _ = build_train_dataloader_from_config(train_cfg, train_set, seed=0)
        with FigureRecorder(draw=on == "cuda") as rec, Launches() as launched:
            evaluate(eval_loader, m, viz_cfg)
            trainval_loop(train_loader, train_model, train_cfg,
                          ObjectiveConfig(margin_pos=scenes_mod.FIRST_STEP_MARGIN_POS),
                          create_optimizer(train_cfg.train.optim,
                                           trainable_parameters(train_model, train_cfg.train)))
        records[on] = rec.calls
        if on == "cuda":
            assert launched["hat"] or launched["gather"]
    files = [f for _, _, fs in os.walk(os.path.join(root, "cuda")) for f in fs]
    card, cpu = records["cuda"], records["cpu"]
    assert set(card) == set(cpu)
    assert {k[0] for k in card} == set(FigureRecorder.FUNCTIONS)
    for name in FigureRecorder.FUNCTIONS:  # the first figure of each kind was written
        first = next(k[1] for k in card if k[0] == name)
        assert first in files or first + ".npz" in files, first
    for key, (args, kwargs) in card.items():
        c_args, c_kwargs = cpu[key]
        if key[0] == "show_class_heatmap":
            assert np.abs(args[1] - c_args[1]).max() <= VIZ_ATOL
        elif key[0] == "show_target_remapping":
            assert np.abs(args[1] - c_args[1]).max() <= VIZ_ATOL
            assert not (args[2] != c_args[2]).sum()
            for name in ("ious_anchor", "ious_corrected", "loss_per_anchor"):
                assert np.abs(kwargs[name] - c_kwargs[name]).max() <= VIZ_ATOL, name
            for name in ("grad_scores", "grad_scores_detached"):
                excess = (np.abs(kwargs[name] - c_kwargs[name])
                          - VIZ_GRAD_RTOL * np.abs(c_kwargs[name]))
                assert excess.max() <= VIZ_GRAD_ATOL, name


# ---- the yuv420 upload wire ----

def test_evaluate_through_the_yuv420_wire_matches_rgb8_and_the_cpu(model, cpu_model, tmp_path):
    """evaluate() over the planted scenes written at 1280x960 (each pixel
    replicated 2x2, so that the 0.5 level sees the patches as the 640-px
    eval does; batch 2, WIRE_LEVELS, no TTA, threshold 0.5) with
    upload_pixel_format rgb8 and yuv420: mAP@0.50 1.0 under both and on the
    CPU under yuv420, the card's yuv420 hits equal to the CPU's (scores
    1e-4, boxes 1 px), the hat kernel launched; the wire takes half the
    bytes of rgb8 (1.5 against 3 B/px)."""
    from os2d_torch.data.dataloader import DataloaderOneShotDetection
    from os2d_torch.ops.pixel_format import rgb_to_yuv420

    root = str(tmp_path)
    loader = DataloaderOneShotDetection(
        scenes_mod.dataset(root, scenes_mod.write_planted_dataset(root, IMG_W // 640),
                           "planted-wire", IMG_W),
        batch_size=2, pyramid_scales_eval=WIRE_LEVELS)
    cfg = eval_cfg()
    cfg.eval.class_image_augmentation = ""
    cfg.eval.batch_size = 2
    outs = {}
    with Launches() as launched:
        for fmt in ("rgb8", "yuv420"):
            cfg.tpu.upload_pixel_format = fmt
            outs[fmt] = _detections_file(loader, model, cfg, os.path.join(root, fmt))
    cpu_res, cpu_dets = _detections_file(loader, cpu_model, cfg, os.path.join(root, "cpu"))
    assert outs["rgb8"][0]["mAP@0.50"] == outs["yuv420"][0]["mAP@0.50"] == 1.0
    assert cpu_res["mAP@0.50"] == 1.0
    assert planted_hits_agree(outs["yuv420"][1], outs["rgb8"][1], float("inf"),
                              float("inf"))[0]
    agree, diff = planted_hits_agree(outs["yuv420"][1], cpu_dets)
    assert agree, diff
    assert launched["hat"] > 0
    stacked = np.stack(next(loader.make_raw_iterator_for_all_images(2))[1])
    assert rgb_to_yuv420(stacked).data.nbytes * 2 == stacked.nbytes
