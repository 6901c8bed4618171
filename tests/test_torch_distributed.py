"""The port's mesh (os2d_torch/parallel) on the CPU: ranks spawned over gloo,
each a process of its own (tests/torch_dist_worker.py), one group per world
size for the whole module, with a deadline on each.

- Data-parallel `TrainStep` on 2 ranks, 3 steps on global batches of 2 at
  tests/test_torch_train_step.py's recipe (full-width ResNet50-C4, 320x320
  patches, class images of 128 px, "highest"): losses equal the port's
  single-process step on the global batch (rtol 2e-5), the final weights
  too (rtol 1e-4, atol 1e-6), the ranks' weights are equal to the bit, and
  the losses equal the JAX package's single-device step from the same
  weights on the same batches within test_torch_train_step.py's tolerances
  (XLA makes JAX's sharded step equal that one).
- `gather_rows`' backward keeps the rank's own rows, and a contrastive
  objective whose hard negatives come from both ranks' rows equals the
  single-process one (a mean of per-rank losses does not).
- A step fed a NaN dumps on every rank, with the rank in the file name, the
  whole batch, and a single-process replay reaches the same non-finite
  gradient norm.
- Eval sharded by classes (2 and 3 ranks; 4 class rows, chunks of 2 rounded
  to 3 under 3 ranks), with and without the prescreen, and by images (2
  ranks): the packed detections equal the unsharded ones (scores atol 1e-5,
  boxes 1e-2 px, valid flags equal), and so do the mAP of evaluate() and,
  without the prescreen, its loss metrics (rtol 1e-5).
- `make_mesh(2)` over 3 ranks takes the first two; the mesh rules raise as
  JAX's do, without a group.
"""

import concurrent.futures
import math
import os
import random

import jax
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from os2d_tpu.config import get_default_cfg as jax_default_cfg
from os2d_tpu.data.dataloader import build_train_dataloader_from_config as jax_build
from os2d_tpu.engine.objective import ObjectiveConfig as JaxObjectiveConfig
from os2d_tpu.engine.optimization import create_optimizer as jax_create_optimizer
from os2d_tpu.engine.train import TrainStep as JaxTrainStep
from os2d_tpu.engine.train import build_trainable_mask as jax_trainable_mask
from os2d_tpu.engine.train import prepare_batch_arrays as jax_prepare
from os2d_tpu.models import Os2dConfig as JaxOs2dConfig
from os2d_tpu.models import init_os2d_params
from os2d_torch.engine.evaluate import Evaluator
from os2d_torch.engine.objective import ObjectiveConfig
from os2d_torch.engine.optimization import create_optimizer
from os2d_torch.engine.train import (
    TrainStep,
    load_nan_reproducer,
    prepare_batch_arrays,
    trainable_parameters,
    trainval_loop,
)
from os2d_torch.models import Os2dModel
from os2d_torch.models.from_jax import state_dict_from_jax
from os2d_torch.parallel import Mesh, local_rows
from os2d_torch.parallel.spawn import run_local_group
from os2d_torch.structures.feature_map import FeatureMapSize
from test_end_to_end_eval import IMG_W, make_synthetic_dataset
from test_train import make_dataset
from test_torch_train_data import train_cfg as jax_train_cfg

STEPS = 3
LOSS_RTOL = 2e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6
JAX_FIRST_RTOL, JAX_TRAJECTORY_RTOL = 1e-4, 1e-3  # tests/test_torch_train_step.py
SCORE_ATOL, BOX_ATOL = 1e-5, 1e-2
LOSS_METRIC_RTOL = 1e-5
GROUP_TIMEOUT_S = 300
CPU = torch.device("cpu")
PREPARE_KEYS = ("images", "class_images", "class_ids", "gt_boxes", "gt_labels", "gt_difficult",
                "gt_valid")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both groups, run while this process takes the single-process steps of
    both packages and the unsharded evals."""
    tmp = tmp_path_factory.mktemp("distributed")
    jds = make_dataset(str(tmp / "train"), np.random.RandomState(0))
    jcfg = jax_train_cfg(jax_default_cfg(), augment=False)
    jcfg.train.optim.lr = 1e-3
    random.seed(3)
    jloader, _ = jax_build(jcfg, dataset_train=jds)
    batches = [jloader.get_batch(0) for _ in range(STEPS)]
    # what prepare_batch_arrays reads, in types that a rank unpickles
    # without importing the JAX package
    port_batches = [dict({k: b[k] for k in PREPARE_KEYS},
                         img_size=FeatureMapSize(w=b["img_size"].w, h=b["img_size"].h))
                    for b in batches]
    model_cfg = JaxOs2dConfig(class_image_size=128, resample_precision="highest")
    params = init_os2d_params(jax.random.PRNGKey(1), model_cfg)
    start = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))

    eval_root = str(tmp / "eval")
    inputs = {"start": start, "batches": port_batches, "eval_root": eval_root,
              "eval_df": make_synthetic_dataset(eval_root), "eval_size": IMG_W}
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(worker.THREADS)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        groups = {}
        for world in (2, 3):
            out_dir = tmp / f"world{world}"
            out_dir.mkdir()
            args = dict(inputs, out_dir=str(out_dir), train=world == 2)
            groups[world] = pool.submit(run_local_group, worker.rank_checks, world, (args,),
                                        devices=["cpu"] * world, timeout_s=GROUP_TIMEOUT_S)
        try:
            model = Os2dModel(worker.TRAIN_CONFIG, device="cpu")
            model.load_state_dict(start)
            cfg = worker.train_cfg()
            optimizer = create_optimizer(cfg.train.optim, trainable_parameters(model, cfg.train))
            step = TrainStep(model, ObjectiveConfig(), optimizer, cfg.train)
            out["single"] = [step(*prepare_batch_arrays(b, "cpu")) for b in port_batches]
            out["single_final"] = {k: v.detach().clone() for k, v in model.state_dict().items()}

            eval_model = Os2dModel(worker.EVAL_CONFIG, device="cpu")
            loader = worker.eval_loader(inputs)
            # without a mesh the shard axis is not read: the unsharded run of
            # "classes" is that of "images" too
            unsharded, out["eval"] = {}, {}
            for name, (case, losses) in worker.EVAL_CASES.items():
                key = (case.get("prescreen", False), losses)
                if key not in unsharded:
                    unsharded[key] = worker.eval_outputs(eval_model, loader,
                                                         worker.eval_cfg(**case), losses=losses)
                out["eval"][name] = unsharded[key]

            optimizer = jax_create_optimizer(jcfg.train.optim,
                                             jax_trainable_mask(params, jcfg.train))
            opt_state = optimizer.init(params)
            jstep = JaxTrainStep(model_cfg, JaxObjectiveConfig(), optimizer, jcfg.train)
            out["jax"] = []
            for batch in batches:
                params, opt_state, m = jstep(params, opt_state, *jax_prepare(batch))
                out["jax"].append(dict(m.items()))
        finally:
            torch.set_num_threads(threads)
            for world, future in groups.items():
                out[world] = future.result()
    out["dirs"] = {world: tmp / f"world{world}" for world in (2, 3)}
    return out


def test_dp_step_losses_match_single_process(runs):
    for r in runs[2]:
        for got, want in zip(r["train"]["metrics"], runs["single"]):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)


def test_dp_step_weights_match_single_process(runs):
    got = torch.load(runs["dirs"][2] / "dp_final.pth", weights_only=True)
    want = runs["single_final"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


def test_dp_ranks_hold_equal_weights(runs):
    digests = {r["train"]["digest"] for r in runs[2]}
    assert len(digests) == 1


def test_dcp_checkpoint_under_a_process_group(runs):
    """The "orbax" backend (torch.distributed.checkpoint) with a gloo group
    up: rank 0 alone writes one stub and one tree, with no collective, and
    every rank restores the trained weights and optimizer state bit-equal."""
    assert sorted(n for n in os.listdir(runs["dirs"][2]) if "dcp" in n) == [
        "checkpoint_dcp.dcp", "checkpoint_dcp.pth"]
    for r in runs[2]:
        assert r["train"]["dcp"] == {"digest": r["train"]["digest"], "optimizer_equal": True}


def test_dp_step_losses_match_jax(runs):
    for r in runs[2]:
        got = r["train"]["metrics"]
        first, want = got[0], runs["jax"][0]
        for k in want:
            np.testing.assert_allclose(first[k], want[k], rtol=JAX_FIRST_RTOL, err_msg=k)
        np.testing.assert_allclose([m["loss"] for m in got], [m["loss"] for m in runs["jax"]],
                                   rtol=JAX_TRAJECTORY_RTOL)


def test_gather_backward_returns_the_local_rows(runs):
    for r in runs[2]:
        g = r["gather"]
        np.testing.assert_array_equal(g["x_grad"], g["x_grad_want"])


def test_objective_over_gathered_rows_matches_single_process(runs):
    for r in runs[2]:
        g = r["gather"]
        negs = np.asarray(g["negs_per_image"])
        assert negs[:2].sum() > 0 and negs[2:].sum() > 0, negs  # both ranks' rows
        np.testing.assert_allclose(g["loss"], g["single_loss"], rtol=1e-6)
        assert not math.isclose(g["per_rank_mean"], g["single_loss"], rel_tol=1e-3)
        for part in ("cls", "loc"):
            np.testing.assert_allclose(g[f"{part}_grad"], g[f"single_{part}_grad"],
                                       rtol=1e-5, atol=1e-7, err_msg=part)


def test_nan_step_dumps_the_global_batch_on_every_rank(runs):
    ranks = runs[2]
    dumps = sorted(os.listdir(runs["dirs"][2] / "nan"))
    assert sorted(d[-len("-p0.pth"):] for d in dumps) == ["-p0.pth", "-p1.pth"], dumps
    for r in ranks:
        assert not math.isfinite(r["train"]["nan_grad_norm"])
        assert r["train"]["nan_digest"] == r["train"]["digest"]  # the update was skipped
    payload = load_nan_reproducer(runs["dirs"][2] / "nan" / dumps[0], device="cpu")
    images = payload["batch_arrays"]["images"]
    assert images.shape[0] == 2 and torch.isnan(images[-1]).any()
    replay = Os2dModel(worker.TRAIN_CONFIG, device="cpu")
    replay.load_state_dict(payload["net"])
    cfg = worker.train_cfg()
    optimizer = create_optimizer(cfg.train.optim, trainable_parameters(replay, cfg.train))
    optimizer.load_state_dict(payload["optimizer"])
    metrics = TrainStep(replay, ObjectiveConfig(), optimizer, cfg.train)(
        payload["batch_arrays"], payload["num_classes"])
    assert not math.isfinite(metrics["grad_norm"])


EVAL_PARAMS = [(world, name) for world in (2, 3) for name in worker.eval_cases(world)]


@pytest.mark.parametrize("world,case", EVAL_PARAMS, ids=[f"{n}-world{w}" for w, n in EVAL_PARAMS])
def test_sharded_eval_matches_unsharded(runs, world, case):
    want = runs["eval"][case]
    for r in runs[world]:
        got = r["eval"][case]
        keys = [k for k in ("packed", "prescreened") if k in want]
        assert keys == [k for k in ("packed", "prescreened") if k in got]
        for k in keys:
            g, w = got[k], want[k]
            assert g.shape == w.shape
            np.testing.assert_array_equal(g[..., 5], w[..., 5], err_msg=f"{k} valid")
            valid = w[..., 5] > 0.5
            assert valid.any()
            np.testing.assert_allclose(g[..., 4][valid], w[..., 4][valid], atol=SCORE_ATOL)
            np.testing.assert_allclose(g[..., :4][valid], w[..., :4][valid], atol=BOX_ATOL)
        if "pruned" in want:
            assert got["pruned"] == want["pruned"]
        for k, v in want["results"].items():
            if k.startswith(("mAP", "recall", "AP_joint", "prescreen")):
                assert got["results"][k] == v, k
        if "loss_results" in want:  # the objective's terms per image, averaged
            keys = [k for k in want["loss_results"] if k.startswith(("loss", "cls_", "loc_"))]
            assert keys
            for k in keys:
                np.testing.assert_allclose(got["loss_results"][k], want["loss_results"][k],
                                           rtol=LOSS_METRIC_RTOL, err_msg=k)


@pytest.mark.parametrize("world", [2, 3])
def test_mesh_over_the_first_ranks(runs, world):
    """make_mesh(2) takes the first two ranks, as JAX's make_mesh(2) takes
    the first two devices; a rank outside it gets no mesh."""
    want = [(0, 2, [0.0, 1.0]), (1, 2, [0.0, 1.0])] + [None] * (world - 2)
    assert [r["submesh"] for r in runs[world]] == want


@pytest.mark.parametrize("axis", ["train", "images"])
def test_mesh_rules_raise_on_an_indivisible_batch(axis):
    mesh = Mesh(None, 0, 2, CPU)
    if axis == "train":
        cfg = worker.train_cfg()
        cfg.train.batch_size = 3
        with pytest.raises(ValueError, match="must be divisible by the mesh size 2"):
            trainval_loop(None, None, cfg, None, None, mesh=mesh)
        with pytest.raises(ValueError, match="do not shard over 2 ranks"):
            local_rows(mesh, 3)
    else:
        evaluator = Evaluator(None, worker.eval_cfg(shard_axis="images"), mesh=mesh)
        with pytest.raises(ValueError, match=r"image batch \(3\) to be a multiple of the mesh"):
            evaluator.check_image_batch(3)
        evaluator.check_image_batch(4)


def test_prescreen_is_off_under_image_sharding():
    mesh = Mesh(None, 0, 2, CPU)
    cfg = worker.eval_cfg(shard_axis="images", prescreen=True)
    assert not Evaluator(None, cfg, mesh=mesh).prescreen_applicable()
    assert Evaluator(None, cfg).prescreen_applicable()
    cfg = worker.eval_cfg(shard_axis="classes", prescreen=True)
    assert Evaluator(None, cfg, mesh=mesh).prescreen_applicable()
    with pytest.raises(ValueError, match="eval_shard_axis"):
        Evaluator(None, worker.eval_cfg(shard_axis="scales"), mesh=mesh)
