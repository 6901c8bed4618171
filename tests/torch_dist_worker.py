"""What each rank of tests/test_torch_distributed.py runs, in a process of
its own (os2d_torch.parallel.spawn.run_local_group). It imports the port and
torch only, so that a rank starts quickly and without JAX.

`rank_checks(mesh, inputs)` runs every check of one group and returns plain
numbers and numpy arrays to the parent; rank 0 also writes its final train
weights to inputs["out_dir"].
"""

import hashlib
import logging
import os

import numpy as np
import torch

from os2d_torch.config import get_default_cfg
from os2d_torch.data.dataloader import DataloaderOneShotDetection
from os2d_torch.data.dataset import DatasetOneShotDetection
from os2d_torch.engine.evaluate import Evaluator, evaluate
from os2d_torch.engine.objective import ObjectiveConfig, compute_objective
from os2d_torch.engine.optimization import create_optimizer
from os2d_torch.engine.train import (
    TrainStep,
    prepare_batch_arrays,
    train_one_batch,
    trainable_parameters,
)
from os2d_torch.models import Os2dConfig, Os2dModel
from os2d_torch.parallel import all_gather_cat, all_reduce_sum_, gather_rows, local_rows, make_mesh
from os2d_torch.utils.logger import checkpoint_model, load_checkpoint

THREADS = 2
TRAIN_CONFIG = Os2dConfig(class_image_size=128, resample_precision="highest")
EVAL_CONFIG = Os2dConfig(resample_precision="highest")


def train_cfg():
    """tests/test_torch_train_step.py's recipe (test_torch_train_data.train_cfg
    without augmentation, lr 1e-3)."""
    cfg = get_default_cfg()
    cfg.train.batch_size = 2
    cfg.train.class_batch_size = 4
    cfg.train.augment.train_patch_width = 320
    cfg.train.augment.train_patch_height = 320
    cfg.model.class_image_size = 128
    cfg.eval.train_subset_for_eval_size = 0
    cfg.train.augment.scale_jitter = 1.0
    cfg.train.augment.jitter_aspect_ratio = 1.0
    cfg.train.optim.lr = 1e-3
    return cfg


def eval_cfg(shard_axis="classes", prescreen=False):
    """The planted eval: TTA "horflip" (4 class rows for 2 classes), class
    chunks of 2 (3 under a 3-rank mesh: 2 chunks, the last padded), one
    pyramid level, a finite score threshold when the prescreen runs."""
    cfg = get_default_cfg()
    cfg.eval.class_image_augmentation = "horflip"
    cfg.eval.mAP_iou_thresholds = [0.5]
    cfg.eval.batch_size = 2
    cfg.tpu.eval_class_chunk = 2
    cfg.tpu.eval_shard_axis = shard_axis
    cfg.eval.nms_score_threshold = 0.5 if prescreen else float("-inf")
    return cfg


def params_digest(model):
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def train_steps(mesh, inputs):
    """The data-parallel steps on the global batches, then one step on a
    batch holding a NaN, which every rank dumps."""
    model = Os2dModel(TRAIN_CONFIG, device="cpu")
    model.load_state_dict(inputs["start"])
    cfg = train_cfg()
    optimizer = create_optimizer(cfg.train.optim, trainable_parameters(model, cfg.train))
    step = TrainStep(model, ObjectiveConfig(), optimizer, cfg.train, mesh=mesh)
    metrics = [step(*prepare_batch_arrays(batch, "cpu")) for batch in inputs["batches"]]
    out = {"metrics": metrics, "digest": params_digest(model)}
    if mesh.rank == 0:
        torch.save(model.state_dict(), os.path.join(inputs["out_dir"], "dp_final.pth"))
    out["dcp"] = dcp_round_trip(mesh, model, optimizer, cfg, inputs["out_dir"])

    arrays, c_pad = prepare_batch_arrays(inputs["batches"][0], "cpu")
    images = arrays["images"].float()
    images[-1, 0, 0, 0] = float("nan")  # in the last rank's rows
    arrays["images"] = images
    nan_dir = os.path.join(inputs["out_dir"], "nan")
    os.makedirs(nan_dir, exist_ok=True)
    meters = train_one_batch(None, step, logging.getLogger("OS2D.test_dist"), dump_dir=nan_dir,
                             prepared=(arrays, c_pad))
    out["nan_grad_norm"] = meters["grad_norm"]
    out["nan_digest"] = params_digest(model)  # the update was skipped
    return out


def dcp_round_trip(mesh, model, optimizer, cfg, out_dir):
    """checkpoint_model(backend="orbax") with the group up: every rank
    calls it and rank 0 alone writes; after a barrier every rank restores
    the stub into a fresh model and optimizer. Returns the restored
    weights' digest and whether the restored optimizer state equals the
    rank's own."""
    path = checkpoint_model(model, optimizer, out_dir, model_name="dcp", backend="orbax")
    mesh.barrier()
    payload = load_checkpoint(path)
    restored = Os2dModel(TRAIN_CONFIG, device="cpu", seed=7)
    restored.load_state_dict(payload["net"])
    restored_opt = create_optimizer(cfg.train.optim, trainable_parameters(restored, cfg.train))
    restored_opt.load_state_dict(payload["optimizer"])
    want, got = optimizer.state_dict(), restored_opt.state_dict()
    optimizer_equal = got["param_groups"] == want["param_groups"] and all(
        torch.equal(got["state"][i][k], v) for i, s in want["state"].items()
        for k, v in s.items())
    return {"digest": params_digest(restored), "optimizer_equal": optimizer_equal}


def gather_checks(mesh, seed=0):
    """gather_rows' backward returns this rank's rows; the objective on
    gathered predictions equals the single-process objective when the hard
    negatives come from every rank's rows, while a mean of per-rank losses
    does not."""
    rng = np.random.RandomState(seed)
    b, labels, anchors = 2 * mesh.size, 3, 50
    cls_all = torch.as_tensor(rng.uniform(-1, 1, (b, labels, anchors)), dtype=torch.float32)
    loc_all = torch.as_tensor(rng.randn(b, labels, 4, anchors), dtype=torch.float32)
    loc_t = torch.as_tensor(rng.randn(b, labels, 4, anchors), dtype=torch.float32)
    cls_t = torch.zeros((b, labels, anchors), dtype=torch.long)
    cls_t[0, :, :5] = 1  # every positive in the first rank's rows
    cls_t[:, :, -3:] = -1
    cls_all[0, :, 5:] -= 1.0  # the hardest negatives in the other ranks' rows
    cfg = ObjectiveConfig(class_loss="ContrastiveLoss", neg_to_pos_ratio=3.0)
    rows = local_rows(mesh, b)

    cls_local = cls_all[rows].clone().requires_grad_(True)
    loc_local = loc_all[rows].clone().requires_grad_(True)
    losses, per_anchor = compute_objective(cfg, gather_rows(mesh, loc_local), loc_t,
                                           gather_rows(mesh, cls_local), cls_t,
                                           want_per_anchor=True)
    losses["loss"].backward()

    cls_single = cls_all.clone().requires_grad_(True)
    loc_single = loc_all.clone().requires_grad_(True)
    single = compute_objective(cfg, loc_single, loc_t, cls_single, cls_t)
    single["loss"].backward()

    per_rank = compute_objective(cfg, loc_all[rows], loc_t[rows], cls_all[rows], cls_t[rows])
    mean = per_rank["loss"].detach().reshape(1) / mesh.size
    all_reduce_sum_(mesh, [mean])

    weights = torch.as_tensor(rng.randn(b, 7), dtype=torch.float32)
    x = weights[rows].clone().requires_grad_(True)
    (gather_rows(mesh, x) * weights * 3.0).sum().backward()
    return {
        "loss": float(losses["loss"]), "single_loss": float(single["loss"]),
        "per_rank_mean": float(mean[0]),
        "negs_per_image": per_anchor["neg_mask"].sum(dim=(1, 2)).tolist(),
        "cls_grad": cls_local.grad.numpy(), "single_cls_grad": cls_single.grad[rows].numpy(),
        "loc_grad": loc_local.grad.numpy(), "single_loc_grad": loc_single.grad[rows].numpy(),
        "x_grad": x.grad.numpy(), "x_grad_want": (3.0 * weights[rows]).numpy(),
    }


def eval_loader(inputs, batch_size=2):
    root = inputs["eval_root"]
    dataset = DatasetOneShotDetection(
        inputs["eval_df"], gt_path=os.path.join(root, "classes", "images"),
        image_path=os.path.join(root, "src"), name="planted", image_size=inputs["eval_size"],
        eval_scale=inputs["eval_size"], cache_images=True)
    return DataloaderOneShotDetection(dataset=dataset, batch_size=batch_size,
                                      pyramid_scales_eval=[1.0])


def eval_outputs(model, loader, cfg, mesh=None, losses=False):
    """{name: packed detections of the planted batch} from detect_images
    and, with a finite threshold, detect_images_prescreened, the results of
    evaluate() and, with `losses`, of evaluate() with the objective as its
    criterion; the same calls with and without a mesh."""
    evaluator = Evaluator(model, cfg, mesh=mesh)
    class_images, _, _ = loader.get_all_class_images()
    head, num_views = evaluator.build_class_heads(class_images, cfg.eval.class_image_augmentation)
    ids, images, sizes, inv, _ = next(iter(loader.make_raw_iterator_for_all_images(2)))
    images = np.stack(images)
    out = {"packed": evaluator.detect_images(images, head, sizes, inv[0],
                                             loader.img_normalization, num_views).numpy()}
    if evaluator.prescreen_applicable():
        out["prescreened"] = evaluator.detect_images_prescreened(
            images, head, sizes, inv[0], loader.img_normalization, num_views).numpy()
        out["pruned"] = evaluator.prescreen_pruned
    out["results"] = evaluate(loader, model, cfg, mesh=mesh)
    if losses:
        out["loss_results"] = evaluate(loader, model, cfg, criterion=ObjectiveConfig(), mesh=mesh)
    return out


EVAL_CASES = {  # name: (eval_cfg arguments, whether the loss metrics run too)
    "classes": (dict(shard_axis="classes"), True),
    "classes_prescreen": (dict(shard_axis="classes", prescreen=True), False),
    "images": (dict(shard_axis="images"), True),
}


def eval_cases(world_size):
    return [name for name in EVAL_CASES if name != "images" or 2 % world_size == 0]


def rank_checks(mesh, inputs):
    torch.set_num_threads(THREADS)
    out = {"rank": mesh.rank, "size": mesh.size}
    # a mesh over the first 2 ranks: the others get none (every rank calls)
    sub = make_mesh(2, device="cpu")
    out["submesh"] = None if sub is None else (
        sub.rank, sub.size, all_gather_cat(sub, torch.tensor([float(mesh.rank)])).tolist())
    if inputs.get("train"):
        out["train"] = train_steps(mesh, inputs)
        out["gather"] = gather_checks(mesh)
    model = Os2dModel(EVAL_CONFIG, device="cpu")
    loader = eval_loader(inputs)
    out["eval"] = {name: eval_outputs(model, loader, eval_cfg(**EVAL_CASES[name][0]), mesh,
                                      losses=EVAL_CASES[name][1])
                   for name in eval_cases(mesh.size)}
    return out


def pretrain_rank(mesh, inputs):
    """The ImageNet pretrainer over the mesh (os2d_torch/pretrain): from the
    classifier of seed inputs["seed"] in fp64, make_train_step's steps on
    the global batches inputs["batches"] (rank 0 writes the final state to
    <out_dir>/pretrain_mesh.pth); then train() at inputs["train_kwargs"] on
    an image folder, which rank 0 alone exports. Returns the step metrics
    and the digests of the rank's weights after each part."""
    from os2d_torch.pretrain import train_imagenet

    torch.set_num_threads(THREADS)
    model = train_imagenet.init_classifier("resnet50", inputs["num_classes"], "cpu",
                                           inputs["seed"]).double()
    optimizer = train_imagenet.ChainSGD(model.parameters(), train_imagenet.
                                        piecewise_constant_schedule(0.125, {1: 0.5, 2: 0.5}))
    step = train_imagenet.make_train_step(model, optimizer, torch.float64, mesh)
    metrics = [{k: float(v) for k, v in step(torch.from_numpy(images),
                                             torch.from_numpy(labels)).items()}
               for images, labels in inputs["batches"]]
    if mesh.rank == 0:
        torch.save(model.state_dict(), os.path.join(inputs["out_dir"], "pretrain_mesh.pth"))
    out = {"metrics": metrics, "digest": params_digest(model)}
    trained = train_imagenet.train(**inputs["train_kwargs"], mesh=mesh)
    out["train_digest"] = params_digest(trained)
    return out
