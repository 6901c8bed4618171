"""CLI: training and evaluation with the PyTorch port (the JAX package's
main.py; the reference's main.py:15-98), with the same config grammar:

    python -m os2d_torch.main --config-file FILE [key value ...]

On a node of several cards, one process per card:

    torchrun --nproc_per_node=N -m os2d_torch.main --config-file FILE \\
        tpu.distributed_init True [key value ...]

tpu.distributed_init joins the process group that torchrun describes
(parallel.init_distributed: nccl on cuda:LOCAL_RANK); tpu.mesh_data_axis
then sets the mesh as in the JAX package: -1 every rank, 0 or 1 none, n the
first n ranks (the others have no work), more ranks than exist a warning and
no mesh. Training over the mesh is data parallel and evaluation shards as
tpu.eval_shard_axis says (engine/train.py, engine/evaluate.py). Datasets are
read under $DATA_PATH (default: data/ beside the package). The model runs on
the card unless OS2D_DEVICE names another device ("cpu": the kernels' plain
versions; the process group is then gloo).
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from .config import get_default_cfg
from .data.dataloader import build_eval_dataloaders_from_cfg, build_train_dataloader_from_config
from .engine.objective import ObjectiveConfig
from .engine.optimization import create_optimizer
from .engine.train import trainable_parameters, trainval_loop
from .models import Os2dConfig, Os2dModel
from .models.checkpoint import import_weakalign_checkpoint, load_checkpoint_file
from .parallel import init_distributed, make_mesh
from .utils.logger import load_checkpoint, set_random_seed, setup_logger


def get_data_path():
    return os.environ.get(
        "DATA_PATH", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                  "data"))


def parse_opts(argv=None):
    parser = argparse.ArgumentParser(
        description="Training and evaluation of OS2D with the PyTorch port")
    parser.add_argument("--config-file", default="", metavar="FILE", help="path to config file",
                        type=str)
    parser.add_argument("opts", help="Modify config options from the command line",
                        default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cfg = get_default_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    return cfg, args.config_file


def build_model_from_config(cfg, logger, device):
    """The model of cfg.model and cfg.tpu's numerics on `device`, seeded from
    cfg.random_seed, then cfg.init.model through the checkpoint cascade
    (models/checkpoint.py) and cfg.init.transform as a weakalign checkpoint.
    Returns (model, the checkpoint's optimizer state or None)."""
    config = Os2dConfig(
        backbone_arch=cfg.model.backbone_arch.lower(),
        merge_branch_parameters=cfg.model.merge_branch_parameters,
        use_inverse_geom_model=cfg.model.use_inverse_geom_model,
        use_simplified_affine_model=cfg.model.use_simplified_affine_model,
        use_group_norm=cfg.model.use_group_norm,
        class_image_size=cfg.model.class_image_size,
        normalization_mean=tuple(cfg.model.normalization_mean),
        normalization_std=tuple(cfg.model.normalization_std),
        compute_dtype=cfg.tpu.compute_dtype,
        resample_precision=cfg.tpu.resample_precision,
        corr_interior_first=cfg.tpu.corr_interior_first,
    )
    model = Os2dModel(config, device=device, seed=int(cfg.random_seed))
    optimizer_state = None
    if cfg.init.model:
        logger.info(f"Loading model weights from {cfg.init.model}")
        state_dict, optimizer_state = load_checkpoint_file(cfg.init.model, config, model)
        model.load_state_dict(state_dict)
    if cfg.init.transform:
        logger.info(f"Loading transform weights from {cfg.init.transform}")
        data = torch.load(cfg.init.transform, map_location="cpu", weights_only=True)
        model.load_state_dict(import_weakalign_checkpoint(data["state_dict"], config, model))
    return model, optimizer_state


def objective_config_from_cfg(cfg) -> ObjectiveConfig:
    obj = cfg.train.objective
    return ObjectiveConfig(
        class_loss=obj.class_objective, margin=obj.neg_margin, margin_pos=obj.pos_margin,
        class_loss_neg_weight=obj.class_neg_weight,
        remap_classification_targets=obj.remap_classification_targets,
        localization_weight=obj.loc_weight, neg_to_pos_ratio=obj.neg_to_pos_ratio,
        rll_neg_weight_ratio=obj.rll_neg_weight_ratio)


def requested_mesh_size(cfg, world_size: int, logger) -> int:
    """The mesh size that cfg.tpu.mesh_data_axis asks for among `world_size`
    ranks (main.py:176-195): -1 all of them, n the first n; 0 or 1, one
    rank, or more than exist (with a warning) mean no mesh, returned as 1."""
    axis = int(cfg.tpu.mesh_data_axis)
    if axis in (0, 1):
        return 1
    want = world_size if axis < 0 else axis
    if want > world_size:
        logger.warning(f"cfg.tpu.mesh_data_axis={axis} requests {want} devices but only "
                       f"{world_size} are visible; running single-device")
        return 1
    return max(want, 1)


def main(argv=None):
    cfg, config_file = parse_opts(argv)
    device = os.environ.get("OS2D_DEVICE", "cuda")
    joined = bool(cfg.tpu.distributed_init)
    if joined:
        device = init_distributed(device=None if device == "cuda" else device)
    try:
        return _run(cfg, config_file, device)
    finally:
        if joined:
            dist.destroy_process_group()


def _run(cfg, config_file, device):
    logger = setup_logger("OS2D", cfg.output.path if cfg.output.save_log_to_file else None)
    if config_file:
        logger.info(f"Loaded configuration file {config_file}")
    set_random_seed(cfg.random_seed)

    model, _ = build_model_from_config(cfg, logger, device)
    objective_cfg = objective_config_from_cfg(cfg)
    optimizer = create_optimizer(cfg.train.optim, trainable_parameters(model, cfg.train))

    img_normalization = {"mean": cfg.model.normalization_mean,
                         "std": cfg.model.normalization_std}
    data_path = get_data_path()
    if cfg.train.do_training:
        dataloader_train, datasets_train_subset_for_eval = build_train_dataloader_from_config(
            cfg, img_normalization, data_path=data_path)
    else:
        dataloader_train, datasets_train_subset_for_eval = None, []
    dataloaders_eval = build_eval_dataloaders_from_cfg(
        cfg, img_normalization, datasets_for_eval=datasets_train_subset_for_eval,
        data_path=data_path)

    start_iter, full_log = 0, None
    if cfg.tpu.resume:
        ckpt = load_checkpoint(cfg.tpu.resume)
        model.load_state_dict(ckpt["net"])
        if ckpt.get("optimizer") is not None:
            optimizer.load_state_dict(ckpt["optimizer"])
        start_iter = int(ckpt.get("i_iter") or 0)
        full_log = ckpt.get("full_log")
        logger.info(f"Resuming from {cfg.tpu.resume} at iter {start_iter}")

    # the mesh: data-parallel training and sharded eval
    world_size = dist.get_world_size() if dist.is_initialized() else 1
    size = requested_mesh_size(cfg, world_size, logger)
    mesh = make_mesh(size, model.device) if size > 1 else None
    if size > 1:
        if mesh is None:
            logger.info(f"rank {dist.get_rank()} is outside the {size}-rank mesh; it has no work")
            return None
        logger.info(f"Using a {size}-device mesh for training/eval")

    return trainval_loop(dataloader_train, model, cfg, objective_cfg, optimizer,
                         dataloaders_eval=dataloaders_eval, start_iter=start_iter,
                         full_log=full_log, mesh=mesh)


if __name__ == "__main__":
    main()
