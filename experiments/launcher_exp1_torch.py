"""Experiment 1 with the PyTorch port: training-objective ablations on
GroZi-3.2k (twin of launcher_exp1.py).

The reference's experiments/launcher_exp1.py:62-233 job grid: loss type
(ContrastiveLoss vs RLL) x target remapping x hard-patch mining x affine
model variants (simplified / full inverse affine with the weakalign
transform init). Each job runs `python -m os2d_torch.main` (under torchrun
with --num-gpus N > 1).
Run: python experiments/launcher_exp1_torch.py [--no-launch|--slurm ...]
"""

import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
from collections import OrderedDict

import yaml

from os2d_torch.utils import launcher


def load_yaml(config_file):
    with open(config_file, "r") as stream:
        return yaml.safe_load(stream)


def build_jobs(args):
    """The twelve training jobs on a `launcher.JobQueue`."""
    config_path = os.path.dirname(os.path.abspath(__file__))
    config_file = os.path.join(config_path, "config_training.yml")
    config = load_yaml(config_file)
    config_job_name = "exp1"
    log_path = os.path.abspath(os.path.join(config_path, "..", "output/exp1"))
    queue = launcher.JobQueue()

    def add_job(job_name, sub_index, backbone_arch, init_model_nickname,
                init_model_path, extra_params=None):
        job_name = f"{config_job_name}.{sub_index}.{job_name}_seed{config['random_seed']}"
        d = OrderedDict()
        d["--config-file"] = config_file
        d["model.backbone_arch"] = backbone_arch
        d["init.model"] = init_model_path
        log_folder = os.path.join(
            log_path, f"{job_name}_{backbone_arch}_init_{init_model_nickname}"
        )
        d["output.path"] = log_folder
        if extra_params:
            d.update(extra_params)
        queue.add_job(job_name, log_folder,
                      [launcher.main_command(overrides=d, num_gpus=args.num_gpus)])

    init_path = "models/imagenet-caffe-resnet50-features-ac468af-converted.pth"
    init_nick = "imageNetCaffe2"
    simplified = {
        "model.use_inverse_geom_model": False,
        "model.use_simplified_affine_model": True,
        "train.objective.loc_weight": 0.2,
        "train.model.freeze_bn_transform": False,
    }
    full_affine = {
        "model.use_inverse_geom_model": True,
        "model.use_simplified_affine_model": False,
        "train.objective.loc_weight": 0.0,
        "train.model.freeze_bn_transform": True,
        "init.transform": "models/weakalign_resnet101_affine_tps.pth.tar",
    }
    contrastive = {
        "train.objective.class_objective": "ContrastiveLoss",
        "train.objective.pos_margin": 1.0,
        "train.objective.neg_margin": 0.5,
        "train.objective.remap_classification_targets": False,
    }
    no_remap = {"train.objective.remap_classification_targets": False}
    mine = {"train.mining.do_mining": True}

    add_job("lossCL", 0, "ResNet50", init_nick, init_path, {**simplified, **contrastive})
    add_job("lossRLL", 1, "ResNet50", init_nick, init_path, {**simplified, **no_remap})
    add_job("lossRLL_remap", 2, "ResNet50", init_nick, init_path, {**simplified})
    add_job("lossCL_mine", 3, "ResNet50", init_nick, init_path,
            {**simplified, **contrastive, **mine})
    add_job("lossRLL_mine", 4, "ResNet50", init_nick, init_path,
            {**simplified, **no_remap, **mine})
    add_job("lossRLL_remap_mine", 5, "ResNet50", init_nick, init_path, {**simplified, **mine})
    add_job("lossRLL_remap_invFullAffine", 6, "ResNet50", init_nick, init_path,
            {**full_affine, "train.objective.loc_weight": 0.2})
    add_job("lossRLL_remap_invFullAffine_initTranform", 7, "ResNet50", init_nick, init_path,
            {**full_affine, "train.objective.loc_weight": 0.2})
    add_job("lossRLL_remap_invFullAffine_initTranform_zeroLocLoss", 8, "ResNet50", init_nick,
            init_path, {**full_affine})
    add_job("lossRLL_remap_invFullAffine_initTranform_zeroLocLoss_mine", 9, "ResNet50",
            init_nick, init_path, {**full_affine, **mine})
    add_job("lossCL_invFullAffine_initTranform_zeroLocLoss", 10, "ResNet50", init_nick,
            init_path, {**full_affine, **contrastive})
    add_job("lossRLL_invFullAffine_initTranform_zeroLocLoss", 11, "ResNet50", init_nick,
            init_path, {**full_affine, **no_remap})
    return queue


if __name__ == "__main__":
    args = launcher.create_args_parser().parse_args()
    build_jobs(args).launch_all_jobs(args)
