"""Experiment 2 with the PyTorch port: backbone-initialization ablations,
V1/V2 x init sources (twin of launcher_exp2.py).

The reference's experiments/launcher_exp2.py job grid: V1 (ResNet101,
simplified affine) and V2 (ResNet50, inverse full affine) trained from
different backbone inits (torchvision ImageNet, caffe2 ImageNet, cirtorch
landmarks, maskrcnn-benchmark detection, GroupNorm variants). Each job runs
`python -m os2d_torch.main` (under torchrun with --num-gpus N > 1).
Run: python experiments/launcher_exp2_torch.py [--no-launch|--slurm ...]
"""

import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
from collections import OrderedDict

from os2d_torch.utils import launcher

INITS_R50 = [
    ("imageNetPth", "models/resnet50-19c8e357.pth", {}),
    ("imageNetCaffe2", "models/imagenet-caffe-resnet50-features-ac468af-converted.pth", {}),
    ("imageNetCaffe2GroupNorm",
     "models/resnet50_caffe2_groupnorm-converted.pth",
     {"model.use_group_norm": True}),
    ("cocoMaskrcnnFpn", "models/maskrcnn_R_50_FPN_converted.pth", {}),
    ("buildingsCirtorch", "models/cirtorch_R50_buildings-converted.pth", {}),
]
INITS_R101 = [
    ("imageNetPth", "models/resnet101-5d3b4d8f.pth", {}),
    ("imageNetCaffe2", "models/imagenet-caffe-resnet101-features-10a101d-converted.pth", {}),
    ("buildingsCirtorch", "models/cirtorch_R101_buildings-converted.pth", {}),
    ("cocoMaskrcnnFpn", "models/maskrcnn_R_101_FPN_converted.pth", {}),
    ("pascalWeakalign", "models/weakalign_resnet101_affine_tps.pth.tar", {}),
]


def build_jobs(args):
    """The ten training jobs on a `launcher.JobQueue`."""
    config_path = os.path.dirname(os.path.abspath(__file__))
    config_file = os.path.join(config_path, "config_training.yml")
    log_path = os.path.abspath(os.path.join(config_path, "..", "output/exp2"))
    queue = launcher.JobQueue()

    def add_job(sub_index, variant, backbone_arch, init_nick, init_path, extra=None):
        job_name = f"exp2.{sub_index}.{variant}_seed0"
        d = OrderedDict()
        d["--config-file"] = config_file
        d["model.backbone_arch"] = backbone_arch
        d["init.model"] = init_path
        if variant == "v1":
            d["model.use_inverse_geom_model"] = False
            d["model.use_simplified_affine_model"] = True
            d["train.objective.loc_weight"] = 0.2
            d["train.model.freeze_bn_transform"] = False
        else:
            d["model.use_inverse_geom_model"] = True
            d["model.use_simplified_affine_model"] = False
            d["train.objective.loc_weight"] = 0.0
            d["train.model.freeze_bn_transform"] = True
            d["init.transform"] = "models/weakalign_resnet101_affine_tps.pth.tar"
        if extra:
            d.update(extra)
        log_folder = os.path.join(log_path, f"{job_name}_{backbone_arch}_init_{init_nick}")
        d["output.path"] = log_folder
        queue.add_job(job_name, log_folder,
                      [launcher.main_command(overrides=d, num_gpus=args.num_gpus)])

    i = 0
    for nick, path, extra in INITS_R50:
        add_job(i, "v2", "ResNet50", nick, path, extra)
        i += 1
    for nick, path, extra in INITS_R101:
        add_job(i, "v1", "ResNet101", nick, path, extra)
        i += 1
    return queue


if __name__ == "__main__":
    args = launcher.create_args_parser().parse_args()
    build_jobs(args).launch_all_jobs(args)
