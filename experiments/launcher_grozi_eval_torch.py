"""Evaluation of trained models on the GroZi/retail test suite, with the
PyTorch port (twin of launcher_grozi_eval.py).

Per-dataset eval scales as in the reference's
experiments/launcher_grozi_eval.py:1-140: grozi @1280, dairy @3500, paste-v
@3500, paste-f @2000 with rotation90 class TTA. Each job runs
`python -m os2d_torch.main` (under torchrun with --num-gpus N > 1).
--model-path is a checkpoint file or a training job's folder; in a folder
the checkpoint is --model-checkpoint, the JAX trainer's file name by
default, or the port's `.pth` of the same name where only that one exists
(the checkpoint cascade, models/checkpoint.py, reads both).
Run: python experiments/launcher_grozi_eval_torch.py [--no-launch|--slurm ...]
"""

import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
from collections import OrderedDict

from os2d_torch.utils import launcher

EVAL_DATASETS = {
    "grozi-val-new-cl": {"scales": "[1280.0]", "extra": {}},
    "grozi-val-old-cl": {"scales": "[1280.0]", "extra": {}},
    "dairy": {"scales": "[3500.0]", "extra": {}},
    "paste-v": {"scales": "[3500.0]", "extra": {}},
    "paste-f": {"scales": "[2000.0]",
                "extra": {"eval.class_image_augmentation": "rotation90"}},
}


def create_args_parser():
    parser = launcher.create_args_parser()
    parser.add_argument("--model-path", type=str, required=False,
                        default="output/exp1/exp1.8.lossRLL_remap_invFullAffine_initTranform_zeroLocLoss_seed0_ResNet50_init_imageNetCaffe2",
                        help="Folder or file of the model to evaluate")
    parser.add_argument("--model-checkpoint", type=str,
                        default="checkpoint_best_model_grozi-val-new-cl_mAP@0.50.pkl")
    parser.add_argument("--backbone-arch", type=str, default="ResNet50")
    parser.add_argument("--v1", action="store_true",
                        help="Evaluate a v1 model (simplified affine)")
    return parser


def build_jobs(args):
    """The eval jobs, one per dataset, on a `launcher.JobQueue`."""
    config_path = os.path.dirname(os.path.abspath(__file__))
    log_path = os.path.abspath(os.path.join(config_path, "..", "output/eval"))
    model_path = launcher.resolve_checkpoint(args.model_path, args.model_checkpoint)

    queue = launcher.JobQueue()
    for i, (eval_dataset, spec) in enumerate(EVAL_DATASETS.items()):
        job_name = f"eval.{i}.{eval_dataset}"
        d = OrderedDict()
        d["--config-file"] = os.path.join(config_path, "config_training.yml")
        d["model.backbone_arch"] = args.backbone_arch
        if args.v1:
            d["model.use_inverse_geom_model"] = False
            d["model.use_simplified_affine_model"] = True
        else:
            d["model.use_inverse_geom_model"] = True
            d["model.use_simplified_affine_model"] = False
        d["init.model"] = model_path
        d["train.do_training"] = False
        d["eval.dataset_names"] = f'"[\\"{eval_dataset}\\"]"'
        d["eval.dataset_scales"] = spec["scales"]
        d.update(spec["extra"])
        log_folder = os.path.join(log_path, eval_dataset)
        d["output.path"] = log_folder
        queue.add_job(job_name, log_folder,
                      [launcher.main_command(overrides=d, num_gpus=args.num_gpus)],
                      log_file_prefix=f"eval_{eval_dataset}_")
    return queue


if __name__ == "__main__":
    args = create_args_parser().parse_args()
    build_jobs(args).launch_all_jobs(args)
