"""INSTRE training and evaluation jobs with the PyTorch port (twin of
launcher_instre_eval.py: instre-s1 @700, instre-s2 @600, both with rotation90
class TTA; --train queues the training jobs instead).

Each job runs `python -m os2d_torch.main` (under torchrun with --num-gpus
N > 1). In a --model-path folder the checkpoint is --model-checkpoint, the
JAX trainer's file name by default, or the port's `.pth` of the same name
where only that one exists.
Run: python experiments/launcher_instre_eval_torch.py [--train] [--no-launch|--slurm ...]
"""

import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
from collections import OrderedDict

from os2d_torch.utils import launcher

EVAL_DATASETS = {
    "instre-s1-test": {"scales": "[700.0]",
                       "extra": {"eval.class_image_augmentation": "rotation90"}},
    "instre-s2-test": {"scales": "[600.0]",
                       "extra": {"eval.class_image_augmentation": "rotation90"}},
}


def create_args_parser():
    parser = launcher.create_args_parser()
    parser.add_argument("--model-path", type=str, default="output/instre")
    parser.add_argument("--model-checkpoint", type=str,
                        default="checkpoint_best_model_instre-s1-val_mAP@0.50.pkl")
    parser.add_argument("--backbone-arch", type=str, default="ResNet50")
    parser.add_argument("--train", action="store_true",
                        help="Queue the INSTRE training jobs instead of eval")
    return parser


def build_jobs(args):
    """The training (--train) or eval jobs on a `launcher.JobQueue`."""
    config_path = os.path.dirname(os.path.abspath(__file__))
    config_file = os.path.join(config_path, "config_training.yml")
    log_path = os.path.abspath(os.path.join(config_path, "..", "output/instre"))
    queue = launcher.JobQueue()

    if args.train:
        for i, subset in enumerate(["instre-s1", "instre-s2"]):
            d = OrderedDict()
            d["--config-file"] = config_file
            d["model.backbone_arch"] = args.backbone_arch
            d["train.dataset_name"] = f"{subset}-train"
            d["train.dataset_scale"] = "700.0" if subset == "instre-s1" else "600.0"
            d["eval.dataset_names"] = f'"[\\"{subset}-val\\"]"'
            d["eval.dataset_scales"] = "[700.0]" if subset == "instre-s1" else "[600.0]"
            log_folder = os.path.join(log_path, f"train_{subset}")
            d["output.path"] = log_folder
            queue.add_job(f"instre-train.{i}.{subset}", log_folder,
                          [launcher.main_command(overrides=d, num_gpus=args.num_gpus)])
    else:
        model_path = launcher.resolve_checkpoint(args.model_path, args.model_checkpoint)
        for i, (eval_dataset, spec) in enumerate(EVAL_DATASETS.items()):
            d = OrderedDict()
            d["--config-file"] = config_file
            d["model.backbone_arch"] = args.backbone_arch
            d["init.model"] = model_path
            d["train.do_training"] = False
            d["eval.dataset_names"] = f'"[\\"{eval_dataset}\\"]"'
            d["eval.dataset_scales"] = spec["scales"]
            d.update(spec["extra"])
            log_folder = os.path.join(log_path, eval_dataset)
            d["output.path"] = log_folder
            queue.add_job(f"instre-eval.{i}.{eval_dataset}", log_folder,
                          [launcher.main_command(overrides=d, num_gpus=args.num_gpus)],
                          log_file_prefix=f"eval_{eval_dataset}_")
    return queue


if __name__ == "__main__":
    args = create_args_parser().parse_args()
    build_jobs(args).launch_all_jobs(args)
