"""ImageNet-RepMet episode evaluation with the PyTorch port (twin of
launcher_imagenet_eval.py): eval over the RepMet test episodes with rotation90
class TTA, one job per episode, each `python -m os2d_torch.main` (under
torchrun with --num-gpus N > 1).
Run: python experiments/launcher_imagenet_eval_torch.py [--episodes 0 1 ...] [--no-launch ...]
"""

import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
from collections import OrderedDict

from os2d_torch.utils import launcher


def create_args_parser():
    parser = launcher.create_args_parser()
    parser.add_argument("--model-path", type=str, default="")
    parser.add_argument("--backbone-arch", type=str, default="ResNet101")
    parser.add_argument("--episodes", type=int, nargs="+", default=list(range(50)))
    parser.add_argument("--eval-scale", type=float, default=250.0)
    return parser


def build_jobs(args):
    """One eval job per episode on a `launcher.JobQueue`."""
    config_path = os.path.dirname(os.path.abspath(__file__))
    log_path = os.path.abspath(os.path.join(config_path, "..", "output/eval_imagenet"))
    queue = launcher.JobQueue()
    for episode in args.episodes:
        dataset = f"imagenet-repmet-test-episode-{episode}"
        d = OrderedDict()
        d["--config-file"] = os.path.join(config_path, "config_training.yml")
        d["model.backbone_arch"] = args.backbone_arch
        if args.model_path:
            d["init.model"] = args.model_path
        d["train.do_training"] = False
        d["eval.dataset_names"] = f'"[\\"{dataset}\\"]"'
        d["eval.dataset_scales"] = f"[{args.eval_scale}]"
        d["eval.class_image_augmentation"] = "rotation90"
        log_folder = os.path.join(log_path, f"episode_{episode}")
        d["output.path"] = log_folder
        queue.add_job(f"imagenet-eval.{episode}", log_folder,
                      [launcher.main_command(overrides=d, num_gpus=args.num_gpus)],
                      log_file_prefix=f"eval_{dataset}_")
    return queue


if __name__ == "__main__":
    args = create_args_parser().parse_args()
    build_jobs(args).launch_all_jobs(args)
