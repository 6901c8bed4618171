"""Collect exp1 results run with the PyTorch port into a table (twin of
launcher_exp1_collect.py): the best mAP@0.50 on grozi-val-new-cl of each
job's train_log.pkl, through os2d_torch.utils.logger.mine_log_value.
Run: python experiments/launcher_exp1_collect_torch.py
"""

import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
import pickle

from os2d_torch.utils.logger import mine_log_value

LOG_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "output/exp1"))


def collect(log_root=LOG_ROOT):
    """[(job folder, best value or None)] of every job with a train_log.pkl."""
    rows = []
    if os.path.isdir(log_root):
        for job_dir in sorted(os.listdir(log_root)):
            log_file = os.path.join(log_root, job_dir, "train_log.pkl")
            if not os.path.isfile(log_file):
                continue
            with open(log_file, "rb") as f:
                full_log = pickle.load(f)
            rows.append((job_dir, mine_log_value(full_log, "mAP@0.50_grozi-val-new-cl", "max")))
    return rows


def main(log_root=LOG_ROOT):
    rows = collect(log_root)
    print(f"{'job':<90} {'best mAP@0.50':>14}")
    for job, value in rows:
        print(f"{job:<90} {value if value is not None else 'n/a':>14}")


if __name__ == "__main__":
    main()
