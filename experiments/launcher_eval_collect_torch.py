"""Collect the results of eval jobs run with the PyTorch port (twin of
launcher_eval_collect.py): the mAP of each eval job's text log
(<log-root>/<dataset>/*out.txt, what the launcher's job script tees),
through os2d_torch.utils.logger.extract_map_value_from_os2d_log.
Run: python experiments/launcher_eval_collect_torch.py [--log-root output/eval]
"""

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

from os2d_torch.utils.logger import extract_map_value_from_os2d_log


def collect(log_root, metric):
    """[(dataset, log file name, value or None)] of every eval log."""
    rows = []
    for log_file in sorted(glob.glob(os.path.join(log_root, "*", "*out.txt"))):
        dataset = os.path.basename(os.path.dirname(log_file))
        rows.append((dataset, os.path.basename(log_file),
                     extract_map_value_from_os2d_log(log_file, dataset, metric)))
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--log-root", type=str, default="output/eval")
    parser.add_argument("--metric", type=str, default="mAP@0.50")
    args = parser.parse_args(argv)

    print(f"{'dataset':<25} {'log':<50} {args.metric:>10}")
    for dataset, log_name, value in collect(args.log_root, args.metric):
        print(f"{dataset:<25} {log_name:<50} {value if value is not None else 'n/a':>10}")


if __name__ == "__main__":
    main()
