"""Logging, metric series and checkpoints.

Counterpart of `os2d_tpu/utils/logger.py` (the reference's
os2d/utils/logger.py:12-160): hierarchical loggers, in-memory metric series
NaN-padded to equal length and pickled to train_log.pkl, and model
checkpoints written with torch.save in the reference's {"net", "optimizer",
...} layout (the JAX package's orbax backend has no counterpart here).
In a run of several processes only rank 0 writes files (the log file,
train_log.pkl, checkpoints), as only the JAX package's primary host does.
"""

from __future__ import annotations

import datetime
import logging
import math
import os
import pickle
import random
import re
import sys
import time

import numpy as np
import torch

from ..parallel.mesh import primary_host


def setup_logger(name="OS2D", log_path=None):
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    sh = logging.StreamHandler(stream=sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_path and primary_host():
        os.makedirs(log_path, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_path, "log.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def set_random_seed(seed):
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def time_since(t_start):
    return str(datetime.timedelta(seconds=int(time.time() - t_start)))


def print_meters(meters, logger):
    if meters:
        logger.info(", ".join(
            f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
            for k, v in meters.items() if not isinstance(v, (list, dict, np.ndarray))))


def add_to_meters_in_dict(meters, target):
    for k, v in meters.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            target[k] = target.get(k, 0.0) + v


def init_log():
    return {}


def log_meters(full_log, t_start, i_iter, output_path, meters_running=None,
               meters_eval=None):
    """Append one evaluation point to every metric series; NaN-pad new series
    (os2d/utils/logger.py:12-85). Pickles to <output_path>/train_log.pkl."""

    def add(name, value):
        full_log.setdefault(name, []).append(value)

    add("iter", i_iter)
    add("time", time.time() - t_start)
    for k, v in (meters_running or {}).items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            add("train_" + k, float(v))
    for dataset_name, meters in (meters_eval or {}).items():
        for k, v in meters.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                add(f"{k}_{dataset_name}", float(v))

    max_len = max(len(s) for s in full_log.values())
    for series in full_log.values():
        while len(series) < max_len:
            series.append(float("nan"))

    if output_path and primary_host():  # one writer in a multi-process run
        os.makedirs(output_path, exist_ok=True)
        try:
            with open(os.path.join(output_path, "train_log.pkl"), "wb") as f:
                pickle.dump(full_log, f)
        except OSError as e:
            logging.getLogger("OS2D").warning(f"Could not save train_log.pkl: {e}")
    return full_log


def checkpoint_model(model, optimizer, output_path, i_iter=None, model_name=None,
                     extra_fields=None, full_log=None):
    """Save {"net": model.state_dict(), "optimizer": optimizer.state_dict(),
    "i_iter", "full_log", **extra} with torch.save (logger.py:137-160) to
    checkpoint_<model_name>.pth or checkpoint_iter_<i_iter>.pth; returns the
    path. The payload carries the iteration and the metric log, so training
    resumes exactly. In a multi-process run only rank 0 writes (every rank
    holds the same weights); the others return the path unwritten, so a
    reload needs storage that every rank sees."""
    name = f"checkpoint_{model_name}" if model_name is not None else f"checkpoint_iter_{i_iter}"
    path = os.path.join(output_path, name + ".pth")
    if not primary_host():
        return path
    os.makedirs(output_path, exist_ok=True)
    payload = {
        "i_iter": i_iter,
        "full_log": full_log,
        "net": model.state_dict(),
        "optimizer": optimizer.state_dict() if optimizer is not None else None,
    }
    payload.update(extra_fields or {})
    try:
        torch.save(payload, path)
        logging.getLogger("OS2D").info(f"Saved checkpoint to {path}")
    except OSError as e:
        logging.getLogger("OS2D").error(f"Could not save checkpoint {path}: {e}")
    return path


def load_checkpoint(path, map_location="cpu"):
    """A checkpoint of `checkpoint_model` (tensors, numbers and lists only)."""
    return torch.load(path, map_location=map_location, weights_only=True)


# Log mining (os2d/utils/logger.py:163-225; os2d_tpu/utils/logger.py:207-249),
# for the experiments' collect scripts.

def extract_pattern_after_marked_line(log_path, marker, pattern):
    """The float that `pattern`'s first group matches on the first line
    matching it after each line that contains `marker`, in order."""
    with open(log_path) as f:
        lines = f.readlines()
    values = []
    triggered = False
    rx = re.compile(pattern)
    for line in lines:
        if triggered:
            m = rx.search(line)
            if m:
                values.append(float(m.group(1)))
                triggered = False
        if marker in line:
            triggered = True
    return values


def extract_map_value_from_os2d_log(log_path, eval_dataset, metric_name="mAP@0.50"):
    """The last `metric_name` that the log reports for `eval_dataset`. The
    marker is the line `evaluate` writes as an evaluation starts ("Starting
    evaluation on <name>"); the JAX package's twin looks for the reference's
    "Evaluating on <name>", which neither package writes."""
    numeric = r"([-+]?\d*\.?\d+(?:[eE][-+]?\d+)?)"
    values = extract_pattern_after_marked_line(
        log_path, f"Starting evaluation on {eval_dataset}",
        rf"{re.escape(metric_name)}\D*{numeric}")
    return values[-1] if values else None


def mine_log_value(full_log, name, mode="max"):
    """The max, min, first or last non-NaN value of a train_log series."""
    series = [v for v in full_log.get(name, []) if not math.isnan(v)]
    if not series:
        return None
    if mode == "max":
        return max(series)
    if mode == "min":
        return min(series)
    if mode == "first":
        return series[0]
    if mode == "last":
        return series[-1]
    raise ValueError(mode)
