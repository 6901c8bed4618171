"""What every driver shares: the set-up's phase clock, the program's model
built from a configuration file and the seed's weights, and the verdict of
a check."""

from __future__ import annotations

import dataclasses
import time

import torch


class PhaseClock:
    """Seconds of each phase of a set-up, on the host's clock (the device
    waited for at each mark)."""

    def __init__(self):
        self.phases, self.last = {}, time.perf_counter()

    def mark(self, name):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.phases[name] = now - self.last
        self.last = now


# The fields of the port's Os2dConfig that the seed's weights (weights.py)
# and the reference (reference/) follow, each with the values they follow
# (None: every value). A configuration file that sets another field, or one
# of these to another value, would have the program run another model than
# the reference: `model_config` refuses it.
FOLLOWED_FIELDS = {
    "backbone_arch": None,  # the weights and the reference take backbone_blocks
    "merge_branch_parameters": (True,),  # one backbone's weights for both branches
    "use_inverse_geom_model": None,
    "use_simplified_affine_model": None,
    "use_group_norm": None,
    "class_image_size": None,
    "normalization_mean": None,
    "normalization_std": None,
    "compute_dtype": ("float32",),  # the reference computes in fp32
    "resample_precision": ("default",),  # the reference's resample is the default tier's
}


def model_config(config):
    """The port's Os2dConfig of a configuration file: every key of the file
    that names a field of Os2dConfig (lists as tuples); the others keep
    Os2dConfig's defaults. Raises ValueError on a field, or a value, that
    FOLLOWED_FIELDS does not list."""
    from os2d_torch.models import Os2dConfig

    fields = {f.name for f in dataclasses.fields(Os2dConfig)}
    chosen = {k: tuple(v) if isinstance(v, list) else v for k, v in config.items() if k in fields}
    for k, v in chosen.items():
        if k not in FOLLOWED_FIELDS:
            raise ValueError(f"the configuration sets Os2dConfig.{k}, which the benchmark's "
                             f"weights and reference do not follow")
        if FOLLOWED_FIELDS[k] is not None and v not in FOLLOWED_FIELDS[k]:
            raise ValueError(f"the configuration sets Os2dConfig.{k} = {v!r}; the benchmark's "
                             f"weights and reference follow only {FOLLOWED_FIELDS[k]}")
    return Os2dConfig(**chosen)


def build_model(config, state, device):
    """The port's Os2dModel with the seed's weights; with "fold_bn" true in
    the configuration, the inference copy with every BatchNorm folded
    (`fold_inference_params`)."""
    from os2d_torch.models import Os2dModel
    from os2d_torch.models.os2d import fold_inference_params

    model = Os2dModel(model_config(config), device=device)
    model.load_state_dict(state, strict=True)
    return fold_inference_params(model) if config.get("fold_bn", False) else model


def verdict(worst, limits):
    """(correct, {name: (value, limit)}): correct iff every number is within
    its limit."""
    checks = {name: (worst[name], limits[name]) for name in limits}
    return all(v <= lim for v, lim in checks.values()), checks
