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


def model_config(config):
    """The port's Os2dConfig of a configuration file: every key of the file
    that names a field of Os2dConfig (lists as tuples); the others keep
    Os2dConfig's defaults."""
    from os2d_torch.models import Os2dConfig

    fields = {f.name for f in dataclasses.fields(Os2dConfig)}
    return Os2dConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in config.items() if k in fields})


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
