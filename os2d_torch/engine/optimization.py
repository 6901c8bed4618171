"""Optimizers and LR schedules.

Counterpart of `os2d_tpu/engine/optimization.py` (the reference's
os2d/engine/optimization.py:9-94). The JAX package builds each method as an
optax chain: weight decay added to the gradient, then the method's scaling,
then -lr. The port gives the same update:
  - "sgd": optax's add_decayed_weights -> trace(momentum) is torch.optim.SGD
    with weight_decay and momentum (no dampening, no Nesterov);
  - "adam": optax's scale_by_adam defaults (b1 0.9, b2 0.999, eps 1e-8
    outside the square root) are torch.optim.Adam's, with its L2
    weight_decay added to the gradient as optax does;
  - "adagrad", "adadelta", "adamax", "rmsprop": optax's defaults differ from
    torch's (scale_by_rss starts its accumulator at 0.1, scale_by_rms decays
    with 0.9 and puts eps inside the square root, ...), so `OptaxRule`
    writes optax's rule out.
The optimizer holds only the trainable parameters: frozen ones are left out,
which updates what JAX's post-chain mask lets through. The learning rate is
each param group's "lr" (`set_learning_rate` / `get_learning_rate`).
"""

from __future__ import annotations

import logging
from statistics import median

import torch

OPTAX_METHODS = ("adagrad", "adadelta", "adamax", "rmsprop")


def ceildiv(a, b):
    return -(-a // b)


class OptaxRule(torch.optim.Optimizer):
    """optax's add_decayed_weights(wd) -> scale_by_<method>() ->
    scale(-lr), with optax's default hyperparameters:
      adagrad   scale_by_rss: s = 0.1 initially, s += g^2, u = g * rsqrt(s + 1e-7)
      adadelta  scale_by_adadelta: rho 0.9, eps 1e-6
      adamax    scale_by_adamax: b1 0.9, b2 0.999, eps 1e-8
      rmsprop   scale_by_rms: decay 0.9, eps 1e-8 inside the square root
    """

    def __init__(self, params, method: str, lr: float, weight_decay: float = 0.0):
        if method not in OPTAX_METHODS:
            raise ValueError(f"unknown optax rule {method!r}")
        super().__init__(params, {"lr": lr, "weight_decay": weight_decay})
        self.method = method

    def _state(self, p):
        state = self.state[p]
        if not state:
            if self.method == "adagrad":
                state["sum_of_squares"] = torch.full_like(p, 0.1)
            elif self.method == "adadelta":
                state["e_g"], state["e_x"] = torch.zeros_like(p), torch.zeros_like(p)
            elif self.method == "adamax":
                state["count"] = 0
                state["mu"], state["nu"] = torch.zeros_like(p), torch.zeros_like(p)
            else:
                state["nu"] = torch.zeros_like(p)
        return state

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxRule takes no closure")
        for group in self.param_groups:
            lr, wd = group["lr"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad + wd * p if wd else p.grad
                state = self._state(p)
                if self.method == "adagrad":
                    s = state["sum_of_squares"] = g * g + state["sum_of_squares"]
                    u = torch.where(s > 0, torch.rsqrt(s + 1e-7), 0.0) * g
                elif self.method == "adadelta":
                    e_g = state["e_g"] = 0.1 * (g * g) + 0.9 * state["e_g"]
                    u = (torch.sqrt(state["e_x"] + 1e-6) / torch.sqrt(e_g + 1e-6)) * g
                    state["e_x"] = 0.1 * (u * u) + 0.9 * state["e_x"]
                elif self.method == "adamax":
                    state["count"] += 1
                    mu = state["mu"] = (1 - 0.9) * g + 0.9 * state["mu"]
                    nu = state["nu"] = torch.maximum(g.abs() + 1e-8, 0.999 * state["nu"])
                    u = (mu / (1 - 0.9 ** state["count"])) / nu
                else:
                    nu = state["nu"] = (1 - 0.9) * (g * g) + 0.9 * state["nu"]
                    u = torch.rsqrt(nu + 1e-8) * g
                p.add_(-lr * u)


def create_optimizer(optim_cfg, params):
    """The optimizer of cfg.train.optim over `params`, the trainable
    parameters (an iterable of tensors)."""
    method = optim_cfg.optim_method.casefold()
    lr, wd = float(optim_cfg.lr), float(optim_cfg.weight_decay)
    params = list(params)
    if method == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=float(optim_cfg.sgd_momentum),
                               weight_decay=wd)
    if method == "adam":
        return torch.optim.Adam(params, lr=lr, weight_decay=wd)
    if method in OPTAX_METHODS:
        return OptaxRule(params, method, lr, wd)
    raise RuntimeError(f"Invalid optim method: {optim_cfg.optim_method}")


def set_learning_rate(optimizer, lr: float):
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer


def get_learning_rate(optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def setup_lr(full_log, cfg, eval_iter, initial_steps=0):
    """Host-side LR controller (os2d/engine/optimization.py:53-94), as
    `os2d_tpu.engine.optimization.setup_lr`.

    Returns anneal_lr_func(i_iter, current_lr, anneal_now=True) -> new lr.
    initial_steps replays a resume position into the MultiStepLR counter.
    """
    logger = logging.getLogger("OS2D.lr")
    kind = cfg.type.lower()

    if kind == "none":
        def anneal(i_iter, lr, anneal_now=True):
            return lr
        return anneal

    if kind == "multisteplr":
        milestones = sorted(ceildiv(m, eval_iter) for m in cfg.milestones)
        state = {"num_steps": int(initial_steps)}

        def anneal(i_iter, lr, anneal_now=True):
            state["num_steps"] += 1
            if state["num_steps"] in milestones:
                new_lr = lr * cfg.gamma
                logger.info(f"MultiStepLR: lr {lr} -> {new_lr}")
                return new_lr
            return lr

        return anneal

    if kind == "reducelronplateau":
        patience = ceildiv(cfg.patience, eval_iter)
        cooldown = ceildiv(cfg.cooldown, eval_iter)
        buffer_len = max(ceildiv(cfg.quantity_smoothness, eval_iter), 1)
        state = {"best": None, "num_bad": 0, "cooldown_counter": 0, "buffer": []}
        mode = cfg.quantity_mode
        eps = cfg.quantity_epsilon

        def is_better(cur, best):
            if best is None:
                return True
            if mode == "max":
                return cur > best * (1.0 + eps) if best >= 0 else cur > best * (1.0 - eps)
            return cur < best * (1.0 - eps) if best >= 0 else cur < best * (1.0 + eps)

        def anneal(i_iter, lr, anneal_now=True):
            values = full_log.get(cfg.quantity_to_monitor, [])
            if not values:
                return lr
            state["buffer"].append(values[-1])
            if len(state["buffer"]) > buffer_len:
                state["buffer"].pop(0)
            averaged = median(state["buffer"])
            if not anneal_now:
                return lr
            if state["cooldown_counter"] > 0:
                state["cooldown_counter"] -= 1
                state["num_bad"] = 0
            if is_better(averaged, state["best"]):
                state["best"] = averaged
                state["num_bad"] = 0
            else:
                state["num_bad"] += 1
            if state["num_bad"] > patience:
                new_lr = max(lr * cfg.reduce_factor, cfg.min_value)
                if new_lr < lr:
                    logger.info(f"ReduceLROnPlateau: lr {lr} -> {new_lr}")
                state["cooldown_counter"] = cooldown
                state["num_bad"] = 0
                return new_lr
            return lr

        return anneal

    raise RuntimeError(f"Unknown anneal_lr type: {cfg.type}")
