"""Training objective: recognition loss (RLL / ContrastiveLoss) + smooth-L1.

Counterpart of `os2d_tpu/engine/objective.py` (the reference's
Os2dObjective, os2d/engine/objective.py:12-313), with the same semantics:
target coding {1 pos, 0 neg, -1 ignore}, optional remapped classification
targets (localization keeps the originals), detached-transform scores on
negatives, RLL per-label temperature and negative re-weighting, sort-rank
hard-negative mining for the contrastive loss, and num_pos normalization.
The hinge clips take JAX's derivative at the tie (ops/geometry.py).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops.geometry import clip_jax_grad


@dataclasses.dataclass(frozen=True)
class ObjectiveConfig:
    class_loss: str = "RLL"  # "RLL" | "ContrastiveLoss"
    margin: float = 0.5  # negative margin
    margin_pos: float = 0.6
    class_loss_neg_weight: float = 1.0
    remap_classification_targets: bool = True
    localization_weight: float = 0.2
    neg_to_pos_ratio: float = 3.0
    rll_neg_weight_ratio: float = 0.001

    @property
    def effective_neg_to_pos_ratio(self):
        # RLL disables further hard-negative mining (objective.py:42-44)
        return float("inf") if self.class_loss.lower() == "rll" else self.neg_to_pos_ratio


def smooth_l1(x, y):
    """F.smooth_l1_loss(reduction='none'), beta=1, in the JAX package's form."""
    d = x - y
    ad = d.abs()
    return torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)


def _where(mask, a, fill=0.0):
    return torch.where(mask, a, a.new_full((), fill))


def _hard_negative_ranking(cls_loss, mask_for_search):
    """Global sort-rank of negatives (objective.py:47-71): rank 0 = largest
    loss among the searchable mask; masked-out entries rank after all
    searchable ones. Stable sorts, as jnp.argsort(stable=True)."""
    neg_loss = -cls_loss.reshape(-1)
    neg_loss = torch.where(mask_for_search.reshape(-1), neg_loss, neg_loss.max() + 1)
    idx = torch.argsort(neg_loss, stable=True)
    return torch.argsort(idx, stable=True).reshape(cls_loss.shape)


def compute_objective(cfg: ObjectiveConfig, loc_preds, loc_targets, cls_preds, cls_targets,
                      cls_targets_remapped=None, cls_preds_for_neg=None):
    """Returns the losses dict: loss, loc_smoothL1, cls_<loss>, cls_<loss>_pos,
    cls_<loss>_neg (with a _hardneg<ratio> suffix for the contrastive loss).

    loc_preds / loc_targets [B, L, 4, A]; cls_preds, cls_targets (int,
    {1, 0, -1}), cls_targets_remapped and cls_preds_for_neg [B, L, A].
    Pyramid inputs are concatenated along the anchor axis by the caller.
    """
    pos = cls_targets > 0
    mask_ignored = cls_targets == -1
    neg = ~(mask_ignored | pos)
    num_pos = pos.sum()

    pos_for_regression = pos
    num_pos_for_regression = num_pos
    if cls_targets_remapped is not None and cfg.remap_classification_targets:
        pos = cls_targets_remapped > 0
        mask_ignored = cls_targets_remapped == -1
        neg = ~(mask_ignored | pos)
        num_pos = pos.sum()

    if cls_preds_for_neg is not None:
        cls_preds = _where(pos, cls_preds) + _where(neg, cls_preds_for_neg)

    # ---- localization ----
    loc_loss_per_element = _where(pos_for_regression,
                                  smooth_l1(loc_preds, loc_targets).sum(dim=2))
    loc_loss = loc_loss_per_element.sum()

    # ---- recognition ----
    loss_neg = _where(neg, 0.5 * clip_jax_grad(cls_preds - cfg.margin, lo=0.0))
    loss_pos = _where(pos, 0.5 * clip_jax_grad(cfg.margin_pos - cls_preds, lo=0.0))

    if cfg.class_loss == "ContrastiveLoss":
        cls_loss = loss_neg.square() + loss_pos.square()
    elif cfg.class_loss == "RLL":
        # positives: renormalize by the non-trivial count (objective.py:218-224)
        num_nontrivial_pos = ((loss_pos > 0) & pos).sum().to(torch.float32)
        loss_pos = torch.where(
            num_nontrivial_pos > 0,
            loss_pos * (num_pos / torch.clamp(num_nontrivial_pos, min=1.0)),
            torch.zeros_like(loss_pos))

        # negatives: exp weights with a per-label temperature (objective.py:226-246)
        mask_nontrivial_negs = (loss_neg > 0) & neg
        loss_neg_detached = loss_neg.detach()
        max_loss_neg_per_label = loss_neg_detached.amax(dim=2, keepdim=True).amax(
            dim=0, keepdim=True)  # [1, L, 1]
        mask_positive_neg_loss_per_label = max_loss_neg_per_label > 1e-5
        rll_temperature = -math.log(cfg.rll_neg_weight_ratio) / torch.clamp(
            max_loss_neg_per_label, min=1e-20)
        rll_temperature = _where(mask_positive_neg_loss_per_label, rll_temperature)

        weights_negs = (torch.exp((loss_neg_detached - max_loss_neg_per_label) * rll_temperature)
                        * mask_nontrivial_negs.to(loss_neg.dtype))
        weights_negs_normalization = weights_negs.sum(dim=2, keepdim=True).sum(
            dim=0, keepdim=True)  # [1, L, 1]
        num_active_labels = mask_positive_neg_loss_per_label.to(loss_neg.dtype).sum()
        weights_negs_normalization = 1.0 / torch.clamp(
            weights_negs_normalization * num_active_labels, min=1e-30)
        weights_negs_normalization = torch.where(
            (weights_negs_normalization <= 1e-8) | ~mask_positive_neg_loss_per_label,
            0.0, weights_negs_normalization)
        weights_negs = _where(mask_positive_neg_loss_per_label.expand_as(weights_negs),
                              weights_negs)
        weights_negs = weights_negs * weights_negs_normalization
        weights_negs = weights_negs * torch.clamp(num_pos, min=1).to(weights_negs.dtype)
        loss_neg = _where(weights_negs > 1e-8, loss_neg) * weights_negs

        loss_neg = _where(neg, loss_neg)
        loss_pos = _where(pos, loss_pos)
        cls_loss = loss_neg + loss_pos
    else:
        raise ValueError(f"Unknown class_loss: {cfg.class_loss}")

    mask_all_negs = ~(mask_ignored | pos)
    ratio = cfg.effective_neg_to_pos_ratio
    if math.isinf(ratio):
        # RLL keeps every negative (the reference's float('inf').long() on
        # CUDA; os2d_tpu/engine/objective.py:176-182)
        neg = mask_all_negs
    else:
        ranking = _hard_negative_ranking(cls_loss, mask_all_negs)
        neg = (ranking < ratio * num_pos) & mask_all_negs

    cls_loss_pos = _where(pos, cls_loss).sum()
    cls_loss_neg = _where(neg, cls_loss).sum()
    num_pos_safe = torch.clamp(num_pos, min=1).to(cls_loss.dtype)
    num_pos_reg_safe = torch.clamp(num_pos_for_regression, min=1).to(cls_loss.dtype)
    loc_loss = loc_loss / num_pos_reg_safe
    cls_loss_pos = cls_loss_pos / num_pos_safe
    cls_loss_neg = cls_loss_neg / num_pos_safe

    cls_loss_total = cls_loss_pos + cls_loss_neg * cfg.class_loss_neg_weight
    loss = cls_loss_total + loc_loss * cfg.localization_weight

    cls_name = "cls_" + cfg.class_loss
    suffix = "" if math.isinf(ratio) else f"_hardneg{cfg.neg_to_pos_ratio}"
    return {
        "loss": loss,
        "loc_smoothL1": loc_loss,
        cls_name + suffix: cls_loss_total,
        cls_name + "_pos": cls_loss_pos,
        cls_name + "_neg" + suffix: cls_loss_neg,
    }
