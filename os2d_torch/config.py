"""Configuration tree: same shape and defaults as the reference yacs config
(os2d/config.py:7-271) so the reference's experiment YAMLs and dotted CLI
override grammar (`--config-file FILE k.ey value ...`, main.py:15-37) stay
portable, implemented with a small self-contained node class (no yacs).

A copy of `os2d_tpu/config.py` with the same keys and defaults, so that a
config edit means the same thing to both packages. The additions grouped
under `cfg.tpu` keep their names; the PyTorch port reads the ones on its
eval path (`eval_class_chunk`, `eval_class_chunk_per_level`,
`eval_pre_top_k`, `eval_top_k`, `eval_class_prescreen`,
`eval_prefetch_depth`, `fold_bn`,
`quantize_class_feats`, `device_side_pyramid`, `eval_shard_axis`),
`corr_interior_first` and the model keys in `main.py`, refuses where they
are read the options whose paths are not ported
(`upload_pixel_format="yuv420"`, `checkpoint_backend="orbax"`) and ignores
the rest (the model's numerics are its `Os2dConfig`'s, as in the JAX
package; `upload_streams` and `upload_serialize` shape a TPU upload and
nothing on a card needs them, see `os2d_torch/utils/upload.py`).
"""

from __future__ import annotations

import ast
import copy
from typing import Any, List


# Reference-compat keys that are accepted (so reference YAMLs stay portable,
# os2d/config.py:11) but have no effect: the device is an explicit argument of
# the port's entry points.
# Overriding one gets a one-time warning instead of silently doing nothing.
_INERT_COMPAT_KEYS = {"is_cuda"}
_warned_inert: set = set()


def _warn_if_inert(full_key: str):
    if full_key in _INERT_COMPAT_KEYS and full_key not in _warned_inert:
        import warnings

        _warned_inert.add(full_key)
        warnings.warn(
            f"Config key '{full_key}' is accepted for reference compatibility "
            f"but has no effect in os2d_torch (the device is an argument).",
            stacklevel=3,
        )


class ConfigNode(dict):
    """Nested attribute-dict with yacs-like merge/override semantics."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def clone(self):
        return copy.deepcopy(self)

    def merge_from_dict(self, other: dict, _path=""):
        for k, v in other.items():
            full = f"{_path}.{k}" if _path else k
            if k not in self:
                raise KeyError(f"Unknown config key: {full}")
            if isinstance(self[k], ConfigNode):
                if not isinstance(v, dict):
                    raise TypeError(f"Cannot override subtree {full} with a value")
                self[k].merge_from_dict(v, full)
            else:
                _warn_if_inert(full)
                self[k] = _coerce(v, self[k], full)

    def merge_from_file(self, path: str):
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f)
        if data:
            self.merge_from_dict(data)

    def merge_from_list(self, opts: List[str]):
        assert len(opts) % 2 == 0, f"Override list must be key value pairs: {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = getattr(node, p)
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Unknown config key: {key}")
            _warn_if_inert(key)
            if isinstance(value, str):
                try:
                    value = ast.literal_eval(value)
                except (ValueError, SyntaxError):
                    pass  # keep as string
            node[leaf] = _coerce(value, node[leaf], key)

    def freeze(self):
        return self  # kept for API compatibility with yacs callers


def _coerce(value: Any, old: Any, key: str) -> Any:
    if old is None or value is None:
        return value
    if isinstance(old, bool):
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            return value.lower() in ("true", "1", "yes")
        return bool(value)
    if isinstance(old, float) and isinstance(value, (int, float, str)):
        return float(value)
    if isinstance(old, int) and not isinstance(old, bool) and isinstance(value, (int, float)):
        return int(value)
    if isinstance(old, (list, tuple)) and isinstance(value, (list, tuple)):
        return list(value)
    if isinstance(old, str):
        return str(value)
    return value


def _cn(**kwargs):
    node = ConfigNode()
    for k, v in kwargs.items():
        node[k] = v
    return node


def get_default_cfg() -> ConfigNode:
    cfg = _cn(
        is_cuda=True,  # kept for config compatibility; the device is an argument
        random_seed=42,
        model=_cn(
            backbone_arch="ResNet50",
            merge_branch_parameters=True,
            use_inverse_geom_model=True,
            use_simplified_affine_model=False,
            class_image_size=240,
            use_group_norm=False,
            normalization_mean=[0.485, 0.456, 0.406],
            normalization_std=[0.229, 0.224, 0.225],
        ),
        init=_cn(model="", transform=""),
        train=_cn(
            do_training=True,
            batch_size=4,
            class_batch_size=15,
            dataset_name="grozi-train",
            dataset_scale=1280.0,
            cache_images=True,
            objective=_cn(
                class_objective="RLL",
                neg_margin=0.5,
                pos_margin=0.6,
                loc_weight=0.2,
                positive_iou_threshold=0.5,
                negative_iou_threshold=0.1,
                neg_to_pos_ratio=3,
                class_neg_weight=1.0,
                rll_neg_weight_ratio=0.001,
                remap_classification_targets=True,
                remap_classification_targets_iou_pos=0.8,
                remap_classification_targets_iou_neg=0.4,
            ),
            model=_cn(
                train_features=True,
                freeze_bn=True,
                freeze_bn_transform=True,
                freeze_transform=False,
                num_frozen_extractor_blocks=0,
                train_transform_on_negs=False,
            ),
            augment=_cn(
                train_patch_width=600,
                train_patch_height=600,
                scale_jitter=0.7,
                jitter_aspect_ratio=0.9,
                random_flip_batches=False,
                random_color_distortion=False,
                random_crop_class_images=False,
                min_box_coverage=0.7,
                mine_extra_class_images=False,
            ),
            mining=_cn(
                do_mining=False,
                mine_hard_patches_iter=5000,
                num_hard_patches_per_image=10,
                num_random_pyramid_scales=2,
                num_random_negative_classes=200,
                nms_iou_threshold_in_mining=0.5,
            ),
            optim=_cn(
                lr=1e-4,
                max_iter=200000,
                optim_method="sgd",
                weight_decay=1e-4,
                sgd_momentum=0.9,
                max_grad_norm=1e2,
                anneal_lr=_cn(
                    type="none",
                    milestones=[],
                    gamma=0.1,
                    quantity_to_monitor="mAP@0.50_grozi-val-new-cl",
                    quantity_mode="max",
                    quantity_epsilon=1e-2,
                    reduce_factor=0.5,
                    min_value=1e-5,
                    patience=1000,
                    initial_patience=0,
                    cooldown=10000,
                    quantity_smoothness=2000,
                    reload_best_model_after_anneal_lr=True,
                ),
            ),
        ),
        eval=_cn(
            iter=5000,
            dataset_names=["grozi-val-new-cl", "grozi-val-old-cl"],
            dataset_scales=[1280],
            cache_images=False,
            scales_of_image_pyramid=[0.5, 0.625, 0.8, 1, 1.2, 1.4, 1.6],
            train_subset_for_eval_size=0,
            nms_iou_threshold=0.3,
            nms_score_threshold=float("-inf"),
            nms_across_classes=False,
            mAP_iou_thresholds=[0.5],
            batch_size=1,
            class_image_augmentation="",
            exact_class_shapes=False,  # TPU addition: exact class-image resize
        ),
        output=_cn(
            path="",
            save_log_to_file=False,
            print_iter=1,
            save_iter=50000,
            best_model=_cn(
                do_get_best_model=False, dataset="", metric="mAP@0.50", mode="max"
            ),
        ),
        visualization=_cn(
            eval=_cn(
                show_gt_boxes=False,
                show_detections=False,
                max_detections=10,
                score_threshold=float("-inf"),
                show_class_heatmaps=False,
                images_for_heatmaps=[],
                labels_for_heatmaps=[],
                path_to_save_detections="",
            ),
            train=_cn(
                show_gt_boxes_dataloader=False,
                show_detections=False,
                max_detections=5,
                score_threshold=float("-inf"),
                show_target_remapping=False,
            ),
            mining=_cn(
                show_gt_boxes=False,
                show_class_heatmaps=False,
                images_for_heatmaps=[],
                labels_for_heatmaps=[],
                show_mined_patches=False,
                max_detections=10,
                score_threshold=float("-inf"),
            ),
        ),
        # --- additions of the JAX package, same names and defaults; what
        # each does on the TPU is documented in os2d_tpu/config.py. What the
        # port reads is listed in the module docstring. ---
        tpu=_cn(
            compute_dtype="float32",
            resample_precision="default",
            corr_interior_first=True,
            resample_t_chunk=0,
            eval_class_chunk=16,      # classes per head call at eval; bounds
                                      # the [B, chunk, H, W, 225] correlation
                                      # tensor at the largest pyramid level
            eval_class_chunk_per_level=True,
            eval_shard_axis="classes",
            eval_class_prescreen=True,
            eval_prefetch_depth=1,
            upload_streams=2,
            upload_serialize=False,
            upload_pixel_format="auto",
            eval_pre_top_k=1024,      # per-label candidates kept before NMS
            eval_top_k=256,           # detections kept per label after NMS
            mesh_data_axis=-1,
            distributed_init=False,
            train_steps_per_dispatch=1,
            train_loader_workers=1,
            device_class_cache="auto",
            device_class_cache_budget_mb=2048,
            device_side_pyramid=True,
            fold_bn=False,
            quantize_class_feats=False,
            resume="",
            checkpoint_backend="pickle",
        ),
    )
    return cfg
