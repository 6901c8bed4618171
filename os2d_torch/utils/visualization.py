"""Visual debugging: detections, GT boxes, score heatmaps, mined patches,
target remapping and the train log.

A copy of `os2d_tpu/utils/visualization.py` (the reference's
os2d/utils/visualization.py:12-364) on numpy and matplotlib with the Agg
backend, kept in the port so that it imports nothing of the JAX package:
detections with anchor boxes and transform-corner parallelograms, GT boxes,
per-class score heatmaps vs targets per pyramid level, and mined-patch
display. Every function takes numpy arrays and saves a figure (or returns
it). Callers pass numpy: tensors are moved to the host before they get here.
"""

from __future__ import annotations

import numpy as np

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib import patches  # noqa: E402


def _unnormalize(img, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)):
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[-1] == 3 and img.dtype != np.uint8:
        img = img * np.asarray(std) + np.asarray(mean)
        img = np.clip(img, 0, 1)
    return img


def _draw_box(ax, box, color="lime", linewidth=2, label=None):
    x1, y1, x2, y2 = box
    ax.add_patch(
        patches.Rectangle((x1, y1), x2 - x1, y2 - y1, fill=False,
                          edgecolor=color, linewidth=linewidth)
    )
    if label is not None:
        ax.text(x1, y1 - 2, str(label), color=color, fontsize=8,
                bbox=dict(facecolor="black", alpha=0.5, pad=0))


def _draw_corners(ax, corners8, color="cyan"):
    """corners8 = (x00, y00, x01, y01, x10, y10, x11, y11) — the transformed
    grid corners; drawn as the parallelogram 00 -> 01 -> 11 -> 10."""
    c = np.asarray(corners8).reshape(4, 2)
    order = [0, 1, 3, 2, 0]
    ax.plot(c[order, 0], c[order, 1], color=color, linewidth=1)


def show_detections(image, boxes, scores=None, labels=None, corners=None,
                    default_boxes=None, max_detections=10,
                    score_threshold=float("-inf"), save_path=None,
                    class_names=None):
    """Detections + optional anchors + transform parallelograms
    (os2d/utils/visualization.py:248-364)."""
    boxes = np.asarray(boxes).reshape(-1, 4)
    scores = np.asarray(scores) if scores is not None else np.zeros(len(boxes))
    order = np.argsort(-scores)
    order = [i for i in order if scores[i] > score_threshold][:max_detections]

    fig, ax = plt.subplots(figsize=(12, 9))
    ax.imshow(_unnormalize(image))
    for rank, i in enumerate(order):
        name = None
        if labels is not None:
            lid = int(np.asarray(labels).reshape(-1)[i])
            name = class_names[lid] if class_names else lid
        _draw_box(ax, boxes[i], color="lime",
                  label=f"{name}: {scores[i]:.2f}" if name is not None else f"{scores[i]:.2f}")
        if corners is not None:
            _draw_corners(ax, np.asarray(corners).reshape(-1, 8)[i])
        if default_boxes is not None:
            _draw_box(ax, np.asarray(default_boxes).reshape(-1, 4)[i],
                      color="yellow", linewidth=1)
    ax.axis("off")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=120)
        plt.close(fig)
        return save_path
    return fig


def show_gt_boxes(image, gt_boxes, labels=None, difficult=None, save_path=None):
    fig, ax = plt.subplots(figsize=(12, 9))
    ax.imshow(_unnormalize(image))
    gt_boxes = np.asarray(gt_boxes).reshape(-1, 4)
    for i, box in enumerate(gt_boxes):
        is_diff = bool(difficult[i]) if difficult is not None else False
        _draw_box(ax, box, color="orange" if is_diff else "red",
                  label=None if labels is None else int(labels[i]))
    ax.axis("off")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=120)
        plt.close(fig)
        return save_path
    return fig


def show_class_heatmap(image, class_scores_fm, targets_fm=None, save_path=None):
    """Per-class score heatmap vs targets for one pyramid level
    (os2d/utils/visualization.py:41-82). class_scores_fm: [h, w] scores."""
    ncols = 3 if targets_fm is not None else 2
    fig, axes = plt.subplots(1, ncols, figsize=(6 * ncols, 6))
    axes[0].imshow(_unnormalize(image))
    axes[0].set_title("image")
    im = axes[1].imshow(np.asarray(class_scores_fm), vmin=-1, vmax=1,
                        cmap="coolwarm")
    axes[1].set_title("scores")
    fig.colorbar(im, ax=axes[1])
    if targets_fm is not None:
        axes[2].imshow(np.asarray(targets_fm), vmin=-1, vmax=1, cmap="coolwarm")
        axes[2].set_title("targets")
    for ax in axes:
        ax.axis("off")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=120)
        plt.close(fig)
        return save_path
    return fig


def show_mined_patches(image, mined_records, save_path=None):
    """Mined hard patches on the original image
    (os2d/utils/visualization.py:12-38)."""
    colors = {"neg": "red", "pos": "lime", "pos_loc": "cyan"}
    fig, ax = plt.subplots(figsize=(12, 9))
    ax.imshow(_unnormalize(image))
    for rec in mined_records:
        color = colors.get(rec["role"], "white")
        _draw_box(ax, rec["crop_position_xyxy"], color=color,
                  label=f"{rec['role']}:{rec['label_global']} {rec['loss']:.2f}")
    ax.axis("off")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=120)
        plt.close(fig)
        return save_path
    return fig


def plot_train_log(full_log: dict, save_path=None, x_axis="iter"):
    """Plot every metric series in train_log.pkl vs iteration/time — the
    matplotlib replacement of the reference's visdom dashboard
    (os2d/utils/plot_visdom.py:10-87)."""
    xs = full_log.get(x_axis, list(range(max(len(v) for v in full_log.values()))))
    names = [k for k in full_log if k not in ("iter", "time")]
    if not names:
        return None
    ncols = 3
    nrows = (len(names) + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(6 * ncols, 4 * nrows),
                             squeeze=False)
    for i, name in enumerate(sorted(names)):
        ax = axes[i // ncols][i % ncols]
        ys = full_log[name]
        ax.plot(xs[: len(ys)], ys, marker=".")
        ax.set_title(name)
        ax.set_xlabel(x_axis)
        ax.grid(True, alpha=0.3)
    for j in range(len(names), nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=100)
        plt.close(fig)
        return save_path
    return fig


def show_target_remapping(image, cls_scores_fm, targets_fm, remapped_fm,
                          ious_anchor=None, ious_corrected=None,
                          loss_per_anchor=None, grad_scores=None,
                          grad_scores_detached=None, save_path=None):
    """Target-remapping diagnostics for one (image, label) pair (reference
    os2d/utils/visualization.py:85-137, saved to a file instead of shown):
    targets before/after remapping, anchor IoUs before/after correction by
    the predicted boxes, raw scores, per-anchor classification loss, and the
    loss gradients w.r.t. the score map (with / without the transform
    detached)."""
    extra = [
        (ious_anchor, "IoUs of anchors", dict(vmin=0, vmax=1, cmap="viridis")),
        (ious_corrected, "IoUs of remapped anchors",
         dict(vmin=0, vmax=1, cmap="viridis")),
        (loss_per_anchor, "cls loss per anchor", dict(cmap="magma")),
        (grad_scores, "dLoss/dScores", dict(cmap="coolwarm")),
        (grad_scores_detached, "dLoss/dScores (transform detached)",
         dict(cmap="coolwarm")),
    ]
    extra = [(fm, t, kw) for fm, t, kw in extra if fm is not None]
    n = 4 + len(extra)
    ncols = min(n, 5)
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(6 * ncols, 6 * nrows))
    axes = np.atleast_1d(axes).ravel()
    axes[0].imshow(_unnormalize(image))
    axes[0].set_title("image")
    panels = [
        (cls_scores_fm, "scores", dict(vmin=-1, vmax=1, cmap="coolwarm")),
        (targets_fm, "targets (IoU vs anchors)",
         dict(vmin=-1, vmax=1, cmap="coolwarm")),
        (remapped_fm, "targets remapped (IoU vs predictions)",
         dict(vmin=-1, vmax=1, cmap="coolwarm")),
    ] + extra
    for ax, (fm, title, kwargs) in zip(axes[1:], panels):
        data = np.asarray(fm, np.float32)
        if "vmin" not in kwargs:  # symmetric scale for gradients/losses
            amax = float(np.abs(data).max()) or 1.0
            if kwargs.get("cmap") == "coolwarm":
                kwargs = dict(kwargs, vmin=-amax, vmax=amax)
        im = ax.imshow(data, **kwargs)
        ax.set_title(f"{title}\nmin {data.min():0.3g} max {data.max():0.3g}",
                     fontsize=9)
        fig.colorbar(im, ax=ax)
    for ax in axes:
        ax.axis("off")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=120)
        plt.close(fig)
        return save_path
    return fig
