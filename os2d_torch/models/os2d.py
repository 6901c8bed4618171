"""OS2D model facade: counterpart of `os2d_tpu/models/os2d.py`
(the reference's Os2dModel, os2d/modeling/model.py:123-386), eval and
training.

`Os2dModel` is an nn.Module that owns its weights:

  backbone        ResNet-C4 for the input images;
  label_backbone  ResNet-C4 for the class images, present only when
                  merge_branch_parameters=False (else the backbone is shared);
  transform_net   the TransformationNet.

Class heads are not submodules: class features are a [C, 15, 15, F] tensor
computed once and passed around explicitly, so classes batch as an axis.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn

from ..structures.feature_map import FeatureMapSize, feature_map_size_for_image
from .head import ClassHead, QuantizedClassHead, build_class_head, dequantize_class_head, head_forward
from .resnet import ResNetC4, fold_batchnorm_c4
from .transform_net import TransformNet, fold_batchnorm_transform_net

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

IMG_NORMALIZATION_MEAN = (0.485, 0.456, 0.406)
IMG_NORMALIZATION_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class Os2dConfig:
    """Static model configuration (mirrors cfg.model, os2d/config.py:14-29),
    with the fields of `os2d_tpu.models.Os2dConfig` that this slice reads."""

    backbone_arch: str = "resnet50"
    merge_branch_parameters: bool = True
    use_inverse_geom_model: bool = True
    use_simplified_affine_model: bool = False
    use_group_norm: bool = False  # GroupNorm(32) in both backbones
    class_image_size: int = 240
    normalization_mean: tuple = IMG_NORMALIZATION_MEAN
    normalization_std: tuple = IMG_NORMALIZATION_STD
    compute_dtype: str = "float32"  # or "bfloat16": convolutions and the
    # correlation's operands in bf16, as the JAX package rounds them
    resample_precision: str = "default"  # "default": the bf16 hat-weight
    # resample (csrc/hat_resample.cu); "high" | "highest": the fp32 gather
    # (csrc/resample.cu); "int8": the int8 hat form
    # (csrc/int8_hat_resample.cu; "default" where a graph is recorded)
    corr_interior_first: bool = True  # correlation channels with the
    # pool-mask interior as a contiguous prefix; False: the natural order
    # and the grid path (models/head.py)


def normalize_images(images_nhwc, config: Os2dConfig):
    """Apply the dataset mean/std normalization to [0,1]-range NHWC images."""
    mean = torch.tensor(config.normalization_mean, dtype=torch.float32, device=images_nhwc.device)
    std = torch.tensor(config.normalization_std, dtype=torch.float32, device=images_nhwc.device)
    return (images_nhwc - mean) / std


@torch.no_grad()
def init_os2d_params(model: "Os2dModel", seed: int = 0) -> None:
    """Fill the model's weights from a seed with the distributions of
    `os2d_tpu.models.init_os2d_params` (the numbers differ from JAX's; to
    hold the two packages against each other, convert the JAX params with
    `models.from_jax.state_dict_from_jax`)."""
    generator = torch.Generator(device=model.device).manual_seed(seed)
    model.backbone.reset_parameters(generator)
    if model.label_backbone is not None:
        model.label_backbone.reset_parameters(generator)
    model.transform_net.reset_parameters(generator)


class Os2dModel(nn.Module):
    """The OS2D network.

    Runs on `device`, by default "cuda"; it raises if CUDA is absent rather
    than moving to the CPU. Pass device="cpu" to run the plain versions of the
    kernels. Numerics follow `config.compute_dtype` (fp32 or bfloat16,
    rounded where the JAX package rounds; the correlation and the
    TransformNet's output are fp32 in both). TF32 is switched off for both
    cuDNN convolutions and matmuls (torch.backends.cudnn.allow_tf32 and
    torch.backends.cuda.matmul.allow_tf32), and cuBLAS may not reduce a bf16
    GEMM in bf16 (torch.backends.cuda.matmul
    .allow_bf16_reduced_precision_reduction), process-wide: XLA accumulates
    in fp32. The weights are filled from `seed` (init_os2d_params) and can
    be replaced with load_state_dict. It starts in eval form, with no
    autograd state; `train_mode(True)` makes every parameter require a
    gradient (the training engine, `engine/train.py`, chooses which of them
    the optimizer updates). `fold_inference_params` gives a folded copy for
    inference, which refuses to train.
    """

    def __init__(self, config: Os2dConfig = Os2dConfig(), device=None, seed: int = 0):
        super().__init__()
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Os2dModel targets CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        if config.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown compute_dtype {config.compute_dtype!r}")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        self.config = config
        self.device = device
        self.compute_dtype = dtype = COMPUTE_DTYPES[config.compute_dtype]
        self.folded = False
        self.backbone = ResNetC4(config.backbone_arch, device, dtype, config.use_group_norm)
        self.label_backbone = (None if config.merge_branch_parameters
                               else ResNetC4(config.backbone_arch, device, dtype,
                                             config.use_group_norm))
        self.transform_net = TransformNet(
            4 if config.use_simplified_affine_model else 6, device, dtype)
        init_os2d_params(self, seed)
        self.train_mode(False)
        self.eval()

    def train_mode(self, enabled: bool = True) -> "Os2dModel":
        """Every parameter requires a gradient (enabled) or none does. The JAX
        trainer differentiates every leaf of its params, frozen ones included
        (they count in the gradient norm, os2d_tpu/engine/train.py:208);
        BatchNorm stays in its frozen form either way. A folded model
        (`fold_inference_params`) raises: its weights carry frozen
        statistics and are not the parameters that train."""
        if enabled and self.folded:
            raise ValueError("a model with folded BatchNorms is for inference only; "
                             "train the unfolded model")
        self.requires_grad_(enabled)
        return self

    @property
    def label_branch(self) -> nn.Module:
        """The class-image backbone: separate if present, else shared
        (os2d_tpu/models/os2d.py: label_backbone_params)."""
        return self.backbone if self.label_backbone is None else self.label_backbone

    def extract_features(self, images_nhwc):
        """[B, H, W, 3] normalized images -> [B, H/16, W/16, 1024]."""
        return self.backbone(images_nhwc)

    def build_class_head_from_images(self, class_images) -> ClassHead:
        """Class images (list of [h, w, 3] normalized tensors or arrays,
        possibly of different sizes) -> ClassHead with [C, 15, 15, F] features.
        Images of identical shape share one backbone call."""
        label_backbone = self.label_branch
        by_shape = {}
        for i, img in enumerate(class_images):
            by_shape.setdefault(tuple(img.shape), []).append(i)
        feats = [None] * len(class_images)
        for idxs in by_shape.values():
            batch = torch.stack([torch.as_tensor(class_images[i], device=self.device)
                                 for i in idxs])
            fm = label_backbone(batch)
            for j, i in enumerate(idxs):
                feats[i] = fm[j]
        return build_class_head(feats)

    def apply_head(self, feature_maps, class_head):
        """Feature maps + class head -> dict(loc, cls, cls_detached, corners,
        fm_size); differentiable when grad mode is on. A QuantizedClassHead
        (a chunk of an int8 bank) is dequantized to fp32 on its device first,
        so the bank itself stays int8 (os2d_tpu/models/os2d.py:150-160)."""
        if isinstance(class_head, QuantizedClassHead):
            class_head = dequantize_class_head(class_head)
        return head_forward(
            self.transform_net,
            feature_maps,
            class_head,
            simple_affine=self.config.use_simplified_affine_model,
            use_inverse_geom_model=self.config.use_inverse_geom_model,
            resample_precision=self.config.resample_precision,
            corr_interior_first=self.config.corr_interior_first,
            compute_dtype=self.compute_dtype,
        )

    def get_feature_map_size(self, img_size: FeatureMapSize) -> FeatureMapSize:
        return feature_map_size_for_image(img_size)


def fold_inference_params(model: Os2dModel) -> Os2dModel:
    """Inference-only: a copy of `model` with every frozen BatchNorm folded
    into its convolution, in the backbone, the label backbone when it is
    separate, and the TransformNet (os2d_tpu/models/os2d.py:100-120). The
    folded model does less work per layer and, with bfloat16 compute, keeps
    the backbone bfloat16 end to end. The caller's model is left as it was;
    the copy refuses `train_mode(True)`."""
    folded = copy.copy(model)
    folded._modules = dict(model._modules)
    folded.backbone = fold_batchnorm_c4(model.backbone)
    if model.label_backbone is not None:
        folded.label_backbone = fold_batchnorm_c4(model.label_backbone)
    folded.transform_net = fold_batchnorm_transform_net(model.transform_net)
    folded.folded = True
    return folded.train_mode(False)


# the checkpoint cascade of os2d_tpu/models/os2d.py:210-331 lives in
# models/checkpoint.py; it is re-exported here, where the JAX package has it
from .checkpoint import (  # noqa: E402
    import_os2d_torch_checkpoint,
    import_weakalign_checkpoint,
    load_checkpoint_file,
)
