from .head import ClassHead, build_class_head, head_forward, make_class_pool_mask
from .os2d import Os2dConfig, Os2dModel, init_os2d_params, normalize_images
from .resnet import RESNET_DEPTHS, ResNetC4
from .transform_net import TransformNet
