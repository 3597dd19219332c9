from .fuser import ConvFuser  # noqa: F401
from .generalized_lss import BasicBlock2D, GeneralizedLSSFPN  # noqa: F401
from .image_backbone import ConvImageBackbone  # noqa: F401
from .swin import SwinTransformer  # noqa: F401
