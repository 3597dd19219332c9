from .depth_lss import DepthLSSTransform  # noqa: F401
