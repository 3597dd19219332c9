"""Detector registry (counterpart of `pdm_ssd_tpu/models/detectors/__init__.py`)."""
from .detector3d import Detector3D
from .pdm_ssd import PDMSSD
from .point_rcnn import PointRCNN

_DETECTORS = {'PDMSSD': PDMSSD, 'PointRCNN': PointRCNN, 'SECONDNet': Detector3D,
              'PointPillar': Detector3D, 'CenterPoint': Detector3D, 'PillarNet': Detector3D,
              'VoxelNeXt': Detector3D}


def build_detector(model_cfg, num_class, dataset_cfg, class_names=None, device=None):
    if model_cfg.NAME not in _DETECTORS:
        raise NotImplementedError(f'detector {model_cfg.NAME} is not ported yet (ROADMAP Queue 1)')
    return _DETECTORS[model_cfg.NAME](model_cfg, num_class, dataset_cfg, class_names=class_names,
                                      device=device)
