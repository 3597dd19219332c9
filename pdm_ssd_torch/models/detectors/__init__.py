"""Detector registry (counterpart of `pdm_ssd_tpu/models/detectors/__init__.py`)."""
from .detector3d import Detector3D
from .pdm_ssd import PDMSSD
from .point_rcnn import PointRCNN
from .pv_rcnn import PVRCNN
from .voxel_rcnn import VoxelRCNN

_DETECTORS = {'PDMSSD': PDMSSD, 'PointRCNN': PointRCNN, 'SECONDNet': Detector3D,
              'PointPillar': Detector3D, 'CenterPoint': Detector3D, 'PillarNet': Detector3D,
              'VoxelNeXt': Detector3D, 'PVRCNN': PVRCNN, 'VoxelRCNN': VoxelRCNN}
# the rest of the two-stage family, by the ROADMAP item that ports it
_LATER = {'SECONDNetIoU': 'ROADMAP Queue 1 item 11, SECOND-IoU',
          'PartA2Net': 'ROADMAP Queue 1 item 11, Part-A2',
          'PVRCNNPlusPlus': 'ROADMAP Queue 1 item 11, PV-RCNN++'}


def build_detector(model_cfg, num_class, dataset_cfg, class_names=None, device=None):
    if model_cfg.NAME in _LATER:
        raise NotImplementedError(f'detector {model_cfg.NAME} is not ported yet '
                                  f'({_LATER[model_cfg.NAME]})')
    if model_cfg.NAME not in _DETECTORS:
        raise NotImplementedError(f'detector {model_cfg.NAME} is not ported yet (ROADMAP Queue 1)')
    return _DETECTORS[model_cfg.NAME](model_cfg, num_class, dataset_cfg, class_names=class_names,
                                      device=device)
