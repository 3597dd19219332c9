"""Detector registry (counterpart of `pdm_ssd_tpu/models/detectors/__init__.py`)."""
from .bev_fusion import BevFusion
from .caddn import CaDDN
from .detector3d import Detector3D, SECONDNet
from .mppnet import MPPNet
from .parta2 import PartA2Net
from .pdm_ssd import PDMSSD
from .point_rcnn import PointRCNN
from .pv_rcnn import PVRCNN
from .pv_rcnn_plusplus import PVRCNNPlusPlus
from .second_iou import SECONDNetIoU
from .voxel_rcnn import VoxelRCNN

_DETECTORS = {'PDMSSD': PDMSSD, 'PointRCNN': PointRCNN, 'SECONDNet': SECONDNet,
              'PointPillar': Detector3D, 'CenterPoint': Detector3D, 'PillarNet': Detector3D,
              'VoxelNeXt': Detector3D, 'PVRCNN': PVRCNN, 'VoxelRCNN': VoxelRCNN,
              'SECONDNetIoU': SECONDNetIoU, 'PartA2Net': PartA2Net,
              'PVRCNNPlusPlus': PVRCNNPlusPlus, 'DSVT': Detector3D, 'TransFusion': Detector3D,
              'MPPNet': MPPNet, 'BevFusion': BevFusion, 'CaDDN': CaDDN}


def build_detector(model_cfg, num_class, dataset_cfg, class_names=None, device=None):
    if model_cfg.NAME not in _DETECTORS:
        raise NotImplementedError(f'detector {model_cfg.NAME} is not ported yet (ROADMAP Queue 1)')
    return _DETECTORS[model_cfg.NAME](model_cfg, num_class, dataset_cfg, class_names=class_names,
                                      device=device)
