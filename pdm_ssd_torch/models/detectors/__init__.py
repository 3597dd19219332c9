"""Detector registry (counterpart of `pdm_ssd_tpu/models/detectors/__init__.py`)."""
from .bev_fusion import BevFusion
from .detector3d import Detector3D
from .mppnet import MPPNet
from .parta2 import PartA2Net
from .pdm_ssd import PDMSSD
from .point_rcnn import PointRCNN
from .pv_rcnn import PVRCNN
from .pv_rcnn_plusplus import PVRCNNPlusPlus
from .second_iou import SECONDNetIoU
from .voxel_rcnn import VoxelRCNN

_DETECTORS = {'PDMSSD': PDMSSD, 'PointRCNN': PointRCNN, 'SECONDNet': Detector3D,
              'PointPillar': Detector3D, 'CenterPoint': Detector3D, 'PillarNet': Detector3D,
              'VoxelNeXt': Detector3D, 'PVRCNN': PVRCNN, 'VoxelRCNN': VoxelRCNN,
              'SECONDNetIoU': SECONDNetIoU, 'PartA2Net': PartA2Net,
              'PVRCNNPlusPlus': PVRCNNPlusPlus, 'DSVT': Detector3D, 'TransFusion': Detector3D,
              'MPPNet': MPPNet, 'BevFusion': BevFusion}
# the detectors the port does not have yet, by the ROADMAP item that ports them
_LATER = {'CaDDN': 'ROADMAP Queue 1 item 12, CaDDN'}


def build_detector(model_cfg, num_class, dataset_cfg, class_names=None, device=None):
    if model_cfg.NAME not in _DETECTORS:
        item = _LATER.get(model_cfg.NAME, 'ROADMAP Queue 1')
        raise NotImplementedError(f'detector {model_cfg.NAME} is not ported yet ({item})')
    return _DETECTORS[model_cfg.NAME](model_cfg, num_class, dataset_cfg, class_names=class_names,
                                      device=device)
