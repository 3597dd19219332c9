"""Detector registry (counterpart of `pdm_ssd_tpu/models/detectors/__init__.py`)."""
from .pdm_ssd import PDMSSD


def build_detector(model_cfg, num_class, dataset_cfg, class_names=None, device=None):
    if model_cfg.NAME != 'PDMSSD':
        raise NotImplementedError(f'detector {model_cfg.NAME} is not ported yet (ROADMAP Queue 1)')
    return PDMSSD(model_cfg, num_class, dataset_cfg, class_names=class_names, device=device)
