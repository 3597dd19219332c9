"""Network construction (counterpart of `pdm_ssd_tpu/models/__init__.py`)."""
import torch

from .detectors import build_detector
from .layers import init_parameters


def build_network(model_cfg, num_class, dataset_cfg, device=None, class_names=None,
                  seed: int = 0):
    """Build the detector on `device` in eval mode, its weights drawn from a
    `torch.Generator` seeded with `seed` (the same weights on every device).
    `device=None` means the card, and raises where CUDA is unavailable: name
    'cpu' to build there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("build_network: CUDA is unavailable; pass device='cpu' "
                               'to build on the CPU')
        device = 'cuda'
    model = build_detector(model_cfg, num_class, dataset_cfg, class_names=class_names,
                           device='meta')
    model = model.to_empty(device=device)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.eval()
