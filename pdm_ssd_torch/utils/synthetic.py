"""Seeded synthetic inputs and random models for smoke and profile runs on
the card, where there is no dataset and no trained checkpoint."""
from __future__ import annotations

import numpy as np
import torch


def kitti_points(B: int, N: int, seed: int) -> np.ndarray:
    """Uniform clouds over the KITTI range, (B, N, 4) float32: x, y, z, intensity."""
    rng = np.random.RandomState(seed)
    return np.stack([rng.uniform(0, 70.4, (B, N)), rng.uniform(-40, 40, (B, N)),
                     rng.uniform(-3, 1, (B, N)), rng.rand(B, N)], axis=-1).astype(np.float32)


def randomize_bn(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Draw every BatchNorm's scale, shift and running statistics (fresh
    statistics of mean 0 and variance 1 would hide eps and layout errors)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                n = m.num_features
                m.weight.copy_(torch.rand(n, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(n, generator=gen) * 0.2)
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.3)
                m.running_var.copy_(torch.rand(n, generator=gen) * 1.7 + 0.3)


def random_model(cfg, device, seed: int = 0) -> torch.nn.Module:
    """The detector of a full config (`MODEL`, `CLASS_NAMES`, `DATA_CONFIG`)
    with seeded weights and BatchNorm statistics, in eval mode."""
    from ..models import build_network
    net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG, device=device,
                        seed=seed)
    randomize_bn(net, torch.Generator().manual_seed(seed + 1))
    return net
