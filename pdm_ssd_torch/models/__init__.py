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


_SPARSE_BB_NAMES = ('SparseVoxelBackBone8x', 'SparseVoxelResBackBone8x', 'SparseUNetV2')


def get_host_prepare(model_cfg, dataset_cfg, training: bool = False):
    """Per-batch preparation for models whose graph consumes precomputed
    tables: the kernel maps of the sparse or focal ladder
    (`ops/sparse_maps.py`) and, for VoxelNeXt, the BEV slot table of the
    ladder's output. Returns a batch -> batch callable on tensors, which
    builds them on the device of the batch's 'voxel_coords', or None for a
    model that needs none. A batch that already holds its maps comes back
    unchanged. `training=True` adds the transposed maps of the strided convs
    (`sparse_maps.UPMAP_KEYS`, `FOCAL_UPMAP_KEYS`) that the sparse conv's
    data gradient reads; `SparseUNetV2`'s batches hold the first three of
    them in eval too, since its decoder convolves through them. `GATHER_BWD` (the JAX package's switch between that
    gather-transpose backward and autodiff of the gather, which give the same
    gradient) changes nothing: the port has one backward, which reads those
    maps, so training ships them whatever the key says."""
    bb = model_cfg.get('BACKBONE_3D', None)
    if bb is None:
        return None
    name = bb.get('NAME')
    if name == 'VoxelBackBone8xFocal':
        return _focal_prepare(bb, dataset_cfg, training)
    if name not in _SPARSE_BB_NAMES:
        return None
    if bb.get('QWIN', False) or bb.get('PWIN', False):
        raise NotImplementedError('QWIN / PWIN correction lists have no counterpart in the port: '
                                  'the sparse-conv kernel needs no window plans (ROADMAP Queue 1 '
                                  'item 10, the rest of the sparse voxel ladder)')
    from ..ops.sparse_maps import (batch_build_backbone8x, batch_build_bev,
                                   batch_invert_down_maps, batch_invert_ladder, default_caps,
                                   ladder_shapes)
    from .detectors.detector3d import _grid_info
    grid, _ = _grid_info(dataset_cfg)
    caps_cfg = bb.get('ACTIVE_CAPS', None)
    bev_hw = ladder_shapes(grid)[4][1:] \
        if model_cfg.get('DENSE_HEAD', {}).get('NAME') == 'VoxelNeXtHead' else None

    def prepare(batch: dict) -> dict:
        if 'sp_submap1' in batch:
            return batch
        V = batch['voxel_coords'].shape[1]
        caps = list(caps_cfg) if caps_cfg else default_caps(V)
        caps[0] = V        # the stage-1 slot table is the input voxel table
        batch = dict(batch)
        batch.update(batch_build_backbone8x(batch['voxel_coords'], batch['voxel_mask'], grid,
                                            caps))
        if training:
            batch.update(batch_invert_ladder(batch, caps))
        elif name == 'SparseUNetV2':
            # the UNet's decoder reads the strided convs' transposed maps forward
            batch.update(batch_invert_down_maps(batch, caps))
        if bev_hw is not None:
            batch.update(batch_build_bev(batch['sp_coords_out'], batch['sp_mask_out'], bev_hw))
        return batch
    return prepare


def _focal_prepare(bb, dataset_cfg, training: bool):
    """The focal ladder's maps (`sparse_maps.batch_build_focal`): candidate
    capacities ACTIVE_CAPS and dilated ones FOCAL_ECAPS, by default [V, 2V,
    3V/2, V, V] and four times the first three, with `caps[0] = V`, the JAX
    package's defaults; in training also their transposes
    (`sparse_maps.batch_invert_focal`)."""
    from ..ops.sparse_maps import batch_build_focal, batch_invert_focal
    from .detectors.detector3d import _grid_info
    grid, _ = _grid_info(dataset_cfg)
    caps_cfg, ecaps_cfg = bb.get('ACTIVE_CAPS', None), bb.get('FOCAL_ECAPS', None)

    def prepare(batch: dict) -> dict:
        if 'fl_submap1' in batch:
            return batch
        V = batch['voxel_coords'].shape[1]
        caps = list(caps_cfg) if caps_cfg else [V, 2 * V, (3 * V) // 2, V, V]
        caps[0] = V
        ecaps = list(ecaps_cfg) if ecaps_cfg else [4 * c for c in caps[:3]]
        batch = dict(batch)
        batch.update(batch_build_focal(batch['voxel_coords'], batch['voxel_mask'], grid, caps,
                                       ecaps))
        if training:
            batch.update(batch_invert_focal(batch, caps, ecaps))
        return batch
    return prepare
