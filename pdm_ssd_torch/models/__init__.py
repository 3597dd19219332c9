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
    tables: the sparse ladder's kernel maps (`ops/sparse_maps.py`). Returns a
    batch -> batch callable on tensors, which builds the maps on the device of
    the batch's 'voxel_coords', or None for a model that needs none. A batch
    that already holds 'sp_submap1' comes back unchanged. `training=True`
    adds the four transpose maps (`sparse_maps.UPMAP_KEYS`) that the sparse
    conv's data gradient reads. `GATHER_BWD` (the JAX package's switch
    between that gather-transpose backward and autodiff of the gather, which
    give the same gradient) changes nothing: the port has one backward, which
    reads those maps, so training ships them whatever the key says."""
    bb = model_cfg.get('BACKBONE_3D', None)
    if bb is None:
        return None
    name = bb.get('NAME')
    if name == 'VoxelBackBone8xFocal':
        raise NotImplementedError('the focal ladder is not ported yet (ROADMAP Queue 1 item 10, '
                                  'the rest of the sparse voxel ladder)')
    if name not in _SPARSE_BB_NAMES:
        return None
    if name == 'SparseUNetV2':
        raise NotImplementedError('SparseUNetV2 and its inverse maps are not ported yet '
                                  '(ROADMAP Queue 1 item 10, the rest of the sparse voxel ladder)')
    if bb.get('QWIN', False) or bb.get('PWIN', False):
        raise NotImplementedError('QWIN / PWIN correction lists have no counterpart in the port: '
                                  'the sparse-conv kernel needs no window plans (ROADMAP Queue 1 '
                                  'item 10, the rest of the sparse voxel ladder)')
    if model_cfg.get('DENSE_HEAD', {}).get('NAME') == 'VoxelNeXtHead':
        raise NotImplementedError('the BEV maps of VoxelNeXt are not ported yet (ROADMAP Queue 1 '
                                  'item 10, the rest of the sparse voxel ladder)')
    from ..ops.sparse_maps import batch_build_backbone8x, batch_invert_ladder, default_caps
    from .detectors.detector3d import _grid_info
    grid, _ = _grid_info(dataset_cfg)
    caps_cfg = bb.get('ACTIVE_CAPS', None)

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
        return batch
    return prepare
