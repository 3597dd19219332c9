"""Point-feature extraction for PV-RCNN and the voxel-neighbourhood pools of
the two-stage heads (counterpart of `pdm_ssd_tpu/models/backbones_3d/pfe.py`).

- `bilinear_from_bev`: the BEV map read at each keypoint's xy.
- `VoxelNeighborAgg`: the 3x3x3 window of voxel cells around each query
  point, read from a dense ladder volume: the relative offset of each cell
  centre and its features through a shared MLP, a max over the occupied
  cells. The 27 rows come from one contiguous (B, D*H*W, C+1) table of the
  volume and its occupancy through the row gather (`gather_rows`, its
  backward the row scatter-add), where the JAX package fetches 9 x-rolled
  wide rows.
- `SparseVoxelNeighborAgg`: the same pool over a sparse ladder's slot table,
  through a grid of slot ids (cell -> slot + 1) scattered once per call.
- `VectorPoolAgg`: PV-RCNN++'s raw-point source. Up to NSAMPLE points in a
  ball around each keypoint (`sa_fused.fused_query_group`), each put in its
  sub-voxel of a LOCAL_GRID^3 grid over the ball by its offset, the offsets
  and features averaged per sub-voxel (a one-hot matrix product and a
  count), the sub-voxels' averages concatenated through an MLP, zero where
  the ball is empty. The JAX package rounds the averaged values to bf16;
  they are its bf16 extraction already, which `jax_bf16_extraction` of the
  tests emulates.
- `VoxelSetAbstraction`: keypoints of the raw cloud, by FPS or, for
  PV-RCNN++ (SAMPLE_METHOD 'SPC' with proposals in the batch), by sector FPS
  over the points near a proposal (`pointnet2.sector_fps`: one masked FPS
  kernel launch for all sectors of all clouds), and their features from the
  sources FEATURES_SOURCE names ('bev', 'raw_points' through `SAGroupMLP` or
  `VectorPoolAgg`, 'x_conv1' .. 'x_conv4' through the pools above), fused
  by a Linear + BatchNorm + ReLU.

The relative offsets, the clipping of the base cell's x to [1, W - 2], the
masks and the rows fetched for cells outside the volume are the JAX
package's, so the BatchNorm statistics of a training step see the same rows.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ...ops import dispatch
from ...ops import pointnet2 as plain
from ...ops import sa_fused
from ...ops.sa_fused import GatherRows
from ...ops.sparse_maps import ladder_shapes
from ...utils.config import as_cfg
from ..layers import BatchNormLast
from .pointnet2_backbone import SAGroupMLP

# the 27 cells of a window, dz outer then dy then dx, as (dz, dy, dx)
WINDOW = np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1], indexing='ij'),
                  -1).reshape(27, 3)


def bilinear_from_bev(bev: torch.Tensor, keypoints: torch.Tensor, pc_range, voxel_size,
                      bev_stride: float) -> torch.Tensor:
    """bev (B, H, W, C), keypoints (B, K, 3) -> (B, K, C): the bilinear
    interpolation of the four cells around each keypoint, the lower corner
    clipped into the map."""
    B, H, W, C = bev.shape
    x = (keypoints[..., 0] - pc_range[0]) / voxel_size[0] / bev_stride
    y = (keypoints[..., 1] - pc_range[1]) / voxel_size[1] / bev_stride
    x0 = torch.floor(x).to(torch.int32).clamp(0, W - 2)
    y0 = torch.floor(y).to(torch.int32).clamp(0, H - 2)
    fx = (x - x0).clamp(0.0, 1.0)
    fy = (y - y0).clamp(0.0, 1.0)
    flat = bev.reshape(B, H * W, C)

    def corner(dy, dx):
        idx = ((y0 + dy) * W + (x0 + dx)).long()
        return torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))

    return (corner(0, 0) * ((1 - fx) * (1 - fy))[..., None]
            + corner(0, 1) * (fx * (1 - fy))[..., None]
            + corner(1, 0) * ((1 - fx) * fy)[..., None]
            + corner(1, 1) * (fx * fy)[..., None])


class VoxelNeighborAgg(nn.Module):
    """Window pool over a dense volume. `in_channels` is the volume's width;
    the MLP's layers are `fc<i>` (Linear, no bias) and `bn<i>` (BatchNorm
    eps 1e-5), the JAX package's names."""

    def __init__(self, in_channels: int, mlp: Sequence[int], voxel_size, pc_range,
                 device=None):
        super().__init__()
        self.mlp = [int(c) for c in mlp]
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.pc_range = tuple(float(v) for v in pc_range)
        c_in = 3 + in_channels
        for i, c in enumerate(self.mlp):
            self.add_module(f'fc{i}', nn.Linear(c_in, c, bias=False, device=device))
            self.add_module(f'bn{i}', BatchNormLast(c, eps=1e-5, momentum=0.1, device=device))
            c_in = c
        self.out_channels = self.mlp[-1]

    def cells(self, keypoints: torch.Tensor, downsample: int, dims) -> tuple:
        """Each query point's base cell (ix clipped to [1, W - 2], iy and iz
        into the grid) and the relative offsets (B, K, 27, 3) of the window's
        cell centres from the point, in metres."""
        D, H, W = dims
        vx = self.voxel_size[0] * downsample
        vy = self.voxel_size[1] * downsample
        vz = self.voxel_size[2] * downsample
        kx = (keypoints[..., 0] - self.pc_range[0]) / vx
        ky = (keypoints[..., 1] - self.pc_range[1]) / vy
        kz = (keypoints[..., 2] - self.pc_range[2]) / vz
        ix = kx.to(torch.int32).clamp(1, max(W - 2, 0))
        iy = ky.to(torch.int32).clamp(0, H - 1)
        iz = kz.to(torch.int32).clamp(0, D - 1)
        dt, dev = keypoints.dtype, keypoints.device
        base = torch.stack([ix, iy, iz], -1).to(dt)
        frac = torch.stack([kx, ky, kz], -1) - base                          # (B, K, 3)
        offs = torch.as_tensor(WINDOW[:, ::-1].copy(), dtype=dt, device=dev)  # (27, 3) xyz
        rel = offs[None, None] + 0.5 - frac[:, :, None, :]
        rel = rel * torch.tensor([vx, vy, vz], dtype=dt, device=dev)
        return ix.long(), iy.long(), iz.long(), rel

    def pool(self, rel: torch.Tensor, rows: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
        """The shared MLP over [rel; rows] (B, K, 27, 3 + C), the max over the
        occupied cells, zero where no cell is occupied."""
        h = torch.cat([rel, rows], dim=-1)
        for i in range(len(self.mlp)):
            h = torch.relu(getattr(self, f'bn{i}')(getattr(self, f'fc{i}')(h)))
        out = torch.where(occ[..., None], h, float('-inf')).amax(dim=2)
        return torch.where(occ.any(dim=2)[..., None], out, 0.0)

    def forward(self, volume: torch.Tensor, occupancy: torch.Tensor, keypoints: torch.Tensor,
                downsample: int) -> torch.Tensor:
        """volume (B, D, H, W, C) (a channels-last view is fine), occupancy
        (B, D, H, W) bool, keypoints (B, K, 3) -> (B, K, mlp[-1])."""
        B, D, H, W, C = volume.shape
        K = keypoints.shape[1]
        ix, iy, iz, rel = self.cells(keypoints, downsample, (D, H, W))
        # one contiguous table of the volume and its occupancy, C + 1 wide
        table = torch.cat([volume, occupancy[..., None].to(volume.dtype)], dim=-1)
        table = table.reshape(B, D * H * W, C + 1)
        win = torch.as_tensor(WINDOW, device=keypoints.device)
        zz = iz[..., None] + win[:, 0]                                       # (B, K, 27)
        yy = iy[..., None] + win[:, 1]
        okb = (zz >= 0) & (zz < D) & (yy >= 0) & (yy < H)
        # a window row outside the volume reads the cells around row 0 (the
        # one before it a zero row), as the JAX package's rolled rows do
        row = torch.where(okb, (zz * H + yy) * W + ix[..., None], 0)
        idx = row + win[:, 2]
        rows = GatherRows.apply(table, idx.reshape(B, K * 27)).reshape(B, K, 27, C + 1)
        occ = (rows[..., C] > 0.5) & okb
        return self.pool(rel, rows[..., :C], occ)


class SparseVoxelNeighborAgg(VoxelNeighborAgg):
    """The window pool over a sparse ladder's stage: its slot table (B, V,
    C), coordinates (B, V, 3) zyx and mask. The stage's active cells are
    scattered into a grid of slot ids (B * (D*H*W + 1) int32, cell -> slot
    + 1, 0 empty; padding slots all write the spare last cell), the 27 ids
    of each window are read from it and the hit rows gathered from the slot
    table. Same parameters and the same result as `VoxelNeighborAgg` on the
    densified stage."""

    def forward(self, feats: torch.Tensor, coords: torch.Tensor, mask: torch.Tensor,
                keypoints: torch.Tensor, downsample: int, dims) -> torch.Tensor:
        B, V, C = feats.shape
        K = keypoints.shape[1]
        D, H, W = (int(v) for v in dims)
        ix, iy, iz, rel = self.cells(keypoints, downsample, (D, H, W))
        ncell = D * H * W
        co = coords.long()
        key = torch.where(mask, (co[..., 0] * H + co[..., 1]) * W + co[..., 2], ncell)
        boff = (torch.arange(B, device=key.device) * (ncell + 1))[:, None]
        ids = torch.zeros(B * (ncell + 1), dtype=torch.int32, device=feats.device)
        ids[(key + boff).reshape(-1)] = (torch.arange(V, dtype=torch.int32, device=feats.device)
                                         + 1).repeat(B)
        win = torch.as_tensor(WINDOW, device=keypoints.device)
        zz = iz[..., None] + win[:, 0]
        yy = iy[..., None] + win[:, 1]
        xx = ix[..., None] + win[:, 2]
        okb = (zz >= 0) & (zz < D) & (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        q = torch.where(okb, (zz * H + yy) * W + xx, ncell)
        slot1 = ids[(q + boff[..., None]).reshape(-1)].reshape(B, K, 27)
        hit = (slot1 > 0) & okb
        # a miss reads row V, outside the table: a zero row
        idx = torch.where(hit, slot1.long() - 1, V)
        rows = GatherRows.apply(feats.contiguous(), idx.reshape(B, K * 27)).reshape(B, K, 27, C)
        return self.pool(rel, rows, hit)


class VectorPoolAgg(nn.Module):
    """Config of the raw-point source: POOL_RADIUS[0], NSAMPLE[0],
    LOCAL_GRID, MLPS[0]; `in_channels` is the points' feature width (0 for
    none). Layers `fc<i>` (Linear, no bias) and `bn<i>` (BatchNorm eps
    1e-5), the JAX package's names."""

    def __init__(self, in_channels: int, radius: float, nsample: int, local_grid: int,
                 mlp: Sequence[int], pc_range, device=None):
        super().__init__()
        self.radius, self.nsample, self.grid = float(radius), int(nsample), int(local_grid)
        self.pc_range = tuple(float(v) for v in pc_range)
        self.mlp = [int(c) for c in mlp]
        c_in = self.grid ** 3 * (3 + in_channels)
        for i, c in enumerate(self.mlp):
            self.add_module(f'fc{i}', nn.Linear(c_in, c, bias=False, device=device))
            self.add_module(f'bn{i}', BatchNormLast(c, eps=1e-5, momentum=0.1, device=device))
            c_in = c
        self.out_channels = self.mlp[-1]

    def subvoxel_mean(self, neigh: torch.Tensor, cid: torch.Tensor,
                      live: torch.Tensor) -> torch.Tensor:
        """The mean of the live samples (B, M, K, C') of each sub-voxel cid,
        (B, M, G^3, C'), 0 in an empty one: a one-hot matrix product and a
        count."""
        onehot = ((cid[..., None] == torch.arange(self.grid ** 3, device=cid.device))
                  & live[..., None]).to(neigh.dtype)                          # (B, M, K, G3)
        sums = torch.einsum('bmkg,bmkc->bmgc', onehot, neigh)
        cnt = onehot.sum(dim=2)[..., None]                                   # (B, M, G3, 1)
        return torch.where(cnt > 0, sums / cnt.clamp(min=1.0), 0.0)

    def forward(self, xyz: torch.Tensor, features: torch.Tensor | None,
                keypoints: torch.Tensor) -> torch.Tensor:
        """xyz (B, N, 3), features (B, N, C) or None, keypoints (B, M, 3) ->
        (B, M, mlp[-1])."""
        B, M, _ = keypoints.shape
        G = self.grid
        (rel, gfeat, _, hit), = sa_fused.fused_query_group(
            [self.radius], [self.nsample], xyz, features, keypoints, self.pc_range, cap=32)
        neigh = rel if gfeat is None else torch.cat([rel, gfeat], dim=-1)   # (B, M, K, 3 + C)
        cell = ((rel / (2 * self.radius) + 0.5) * G).to(torch.int32).clamp(0, G - 1)
        cid = (cell[..., 0] * G + cell[..., 1]) * G + cell[..., 2]
        # every slot of a ball with a hit counts, the first hit's repeats too
        live = (rel.abs() > 1e-6).any(dim=-1) | hit[..., None]
        h = self.subvoxel_mean(neigh, cid, live).reshape(B, M, -1)
        for i in range(len(self.mlp)):
            h = torch.relu(getattr(self, f'bn{i}')(getattr(self, f'fc{i}')(h)))
        return torch.where(hit[..., None], h, 0.0)


def sparse_stage_dims(point_cloud_range, voxel_size, stride) -> tuple:
    """(D, H, W) of the sparse ladder's stage of downsample `stride` (1, 2,
    4, 8: stages 1 to 4), as `ops/sparse_maps.ladder_shapes` gives them."""
    pr = np.asarray(point_cloud_range, np.float64)
    grid = np.round((pr[3:6] - pr[0:3]) / np.asarray(voxel_size)).astype(int)
    return tuple(ladder_shapes(grid)[{1: 0, 2: 1, 4: 2, 8: 3}[int(stride)]])


def stage_channels(bb_cfg) -> dict:
    """Channels of the 3D backbone's stages 'x_conv1' .. 'x_conv4' (its
    NUM_FILTERS, [16, 32, 64, 64] by default), dense or sparse ladder."""
    filters = list(bb_cfg.get('NUM_FILTERS', [16, 32, 64, 64]))
    return {f'x_conv{k + 1}': int(c) for k, c in enumerate(filters)}


def is_sparse_ladder(bb_cfg) -> bool:
    """Whether the backbone is the sparse ladder, whose stages are slot
    tables ('multi_scale_3d_features_sparse'), not dense volumes."""
    return bb_cfg.get('NAME', '') in ('SparseVoxelBackBone8x', 'SparseVoxelResBackBone8x')


class VoxelSetAbstraction(nn.Module):
    """Config: NUM_KEYPOINTS, NUM_OUTPUT_FEATURES, SAMPLE_METHOD (FPS, or SPC
    with SPC_SAMPLING {SAMPLE_RADIUS_WITH_ROI, NUM_SECTORS}), FEATURES_SOURCE,
    SA_LAYER. Takes 'points' (B, N, 3 + C) and the 3D
    backbone's outputs; adds 'point_coords' (the keypoints, B, K, 3),
    'point_features_before_fusion' (B, K, num_fused_features) and
    'point_features' (B, K, NUM_OUTPUT_FEATURES). `stage_widths` maps each
    'x_conv<k>' to its channels, `sparse` says which ladder reads them."""

    def __init__(self, model_cfg, voxel_size, point_cloud_range, num_bev_features: int,
                 num_rawpoint_features: int, stage_widths: dict, sparse: bool, device=None):
        super().__init__()
        cfg = as_cfg(model_cfg)
        self.cfg = cfg
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.pc_range = tuple(float(v) for v in point_cloud_range)
        self.sparse = sparse
        method = cfg.get('SAMPLE_METHOD', 'FPS')
        if method not in ('FPS', 'SPC'):
            raise NotImplementedError(f'SAMPLE_METHOD {method} is not ported (the JAX package '
                                      'has FPS and SPC)')
        self.spc = method == 'SPC'
        self.sources = list(cfg.FEATURES_SOURCE)
        sa_cfg = cfg.SA_LAYER
        width = 0
        if 'bev' in self.sources:
            width += num_bev_features
        if 'raw_points' in self.sources:
            rp = sa_cfg.raw_points
            pr = self.pc_range
            bev_range = (pr[0], pr[1], pr[3], pr[4])
            self.vector_pool = rp.get('AGGREGATION', '') == 'VectorPoolAgg'
            if self.vector_pool:
                self.vp_raw = VectorPoolAgg(num_rawpoint_features - 3, rp.POOL_RADIUS[0],
                                            rp.NSAMPLE[0], rp.get('LOCAL_GRID', 3), rp.MLPS[0],
                                            bev_range, device=device)
                width += self.vp_raw.out_channels
            else:
                mlps = [list(m) for m in rp.MLPS]
                self.sa_raw = SAGroupMLP(num_rawpoint_features - 3, list(rp.POOL_RADIUS),
                                         list(rp.NSAMPLE), mlps, use_xyz=True,
                                         pc_range=bev_range, device=device)
                width += sum(int(m[-1]) for m in mlps)
        agg_cls = SparseVoxelNeighborAgg if sparse else VoxelNeighborAgg
        self.conv_sources = [s for s in self.sources if s.startswith('x_conv')]
        for src in self.conv_sources:
            mlps = [list(m) if isinstance(m, (list, tuple)) else m for m in sa_cfg[src].MLPS]
            mlp = mlps[0] if isinstance(mlps[0], list) else mlps
            self.add_module(f'agg_{src}', agg_cls(stage_widths[src], mlp, voxel_size,
                                                  point_cloud_range, device=device))
            width += int(mlp[-1])
        self.num_fused_features = width
        self.num_point_features = int(cfg.NUM_OUTPUT_FEATURES)
        self.fusion = nn.Linear(width, self.num_point_features, bias=False, device=device)
        self.fusion_bn = BatchNormLast(self.num_point_features, eps=1e-5, momentum=0.1,
                                       device=device)

    def keypoint_indices(self, batch: dict, xyz: torch.Tensor) -> torch.Tensor:
        """(B, NUM_KEYPOINTS) indices into the raw points: FPS of the cloud,
        or with SPC and proposals in the batch the sector FPS of the points
        within SAMPLE_RADIUS_WITH_ROI of a proposal's centre in BEV (every
        point of a cloud without a valid proposal)."""
        cfg = self.cfg
        n_key = int(cfg.NUM_KEYPOINTS)
        if not (self.spc and 'rois' in batch):
            return dispatch.farthest_point_sample(xyz, n_key)
        spc = cfg.SPC_SAMPLING
        rad = float(spc.SAMPLE_RADIUS_WITH_ROI)
        rois = batch['rois'][..., :2]
        d = xyz[:, :, None, :2] - rois[:, None, :, :]
        d2 = (d * d).sum(-1).amin(dim=-1)                                    # (B, N)
        roi_mask = batch.get('roi_mask')
        has_roi = (roi_mask.any(dim=-1, keepdim=True) if roi_mask is not None
                   else torch.ones_like(d2[:, :1], dtype=torch.bool))
        near = (d2 < rad * rad) | ~has_roi
        return plain.sector_fps(xyz, near, n_key, int(spc.get('NUM_SECTORS', 6)),
                                per_sector_cap=min(n_key, xyz.shape[1]))

    def forward(self, batch: dict) -> dict:
        cfg = self.cfg
        points = batch['points']
        xyz = points[..., :3].contiguous()
        keypoints = plain.gather_operation(xyz, self.keypoint_indices(batch, xyz))  # (B, K, 3)
        # the JAX package's order: the BEV map, the raw points, then the stages
        feats = []
        if 'bev' in self.sources:
            # a map without its stride (a HeightCompression BEV) is at 8
            feats.append(bilinear_from_bev(batch['spatial_features'], keypoints, self.pc_range,
                                           self.voxel_size,
                                           batch.get('spatial_features_stride', 8)))
        if 'raw_points' in self.sources:
            raw = points[..., 3:] if points.shape[-1] > 3 else None
            feats.append(self.vp_raw(xyz, raw, keypoints) if self.vector_pool
                         else self.sa_raw(xyz, raw, keypoints))
        for src in self.conv_sources:
            agg = getattr(self, f'agg_{src}')
            down = int(cfg.SA_LAYER[src].DOWNSAMPLE_FACTOR)
            if self.sparse:
                f, co, mk, stride = batch['multi_scale_3d_features_sparse'][src]
                feats.append(agg(f, co, mk, keypoints, down,
                                 sparse_stage_dims(self.pc_range, self.voxel_size, stride)))
            else:
                vol, occ, _ = batch['multi_scale_3d_features'][src]
                feats.append(agg(vol, occ, keypoints, down))
        fused = torch.cat(feats, dim=-1)
        batch['point_features_before_fusion'] = fused
        batch['point_features'] = torch.relu(self.fusion_bn(self.fusion(fused)))
        batch['point_coords'] = keypoints
        return batch
