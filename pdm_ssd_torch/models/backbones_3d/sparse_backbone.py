"""Sparse voxel backbones (counterpart of
`pdm_ssd_tpu/models/backbones_3d/sparse_backbone.py`, `SparseVoxelBackBone8x`,
its residual form, and Part-A2's `SparseUNetV2`).

Each layer is a gather-matmul sparse convolution over a fixed-capacity slot
table (`ops/dispatch.sparse_conv`: the Hopper kernel on CUDA tensors, the
plain gather + matmul on the CPU), then a BatchNorm over the active slots and
a ReLU. A forward builds the kernel's plan
(`ops/sparse_conv.sparse_conv_plan`) once per map and hands it to every layer
of that map: 12 layers, 8 maps. The neighbour tables come with the batch,
built from the voxel coordinates by `ops/sparse_maps.py`
(`models.get_host_prepare`). Padding slots are exactly zero after every
layer, so they feed zero rows to the next.

The JAX package's gather strategies `XWIN`, `QWIN`, `PWIN` and
`LAYER_BARRIER` are ways to fetch the same rows with fewer TPU gathers and do
not change the result (`XWIN` is bitwise the plain gather): the port reads
those keys, builds no window plans and runs the one kernel. `TABLE_DTYPE:
bf16` does change the numbers in the JAX package (it gathers, multiplies and
normalises in bf16); the port stays in float32, a known deviation with a
stated tolerance in `tests/test_torch_port_sparse.py`. `TABLE_DTYPE: int8`
raises. A batch prepared for training (`get_host_prepare(..., training=True)`)
carries the transposed maps of the strided convs (`sp_upmap*`); the forward
then hands each layer its backward map and that map's plan, built once per
map beside the forward plans, and the sparse conv's backward
(`ops/sparse_conv.SparseConvFunction`) gathers the output gradient through
them: a submanifold map is its own transpose, so its layers reuse the
forward map and plan.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops import dispatch
from ...ops.sparse_conv import sparse_conv_plan
from ...ops.sparse_maps import ladder_shapes
from ...parallel import ddp
from ...utils.config import as_cfg


class MaskedBatchNorm(nn.BatchNorm1d):
    """BatchNorm over the active rows of a padded slot table (B, V, C) with
    mask (B, V): eps 1e-3, flax momentum 0.99 (torch 0.01). In training mode
    the statistics are the masked mean and the biased variance of the active
    rows, and the running values move towards them. Masked rows come out zero.
    Under data parallelism the rows are the global batch's: the masked sums
    and the count, then the squared deviations from the global mean, are
    summed over the ranks through autograd (`parallel.sync_sum`)."""

    def __init__(self, num_features: int, device=None):
        super().__init__(num_features, eps=1e-3, momentum=0.01, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            m = mask[..., None].to(x.dtype)
            sums = ddp.sync_sum(torch.cat([(x * m).sum(dim=(0, 1)), m.sum().view(1)]))
            cnt = sums[-1].clamp(min=1.0)
            mean = sums[:-1] / cnt
            var = ddp.sync_sum(((x - mean) ** 2 * m).sum(dim=(0, 1))) / cnt
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return torch.where(mask[..., None], y, 0.0)


class SparseConvBNReLU(nn.Module):
    """One sparse conv layer: submanifold when `nbr` maps a stage onto itself,
    strided when it maps onto the previous stage's slots. `kernel` is
    (K * Cin, Cout), taps outer, as flax stores it."""

    def __init__(self, in_features: int, features: int, taps: int, use_relu: bool = True,
                 device=None):
        super().__init__()
        self.use_relu = use_relu
        self.kernel = nn.Parameter(torch.empty((taps * in_features, features), device=device))
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features, device=device)

    def forward(self, feats: torch.Tensor, nbr: torch.Tensor, out_mask: torch.Tensor,
                plan=None, bwd_nbr=None, bwd_plan=None):
        x = dispatch.sparse_conv(feats, nbr, self.kernel, plan, bwd_nbr, bwd_plan)
        x = self.MaskedBatchNorm_0(x, out_mask)
        if self.use_relu:
            x = torch.relu(x)
        return torch.where(out_mask[..., None], x, 0.0)


class SparseBasicBlock(nn.Module):
    """Residual block of two submanifold convs: conv-bn-relu, conv-bn,
    + identity, relu."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.SparseConvBNReLU_0 = SparseConvBNReLU(features, features, 27, device=device)
        self.SparseConvBNReLU_1 = SparseConvBNReLU(features, features, 27, use_relu=False,
                                                   device=device)

    def forward(self, feats: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor, plan=None,
                bwd_nbr=None, bwd_plan=None):
        x = self.SparseConvBNReLU_0(feats, nbr, mask, plan, bwd_nbr, bwd_plan)
        x = self.SparseConvBNReLU_1(x, nbr, mask, plan, bwd_nbr, bwd_plan)
        return torch.where(mask[..., None], torch.relu(x + feats), 0.0)


class SparseVoxelBackBone8x(nn.Module):
    """Config: NUM_FILTERS (default [16, 32, 64, 64]), OUT_FEATURES (128),
    RESIDUAL (False: plain blocks; True: `SparseVoxelResBackBone8x`).

    Consumes 'voxel_features' (B, cap1, Cin) and the ladder tables
    (`ops/sparse_maps.LADDER_KEYS`). Adds 'spatial_features' (B, Hy, Wx,
    Dz * OUT_FEATURES): the stride-8 BEV map with z folded into the channels,
    z outer, in the JAX package's channels-last layout, which the 2D backbone
    takes; 'multi_scale_3d_features_sparse' {x_conv1..4: (feats, coords,
    mask, stride)}; 'encoded_sparse_out' (feats, coords, mask);
    'spatial_features_stride' 8. With `dense_canvas=False` (VoxelNeXt,
    whose head reads 'encoded_sparse_out' only) 'spatial_features' is not
    made."""

    def __init__(self, model_cfg, input_channels: int, grid_size, residual: bool = False,
                 dense_canvas: bool = True, device=None):
        super().__init__()
        cfg = as_cfg(model_cfg)
        filters = list(cfg.get('NUM_FILTERS', [16, 32, 64, 64]))
        self.out_features = cfg.get('OUT_FEATURES', 128)
        self.residual = cfg.get('RESIDUAL', residual)
        self.dense_canvas = dense_canvas
        dtype = str(cfg.get('TABLE_DTYPE', '')).lower()
        if dtype == 'int8':
            raise NotImplementedError('TABLE_DTYPE int8 is not ported (ROADMAP Queue 1 item 10, '
                                      'the rest of the sparse voxel ladder)')
        self.shapes = ladder_shapes(grid_size)
        self.num_bev_features = self.out_features * self.shapes[4][0]

        self.stage_layers = {}      # stage name -> names of its submanifold layers

        def blocks(name, ch, n):
            kind = 'block' if self.residual else 'subm'
            self.stage_layers[name] = [f'{name}_{kind}{i}' for i in range(n)]
            for layer in self.stage_layers[name]:
                self.add_module(layer, SparseBasicBlock(ch, device=device) if self.residual
                                else SparseConvBNReLU(ch, ch, 27, device=device))

        self.conv_input = SparseConvBNReLU(input_channels, filters[0], 27, device=device)
        blocks('conv1', filters[0], 2 if self.residual else 1)
        for s, c_in, ch in zip((2, 3, 4), filters[:3], filters[1:]):
            self.add_module(f'down{s}', SparseConvBNReLU(c_in, ch, 27, device=device))
            blocks(f'conv{s}', ch, 2)
        self.conv_out = SparseConvBNReLU(filters[3], self.out_features, 3, device=device)

    def _stage(self, name: str, x, nbr, mask, plan, bwd: bool):
        """The submanifold layers of a stage: their map is its own transpose."""
        for layer in self.stage_layers[name]:
            x = getattr(self, layer)(x, nbr, mask, plan, *((nbr, plan) if bwd else ()))
        return x

    def scatter_to_bev(self, x: torch.Tensor, coords: torch.Tensor, mask: torch.Tensor):
        """The final actives x (B, Vo, C) at coords (B, Vo, 3) zyx onto the dense
        stride-8 canvas, z folded into the channels: (B, Hy, Wx, Dz * C). An
        index assignment, since a cloud's active out-sites are distinct cells;
        the padding slots all write their zero rows to one spare cell, which
        is dropped."""
        Dz, Hy, Wx = self.shapes[4]
        co = coords.long()
        ncell = Dz * Hy * Wx
        flat = torch.where(mask, (co[..., 0] * Hy + co[..., 1]) * Wx + co[..., 2], ncell)
        B, C = flat.shape[0], x.shape[-1]
        flat = flat + (torch.arange(B, device=flat.device) * (ncell + 1))[:, None]
        canvas = x.new_zeros((B * (ncell + 1), C))
        canvas[flat.reshape(-1)] = x.reshape(-1, C)
        dense = canvas.view(B, ncell + 1, C)[:, :ncell].reshape(B, Dz, Hy, Wx, C)
        return dense.permute(0, 2, 3, 1, 4).reshape(B, Hy, Wx, Dz * C)

    def forward(self, batch: dict) -> dict:
        if 'sp_submap1' not in batch:
            raise KeyError('the batch holds no kernel maps: pass it through '
                           'models.get_host_prepare(model_cfg, dataset_cfg) first')
        # the voxel features in sorted-slot order
        feats = dispatch.gather_rows(batch['voxel_features'], batch['sp_perm1'])
        # a training batch carries the strided convs' transposed maps
        bwd = 'sp_upmap2' in batch

        def up(key, rows):
            """(transposed map, its plan) of a strided conv, in training."""
            if not bwd:
                return ()
            return batch[key], sparse_conv_plan(batch[key], rows)

        ms = {}
        m1, n1 = batch['sp_mask1'], batch['sp_submap1']
        p1 = sparse_conv_plan(n1, n1.shape[1])
        x = self.conv_input(torch.where(m1[..., None], feats, 0.0), n1, m1, p1,
                            *((n1, p1) if bwd else ()))
        x = self._stage('conv1', x, n1, m1, p1, bwd)
        ms['x_conv1'] = (x, batch['sp_coords1'], m1, 1)
        for s in (2, 3, 4):
            mask, down, sub = batch[f'sp_mask{s}'], batch[f'sp_downmap{s}'], batch[f'sp_submap{s}']
            x = getattr(self, f'down{s}')(x, down, mask, sparse_conv_plan(down, x.shape[1]),
                                          *up(f'sp_upmap{s}', mask.shape[1]))
            x = self._stage(f'conv{s}', x, sub, mask, sparse_conv_plan(sub, sub.shape[1]), bwd)
            ms[f'x_conv{s}'] = (x, batch[f'sp_coords{s}'], mask, 2 ** (s - 1))
        mo, no = batch['sp_mask_out'], batch['sp_outmap']
        x = self.conv_out(x, no, mo, sparse_conv_plan(no, x.shape[1]),
                          *up('sp_upmap_out', mo.shape[1]))
        if self.dense_canvas:
            batch['spatial_features'] = self.scatter_to_bev(x, batch['sp_coords_out'], mo)
        batch['multi_scale_3d_features_sparse'] = ms
        batch['encoded_sparse_out'] = (x, batch['sp_coords_out'], mo)
        batch['spatial_features_stride'] = 8
        return batch


class SparseUNetV2(nn.Module):
    """Part-A2's sparse UNet: the ladder's encoder (conv_input, conv1_subm0,
    down<s>, conv<s>_subm0 and _subm1 for s = 2..4, conv_out to the BEV map)
    and a decoder of four UR blocks, 4 to 1. UR block s: a residual block of
    two submanifold convs over the stage's encoder output ('up<s>_t'), its
    concatenation after the coarser features (2C channels), a submanifold
    conv back to C ('up<s>_m') plus the channel reduction (channels 2c and
    2c + 1 summed), then the inverse conv to the next finer stage
    ('up<s>_inv'): a conv through the transposed map of the stage's strided
    conv, `sp_upmap<s>`, read forward, its backward through the strided
    conv's own map. UR block 1's inverse slot is a submanifold conv at stage
    1. The batch must hold `sp_upmap2` to `sp_upmap4` in eval too
    (`models.get_host_prepare` builds them for this backbone); a training
    batch also holds `sp_upmap_out`, conv_out's backward map.

    Config: NUM_FILTERS, OUT_FEATURES, TABLE_DTYPE as the ladder's. Sets what
    the ladder sets but 'encoded_sparse_out' and the multi-scale features,
    and 'point_features' (B, cap1, NUM_FILTERS[0]) at the stage-1 slots,
    'point_coords' (the slots' voxel centres) and 'point_mask'."""

    def __init__(self, model_cfg, input_channels: int, grid_size, voxel_size, point_cloud_range,
                 device=None):
        super().__init__()
        cfg = as_cfg(model_cfg)
        f = list(cfg.get('NUM_FILTERS', [16, 32, 64, 64]))
        self.out_features = cfg.get('OUT_FEATURES', 128)
        if str(cfg.get('TABLE_DTYPE', '')).lower() == 'int8':
            raise NotImplementedError('TABLE_DTYPE int8 is not ported (ROADMAP Queue 1 item 10, '
                                      'the rest of the sparse voxel ladder)')
        self.shapes = ladder_shapes(grid_size)
        self.num_bev_features = self.out_features * self.shapes[4][0]
        self.num_point_features = f[0]
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.pc_range = tuple(float(v) for v in point_cloud_range)

        def conv(name, c_in, ch, taps=27):
            self.add_module(name, SparseConvBNReLU(c_in, ch, taps, device=device))

        conv('conv_input', input_channels, f[0])
        conv('conv1_subm0', f[0], f[0])
        for s, c_in, ch in zip((2, 3, 4), f[:3], f[1:]):
            conv(f'down{s}', c_in, ch)
            conv(f'conv{s}_subm0', ch, ch)
            conv(f'conv{s}_subm1', ch, ch)
        conv('conv_out', f[3], self.out_features, taps=3)
        # UR block s works at stage s's width and hands stage s - 1's width on
        for s, ch, ch_out in ((4, f[3], f[2]), (3, f[2], f[1]), (2, f[1], f[0]), (1, f[0], f[0])):
            self.add_module(f'up{s}_t', SparseBasicBlock(ch, device=device))
            conv(f'up{s}_m', 2 * ch, ch)
            conv(f'up{s}_inv', ch, ch_out)

    scatter_to_bev = SparseVoxelBackBone8x.scatter_to_bev

    def forward(self, batch: dict) -> dict:
        if 'sp_upmap2' not in batch:
            raise KeyError('the batch holds no inverse maps: pass it through '
                           'models.get_host_prepare(model_cfg, dataset_cfg) first')
        feats = dispatch.gather_rows(batch['voxel_features'], batch['sp_perm1'])
        m = {s: batch[f'sp_mask{s}'] for s in (1, 2, 3, 4)}
        sub, down, up = {}, {}, {}
        for s in (1, 2, 3, 4):
            n = batch[f'sp_submap{s}']
            sub[s] = (n, sparse_conv_plan(n, n.shape[1]))
        for s in (2, 3, 4):
            d, u = batch[f'sp_downmap{s}'], batch[f'sp_upmap{s}']
            down[s] = (d, sparse_conv_plan(d, u.shape[1]))       # reads stage s - 1's slots
            up[s] = (u, sparse_conv_plan(u, d.shape[1]))         # reads stage s's slots

        def layer(name, x, fwd, mask, bwd):
            """A conv through map `fwd`, its data gradient through `bwd`."""
            return getattr(self, name)(x, fwd[0], mask, fwd[1], bwd[0], bwd[1])

        x = layer('conv_input', torch.where(m[1][..., None], feats, 0.0), sub[1], m[1], sub[1])
        enc = {1: layer('conv1_subm0', x, sub[1], m[1], sub[1])}
        x = enc[1]
        for s in (2, 3, 4):
            x = layer(f'down{s}', x, down[s], m[s], up[s])
            x = layer(f'conv{s}_subm0', x, sub[s], m[s], sub[s])
            enc[s] = x = layer(f'conv{s}_subm1', x, sub[s], m[s], sub[s])
        mo, no = batch['sp_mask_out'], batch['sp_outmap']
        out_bwd = ((batch['sp_upmap_out'], sparse_conv_plan(batch['sp_upmap_out'], mo.shape[1]))
                   if 'sp_upmap_out' in batch else (None, None))
        xo = layer('conv_out', x, (no, sparse_conv_plan(no, x.shape[1])), mo, out_bwd)
        batch['spatial_features'] = self.scatter_to_bev(xo, batch['sp_coords_out'], mo)
        batch['spatial_features_stride'] = 8

        x = enc[4]
        for s in (4, 3, 2, 1):
            t = getattr(self, f'up{s}_t')(enc[s], sub[s][0], m[s], sub[s][1], *sub[s])
            cat = torch.cat([x, t], dim=-1)
            ch = t.shape[-1]
            xm = layer(f'up{s}_m', cat, sub[s], m[s], sub[s])
            red = cat.reshape(*cat.shape[:-1], ch, 2).sum(-1)
            x = torch.where(m[s][..., None], xm + red, 0.0)
            if s > 1:
                x = layer(f'up{s}_inv', x, up[s], m[s - 1], down[s])
            else:
                x = layer('up1_inv', x, sub[1], m[1], sub[1])

        c1 = batch['sp_coords1'].float()                                 # zyx
        vsz, org = self.voxel_size, self.pc_range
        batch['point_features'] = x
        batch['point_coords'] = torch.stack([(c1[..., 2] + 0.5) * vsz[0] + org[0],
                                             (c1[..., 1] + 0.5) * vsz[1] + org[1],
                                             (c1[..., 0] + 0.5) * vsz[2] + org[2]], dim=-1)
        batch['point_mask'] = m[1]
        return batch
