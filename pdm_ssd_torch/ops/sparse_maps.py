"""Kernel maps of the sparse voxel ladder (counterpart of
`pdm_ssd_tpu/ops/sparse_maps.py`, the plain 8x ladder).

The neighbour tables of every sparse conv depend on the voxel coordinates
only, so they are built once per batch, before the backbone runs, and every
layer of a stage shares its table. The JAX package builds them in numpy (or
C) on the host; here they are built with tensor ops (`torch.sort`,
`torch.searchsorted`, `torch.unique`) on the device of the coordinates, and
equal its output integer for integer.

Conventions (the JAX package's):
- coords are (V, 3) int32 **zyx**; a stage's slots are its active cells
  sorted by the flat key `(z*H + y)*W + x`, padding at the end;
- a map entry is a slot of the producing stage's table; the one-past-the-end
  slot `cap` of that table means "absent neighbour";
- SubMConv3d k3 p1: outputs at the input sites, tap (kz, ky, kx) reads the
  neighbour at coord + (kz-1, ky-1, kx-1);
- SparseConv3d k s p: output site `o` is active iff an input lies in its
  receptive field `o*s - p + k`; a stage that would hold more than its cap
  keeps the first `cap` keys;
- the input z extent is `D + 1` (the reference's `sparse_shape`).

The transpose maps of the training backward (`invert_down_map`,
`batch_invert_ladder`) are built the same way, on the device of the maps,
with fixed shapes and no host sync.

The focal ladder of `VoxelBackBone8xFocal` (`build_focal_ladder_maps`:
each focal stage's candidate table and its maximal dilation, with the
tables that say where a learned mask may spawn a site) and the BEV slot
table of VoxelNeXt's head (`build_bev_maps`) follow the JAX package's
builders the same way. The focal ladder's strided maps have transposes too
(`batch_invert_focal`), which the JAX package does not build: its strided
focal convs take XLA's gradient, the port's sparse conv reads a transposed
map.

`SparseUNetV2`'s decoder convolves through the transposed maps as forward
maps (`get_host_prepare` ships the first three of them in eval too). The
packed-window correction buckets of QWIN / PWIN have no counterpart: the
sparse-conv kernel needs no window plans, and `get_host_prepare` raises for
them (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import torch

__all__ = ['build_backbone8x_maps', 'batch_build_backbone8x', 'ladder_shapes', 'LADDER_KEYS',
           'default_caps', 'invert_down_map', 'batch_invert_down_maps', 'batch_invert_ladder',
           'UPMAP_KEYS', 'focal_kernel_offsets', 'FOCAL_KEYS', 'FOCAL_UPMAP_KEYS',
           'build_focal_ladder_maps', 'batch_build_focal', 'batch_invert_focal', 'BEV_KEYS',
           'build_bev_maps', 'batch_build_bev']


def _flat(coords: torch.Tensor, dims) -> torch.Tensor:
    """(..., 3) zyx -> int64 flat key under dims (D, H, W)."""
    _, H, W = dims
    c = coords.long()
    return (c[..., 0] * H + c[..., 1]) * W + c[..., 2]


def _lookup(sorted_keys: torch.Tensor, n_valid: int, queries: torch.Tensor) -> torch.Tensor:
    """Slot of each query in the sorted key array, or `len(sorted_keys)` (the
    pad slot) when absent. `sorted_keys[n_valid:]` is padding."""
    cap = sorted_keys.numel()
    if n_valid <= 0:
        return torch.full(queries.shape, cap, dtype=torch.int32, device=queries.device)
    keys = sorted_keys[:n_valid].contiguous()
    pos = torch.searchsorted(keys, queries.contiguous()).clamp(max=n_valid - 1)
    return torch.where(keys[pos] == queries, pos, cap).int()


def _taps(ranges, device) -> torch.Tensor:
    return torch.stack(torch.meshgrid(*ranges, indexing='ij'), -1).reshape(-1, 3).to(device)


def _in_bounds(cells: torch.Tensor, dims) -> torch.Tensor:
    return ((cells >= 0) & (cells < torch.tensor(dims, device=cells.device))).all(dim=-1)


def _subm_map(coords: torch.Tensor, n_valid: int, dims, ksize) -> torch.Tensor:
    """(cap, K) neighbour slots of a submanifold conv at the given sites."""
    cap = coords.shape[0]
    offs = _taps([torch.arange(k) - k // 2 for k in ksize], coords.device)
    nbr = coords.long()[:, None, :] + offs[None, :, :]            # (cap, K, 3)
    ok = _in_bounds(nbr, dims)
    ok[n_valid:] = False
    out = _lookup(_flat(coords, dims), n_valid, _flat(nbr, dims).reshape(-1))
    return torch.where(ok, out.reshape(cap, -1), cap).int()


def _down_sites(coords: torch.Tensor, n_valid: int, dims, ksize, stride, pad, cap_out: int):
    """Active output sites of a strided sparse conv: the union over inputs of
    the output cells whose receptive field covers them. Returns (coords_out
    (cap_out, 3) sorted by flat key, n_out, dims_out, n_sites): `n_sites` is
    the size of the union, `n_out = min(n_sites, cap_out)` of it are kept."""
    dev = coords.device
    dims_out = tuple((d + 2 * p - k) // s + 1 for d, k, s, p in zip(dims, ksize, stride, pad))
    c = coords[:n_valid].long()
    per_axis = []
    for ax, (k, s, p) in enumerate(zip(ksize, stride, pad)):
        num = c[:, ax:ax + 1] + p - torch.arange(k, device=dev)[None, :]     # (n, k)
        ok = (num >= 0) & (num % s == 0)
        o = torch.div(num, s, rounding_mode='floor')
        per_axis.append((o, ok & (o < dims_out[ax])))
    (oz, okz), (oy, oky), (ox, okx) = per_axis
    ok = okz[:, :, None, None] & oky[:, None, :, None] & okx[:, None, None, :]
    flat = (oz[:, :, None, None] * dims_out[1] + oy[:, None, :, None]) * dims_out[2] \
        + ox[:, None, None, :]
    uniq = torch.unique(flat[ok])                                            # sorted
    n_sites = int(uniq.numel())
    n_out = min(n_sites, cap_out)
    u = uniq[:n_out]
    out = torch.zeros((cap_out, 3), dtype=torch.int32, device=dev)
    out[:n_out] = torch.stack([u // (dims_out[2] * dims_out[1]),
                               (u // dims_out[2]) % dims_out[1], u % dims_out[2]], -1).int()
    return out, n_out, dims_out, n_sites


def _down_map(coords_in, n_in: int, dims_in, coords_out, n_out: int, ksize, stride, pad):
    """(cap_out, K) input slots read by each output site of a strided conv."""
    cap_out, cap_in = coords_out.shape[0], coords_in.shape[0]
    dev = coords_out.device
    taps = _taps([torch.arange(k) for k in ksize], dev)
    s = torch.tensor(stride, device=dev)
    p = torch.tensor(pad, device=dev)
    src = coords_out.long()[:, None, :] * s - p + taps[None, :, :]            # (cap_out, K, 3)
    ok = _in_bounds(src, dims_in)
    ok[n_out:] = False
    out = _lookup(_flat(coords_in, dims_in), n_in, _flat(src, dims_in).reshape(-1))
    return torch.where(ok, out.reshape(cap_out, -1), cap_in).int()


# (ksize, stride, pad) of each downsample of VoxelBackBone8x
_DOWN_SPECS = [
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)),   # conv2
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)),   # conv3
    ((3, 3, 3), (2, 2, 2), (0, 1, 1)),   # conv4, z-pad 0
    ((3, 1, 1), (2, 1, 1), (0, 0, 0)),   # conv_out
]

LADDER_KEYS = (
    ['sp_perm1', 'sp_coords1', 'sp_mask1', 'sp_submap1']
    + sum([[f'sp_coords{s}', f'sp_mask{s}', f'sp_downmap{s}', f'sp_submap{s}']
           for s in (2, 3, 4)], [])
    + ['sp_coords_out', 'sp_mask_out', 'sp_outmap']
)


def ladder_shapes(grid_size_whd) -> list:
    """(D, H, W) of stages 1 to 4 and of the output, the input z extended by 1."""
    W, H, D = (int(v) for v in grid_size_whd)
    dims = [(D + 1, H, W)]
    for ks, st, pd in _DOWN_SPECS:
        dims.append(tuple((dd + 2 * p - k) // s + 1 for dd, k, s, p in zip(dims[-1], ks, st, pd)))
    return dims


def build_backbone8x_maps(coords: torch.Tensor, n_valid: int, grid_size_whd, caps) -> dict:
    """One cloud. coords (cap1, 3) int32 zyx, the first `n_valid` valid, in any
    order (`sp_perm1` brings the voxel features into sorted-slot order).
    caps: slot capacities [cap1, cap2, cap3, cap4, cap_out]. Returns the
    LADDER_KEYS tensors and 'sites': the sites each stage would hold without
    its cap (a list of 5 ints; a stage dropped `max(0, sites - cap)`)."""
    dev = coords.device
    dims = ladder_shapes(grid_size_whd)
    cap1 = caps[0]
    n1 = min(int(n_valid), cap1)
    order = torch.sort(_flat(coords[:n1], dims[0]), stable=True)[1]
    c1 = torch.zeros((cap1, 3), dtype=torch.int32, device=dev)
    c1[:n1] = coords[:n1].int()[order]
    perm = torch.zeros((cap1,), dtype=torch.int32, device=dev)
    perm[:n1] = order.int()

    def mask(cap, n):
        return torch.arange(cap, device=dev) < n

    out = {'sp_perm1': perm, 'sp_coords1': c1, 'sp_mask1': mask(cap1, n1),
           'sp_submap1': _subm_map(c1, n1, dims[0], (3, 3, 3))}
    sites = [int(n_valid)]
    prev_c, prev_n, prev_dims = c1, n1, dims[0]
    for s, (ks, st, pd), cap in zip((2, 3, 4), _DOWN_SPECS[:3], caps[1:4]):
        c, n, d, n_sites = _down_sites(prev_c, prev_n, prev_dims, ks, st, pd, cap)
        sites.append(n_sites)
        out[f'sp_coords{s}'] = c
        out[f'sp_mask{s}'] = mask(cap, n)
        out[f'sp_downmap{s}'] = _down_map(prev_c, prev_n, prev_dims, c, n, ks, st, pd)
        out[f'sp_submap{s}'] = _subm_map(c, n, d, (3, 3, 3))
        prev_c, prev_n, prev_dims = c, n, d
    ks, st, pd = _DOWN_SPECS[3]
    co, no, _, n_sites = _down_sites(prev_c, prev_n, prev_dims, ks, st, pd, caps[4])
    sites.append(n_sites)
    out['sp_coords_out'] = co
    out['sp_mask_out'] = mask(caps[4], no)
    out['sp_outmap'] = _down_map(prev_c, prev_n, prev_dims, co, no, ks, st, pd)
    out['sites'] = sites
    return out


def batch_build_backbone8x(voxel_coords: torch.Tensor, voxel_mask: torch.Tensor,
                           grid_size_whd, caps) -> dict:
    """`build_backbone8x_maps` stacked over the batch. voxel_coords (B, V, 3)
    zyx, voxel_mask (B, V) bool with the valid voxels first. Returns the
    LADDER_KEYS tensors, each with a leading batch axis, and 'sp_sites'
    (B, 5) int64 on the CPU."""
    counts = voxel_mask.sum(dim=1).tolist()
    per = [build_backbone8x_maps(voxel_coords[b], counts[b], grid_size_whd, caps)
           for b in range(voxel_coords.shape[0])]
    out = {k: torch.stack([p[k] for p in per]) for k in LADDER_KEYS}
    out['sp_sites'] = torch.tensor([p['sites'] for p in per])
    return out


def default_caps(max_voxels: int) -> list:
    """Slot capacities where the config names none: strided sparse convs
    dilate the active set before later stages shrink it."""
    v = int(max_voxels)
    return [v, v, (3 * v) // 4, v // 2, v // 2]


def invert_down_map(downmap: torch.Tensor, cap_in: int) -> torch.Tensor:
    """The transposed map of a strided conv: `up[j, K-1-k] = i` iff
    `downmap[i, k] == j`. Fine slot j receives the coarse slot i that read it
    at tap k, stored at the flipped tap, as a transposed conv reads its
    kernel; the (j, k) -> i assignment is unique by geometry. downmap
    (..., cap_out, K) with pad `cap_in` -> (..., cap_in, K) int32 with pad
    `cap_out`: a map of the layout every sparse conv reads. One scatter of
    fixed shape, absent entries sent to a spare row that is dropped."""
    *lead, cap_out, K = downmap.shape
    dev = downmap.device
    d = downmap.reshape(-1, cap_out, K).long()
    B = d.shape[0]
    j = torch.where((d >= 0) & (d < cap_in), d, cap_in)
    rows = j + (torch.arange(B, device=dev) * (cap_in + 1))[:, None, None]
    flat = rows * K + (K - 1 - torch.arange(K, device=dev))
    src = torch.arange(cap_out, dtype=torch.int32, device=dev)[None, :, None].expand(B, -1, K)
    up = torch.full((B * (cap_in + 1) * K,), cap_out, dtype=torch.int32, device=dev)
    # each slot of a present entry is written once; `amin` keeps the spare
    # row's many writes deterministic
    up.scatter_reduce_(0, flat.reshape(-1), src.reshape(-1), reduce='amin')
    return up.view(B, cap_in + 1, K)[:, :cap_in].reshape(*lead, cap_in, K).contiguous()


UPMAP_KEYS = ['sp_upmap2', 'sp_upmap3', 'sp_upmap4', 'sp_upmap_out']


def batch_invert_down_maps(maps: dict, caps) -> dict:
    """'sp_upmap{2,3,4}' (B, caps[s-2], 27) from the batched ladder maps."""
    return {f'sp_upmap{s}': invert_down_map(maps[f'sp_downmap{s}'], cap_in)
            for s, cap_in in zip((2, 3, 4), caps[:3])}


def batch_invert_ladder(maps: dict, caps) -> dict:
    """All four transpose maps of the ladder (UPMAP_KEYS): those of the three
    strided convs and of `conv_out`'s K=3 map against `caps[3]`. The maps
    the sparse conv's data gradient reads for the strided layers."""
    out = batch_invert_down_maps(maps, caps)
    out['sp_upmap_out'] = invert_down_map(maps['sp_outmap'], caps[3])
    return out


# ---- the focal ladder (`VoxelBackBone8xFocal`) ------------------------------
#
# A focal stage's learned mask may spawn sites at the 26 neighbours of its
# foreground sites. The maps hold every site any mask could activate: each
# focal stage's candidate table C_s, its maximal dilation E_s = C_s and the
# in-bounds 26-neighbourhood of its sites, and the next stage's sites are
# those of a strided conv over E_s. The learned mask toggles activation bits
# over these fixed tables (`models/backbones_3d/sparse_backbone_focal.py`).


def focal_kernel_offsets(device=None) -> torch.Tensor:
    """(26, 3) int64: the offsets of a 3x3x3 kernel without its center, z
    outer, x inner, the reference's channel order of the importance map."""
    offs = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)
            if (i, j, k) != (0, 0, 0)]
    return torch.tensor(offs, dtype=torch.int64, device=device)


def _dilate_table(coords: torch.Tensor, n_valid: int, dims, cap_e: int):
    """The maximal dilation of an active table: its sites and their in-bounds
    26 neighbours, sorted by flat key, capped at `cap_e`. When the cap binds,
    every site of the table is kept and the spawn candidates are cut in
    flat-key order. Returns (ecoords (cap_e, 3), n_e, eorig (cap_e,) the
    site's slot in the base table or cap_base, espawn (cap_e, 26) the base
    slot of `ecoord - offset_j` or cap_base). A spawn lands only on a site
    whose every coordinate is strictly above 0 (the reference's `> 0`)."""
    dev = coords.device
    cap_base = coords.shape[0]
    offs = focal_kernel_offsets(dev)
    c = coords[:n_valid].long()
    nbr = (c[:, None, :] + offs[None]).reshape(-1, 3)
    base_keys = _flat(c, dims)
    cand = torch.unique(_flat(nbr[_in_bounds(nbr, dims)], dims))
    cand = cand[~torch.isin(cand, base_keys)]
    room = max(cap_e - base_keys.numel(), 0)
    u = torch.sort(torch.cat([base_keys, cand[:room]]))[0][:cap_e]
    n_e = int(u.numel())
    ecoords = torch.zeros((cap_e, 3), dtype=torch.int32, device=dev)
    ecoords[:n_e] = torch.stack([u // (dims[2] * dims[1]), (u // dims[2]) % dims[1],
                                 u % dims[2]], -1).int()
    sk = _flat(coords, dims)
    eorig = _lookup(sk, n_valid, _flat(ecoords, dims))
    eorig[n_e:] = cap_base
    src = ecoords.long()[:, None, :] - offs[None]                         # (cap_e, 26, 3)
    ok = _in_bounds(src, dims) & (ecoords.amin(dim=-1) > 0)[:, None]
    ok[n_e:] = False
    espawn = _lookup(sk, n_valid, _flat(src, dims).reshape(-1)).reshape(cap_e, 26)
    return ecoords, n_e, eorig, torch.where(ok, espawn, cap_base).int()


FOCAL_KEYS = (
    ['fl_perm1']
    + sum([[f'fl_coords{s}', f'fl_cmask{s}', f'fl_submap{s}', f'fl_ecoords{s}', f'fl_emask{s}',
            f'fl_eorig{s}', f'fl_espawn{s}', f'fl_esubmap{s}'] for s in (1, 2, 3)], [])
    + ['fl_downmap2', 'fl_downmap3', 'fl_downmap4', 'fl_coords4', 'fl_cmask4', 'fl_submap4',
       'fl_coords_out', 'fl_cmask_out', 'fl_outmap']
)


def build_focal_ladder_maps(coords: torch.Tensor, n_valid: int, grid_size_whd, caps,
                            ecaps) -> dict:
    """One cloud's maps of `VoxelBackBone8xFocal` (the FOCAL_KEYS tensors):
    the ladder with a dilated table after each of stages 1 to 3, the stages
    below built from the dilated tables. coords (cap1, 3) int32 zyx, the
    first `n_valid` valid, in any order (`fl_perm1` sorts them stably by
    flat key). caps: candidate capacities [cap1, cap2, cap3, cap4, cap_out];
    ecaps: dilated capacities [capE1, capE2, capE3]."""
    dev = coords.device
    dims = ladder_shapes(grid_size_whd)
    cap1 = caps[0]
    n1 = min(int(n_valid), cap1)
    order = torch.sort(_flat(coords[:n1], dims[0]), stable=True)[1]
    c = torch.zeros((cap1, 3), dtype=torch.int32, device=dev)
    c[:n1] = coords[:n1].int()[order]
    perm = torch.zeros((cap1,), dtype=torch.int32, device=dev)
    perm[:n1] = order.int()

    def mask(cap, n):
        return torch.arange(cap, device=dev) < n

    out = {'fl_perm1': perm}
    n = n1
    for s in (1, 2, 3):
        d = dims[s - 1]
        out[f'fl_coords{s}'] = c
        out[f'fl_cmask{s}'] = mask(c.shape[0], n)
        out[f'fl_submap{s}'] = _subm_map(c, n, d, (3, 3, 3))
        ec, ne, eorig, espawn = _dilate_table(c, n, d, ecaps[s - 1])
        out[f'fl_ecoords{s}'] = ec
        out[f'fl_emask{s}'] = mask(ecaps[s - 1], ne)
        out[f'fl_eorig{s}'] = eorig
        out[f'fl_espawn{s}'] = espawn
        out[f'fl_esubmap{s}'] = _subm_map(ec, ne, d, (3, 3, 3))
        ks, st, pd = _DOWN_SPECS[s - 1]
        c, n, _, _ = _down_sites(ec, ne, d, ks, st, pd, caps[s])
        out[f'fl_downmap{s + 1}'] = _down_map(ec, ne, d, c, n, ks, st, pd)
    out['fl_coords4'] = c
    out['fl_cmask4'] = mask(caps[3], n)
    out['fl_submap4'] = _subm_map(c, n, dims[3], (3, 3, 3))
    ks, st, pd = _DOWN_SPECS[3]
    co, no, _, _ = _down_sites(c, n, dims[3], ks, st, pd, caps[4])
    out['fl_coords_out'] = co
    out['fl_cmask_out'] = mask(caps[4], no)
    out['fl_outmap'] = _down_map(c, n, dims[3], co, no, ks, st, pd)
    return out


def batch_build_focal(voxel_coords: torch.Tensor, voxel_mask: torch.Tensor, grid_size_whd,
                      caps, ecaps) -> dict:
    """`build_focal_ladder_maps` stacked over the batch: the FOCAL_KEYS
    tensors, each with a leading batch axis."""
    counts = voxel_mask.sum(dim=1).tolist()
    per = [build_focal_ladder_maps(voxel_coords[b], counts[b], grid_size_whd, caps, ecaps)
           for b in range(voxel_coords.shape[0])]
    return {k: torch.stack([p[k] for p in per]) for k in FOCAL_KEYS}


FOCAL_UPMAP_KEYS = ['fl_upmap2', 'fl_upmap3', 'fl_upmap4', 'fl_upmap_out']


def batch_invert_focal(maps: dict, caps, ecaps) -> dict:
    """The transposed maps of the focal ladder's strided convs
    (FOCAL_UPMAP_KEYS), for the sparse conv's data gradient: the down convs
    of stages 2 to 4 read the dilated tables of stages 1 to 3 (`ecaps`),
    `conv_out` reads stage 4's candidate table (`caps[3]`)."""
    out = {f'fl_upmap{s}': invert_down_map(maps[f'fl_downmap{s}'], cap_in)
           for s, cap_in in zip((2, 3, 4), ecaps[:3])}
    out['fl_upmap_out'] = invert_down_map(maps['fl_outmap'], caps[3])
    return out


# ---- VoxelNeXt's BEV slot table ----------------------------------------------
#
# VoxelNeXt's head works on the ladder's output sites compressed in height:
# one BEV slot per occupied (y, x) cell of the stride-8 grid, and a 3x3
# submanifold map over those slots.

BEV_KEYS = ['sp_bev_coords', 'sp_bev_mask', 'sp_bev_from_out', 'sp_bev_submap']


def build_bev_maps(coords_out: torch.Tensor, n_valid: int, bev_hw) -> dict:
    """One cloud. coords_out (cap, 3) zyx of the ladder's output sites, the
    first `n_valid` valid; bev_hw (H, W) of the stride-8 grid. Returns
    'sp_bev_coords' (cap, 2) (y, x) sorted by y*W + x, 'sp_bev_mask' (cap,),
    'sp_bev_from_out' (cap,) each output site's BEV slot (cap where absent),
    'sp_bev_submap' (cap, 9) the 3x3 neighbour slots, (dy, dx) taps with x
    inner, cap where absent."""
    dev = coords_out.device
    H, W = (int(v) for v in bev_hw)
    cap = coords_out.shape[0]
    c = coords_out[:n_valid].long()
    key = c[:, 1] * W + c[:, 2]
    uniq = torch.unique(key)[:cap]
    nb = int(uniq.numel())
    bev = torch.zeros((cap, 2), dtype=torch.int32, device=dev)
    bev[:nb] = torch.stack([uniq // W, uniq % W], -1).int()
    from_out = torch.full((cap,), cap, dtype=torch.int32, device=dev)
    from_out[:n_valid] = _lookup(uniq, nb, key)
    from_out[from_out == nb] = cap      # `_lookup` names a miss by the table's length
    offs = torch.stack(torch.meshgrid(torch.arange(3) - 1, torch.arange(3) - 1, indexing='ij'),
                       -1).reshape(-1, 2).to(dev)
    nbr = bev.long()[:, None, :] + offs[None]                                 # (cap, 9, 2)
    ok = ((nbr >= 0) & (nbr < torch.tensor([H, W], device=dev))).all(dim=-1)
    ok[nb:] = False
    sub = _lookup(uniq, nb, (nbr[..., 0] * W + nbr[..., 1]).reshape(-1)).reshape(cap, 9)
    return {'sp_bev_coords': bev, 'sp_bev_mask': torch.arange(cap, device=dev) < nb,
            'sp_bev_from_out': from_out,
            'sp_bev_submap': torch.where(ok & (sub < nb), sub, cap).int()}


def batch_build_bev(coords_out: torch.Tensor, mask_out: torch.Tensor, bev_hw) -> dict:
    """`build_bev_maps` stacked over the batch: the BEV_KEYS tensors, each
    with a leading batch axis."""
    counts = mask_out.sum(dim=1).tolist()
    per = [build_bev_maps(coords_out[b], counts[b], bev_hw) for b in range(coords_out.shape[0])]
    return {k: torch.stack([p[k] for p in per]) for k in BEV_KEYS}
