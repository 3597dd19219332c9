"""MPPNet's ROI head: multi-frame proposal refinement with grouped
transformers (counterpart of `pdm_ssd_tpu/models/roi_heads/mppnet_head.py`).

1. Trajectories (`generate_trajectory`): each current proposal moved back
   through its velocity and matched (3D IoU >= 0.5, the first best) against
   each previous frame's proposals; an unmatched frame keeps the current box
   and is invalid.
2. Per-frame crops: up to K points of each frame inside each trajectory box
   (`pool_roi_points`, any K), taken from the frame by
   `dispatch.grouping_operation` (the `gather_rows` kernel on CUDA).
3. Geometry features: each cropped point's offsets to the box's 8 corners
   and centre in spherical form, its intensity and its frame's time,
   through `up_geometry`, then pooled onto the box's GRID_SIZE^3 proxy
   points: for each radius the max of `sa_mlp` over the in-radius points.
4. Motion features: the proxies of every frame relative to frame 0's box,
   with a time code, through `up_motion`; added to the geometry.
5. The trajectory branch: the box sequence in frame 0's box frame through a
   PointNet over time (`seqbox_*`), its feature and an auxiliary box.
6. The grouped transformer: frames in `num_groups` groups, encoder layers
   over each group's proxy tokens, a masked max a group, a learned query
   (`traj_query`) attending the groups (`cross_group`), the score from the
   query (`cls_trunk`, `class_embed`) and the box from the group tokens and
   the trajectory feature (`jointembed`).

The streaming variant keeps a memory bank, a dict of fixed-shape tensors
threaded through `MPPNet.predict_with_state`: the past frames' boxes, their
validity and their projected proxy features; only the current frame is
cropped and featurized each step.

The aggregation of step 3 is the head's heavy part. The JAX package
concatenates each (point, proxy) pair's offset with the point's feature and
runs `sa_mlp` over (B, R, P, K, 3 + C) once a radius. The port computes the
same function with less: the first layer's product split over the
concatenation (the offsets by their 3 rows of the weight, each point's
feature once by the rest, broadcast over the proxies), so the concatenation
never exists; and `sa_mlp` once a frame for every radius, since its input
does not depend on the radius (only the mask does). In training the
BatchNorm statistics still move once a radius from that one run's batch
statistics (`stat_updates`), as the JAX package's one call a radius on the
same input moves them, and each frame's aggregation is recomputed in the
backward (`layers.checkpoint_call`), which keeps one frame's activations
alive instead of all of them.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...ops import box_ops, dispatch, iou3d
from ...utils.config import as_cfg
from ..layers import LayerNorm, MultiHeadAttention, SharedMLP, checkpoint_call
from .pointrcnn_head import pool_roi_points
from .roi_head_template import RoIHeadTemplate


class EncoderLayer(nn.Module):
    """Pre-norm self-attention and a 2x feed-forward, both residual
    (`ln1`, `attn`, `ln2`, `ff1`, `ff2`)."""

    def __init__(self, d_model: int, nhead: int = 4, device=None):
        super().__init__()
        self.ln1 = LayerNorm(d_model, device=device)
        self.attn = MultiHeadAttention(d_model, d_model, nhead, device=device)
        self.ln2 = LayerNorm(d_model, device=device)
        self.ff1 = nn.Linear(d_model, 2 * d_model, device=device)
        self.ff2 = nn.Linear(2 * d_model, d_model, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x (S, L, C); mask (S, L), True where a token is valid."""
        h = self.ln1(x)
        x = x + self.attn(h, h, mask=mask[:, None, None, :])
        return x + self.ff2(torch.relu(self.ff1(self.ln2(x))))


class MLP3(nn.Module):
    """`layers - 1` Linear + ReLU layers of `hidden` channels (`l<i>`), then a
    Linear to `out` (`out`)."""

    def __init__(self, in_channels: int, hidden: int, out: int, layers: int = 3, device=None):
        super().__init__()
        self.n = layers - 1
        c = in_channels
        for i in range(self.n):
            self.add_module(f'l{i}', nn.Linear(c, hidden, device=device))
            c = hidden
        self.out = nn.Linear(c, out, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = torch.relu(getattr(self, f'l{i}')(x))
        return self.out(x)


def dense_grid_points(rois: torch.Tensor, grid_size: int) -> torch.Tensor:
    """(..., 7) ROIs -> (..., G^3, 3) proxy points in the global frame: cell
    (i, j, k) of each box's G^3 lattice, number i * G^2 + j * G + k, at its
    centre, as the JAX package's MPPNet head computes it."""
    g = grid_size
    idx = np.stack(np.meshgrid(np.arange(g), np.arange(g), np.arange(g), indexing='ij'),
                   -1).reshape(-1, 3)
    idx = torch.as_tensor(idx, dtype=torch.float32, device=rois.device)
    lead = rois.shape[:-1]
    flat = rois.reshape(-1, rois.shape[-1])
    local = (idx[None] + 0.5) / g * flat[:, None, 3:6] - flat[:, None, 3:6] / 2
    local = box_ops.rotate_points_along_z(local, flat[:, 6])
    return (local + flat[:, None, :3]).reshape(lead + (g ** 3, 3))


def spherical_offsets(xyz: torch.Tensor, anchors: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
    """xyz (..., P, 3), anchors (..., 9, 3), diag (...,) -> (..., P, 27): the
    distance to each anchor over the box diagonal, then the azimuths, then
    the inclinations."""
    off = xyz[..., :, None, :] - anchors[..., None, :, :]             # (..., P, 9, 3)
    dis = torch.linalg.norm(off, dim=-1)
    phi = torch.atan(off[..., 1] / (off[..., 0] + 1e-5))
    the = torch.arccos(torch.clamp(off[..., 2] / (dis + 1e-5), -1, 1))
    dis = dis / (diag[..., None, None] + 1e-5)
    return torch.cat([dis, phi, the], dim=-1)


def box_anchors(rois: torch.Tensor) -> torch.Tensor:
    """(..., 7+) -> (..., 9, 3): the 8 corners, then the centre."""
    flat = rois.reshape(-1, rois.shape[-1])
    corners = box_ops.boxes_to_corners_3d(flat[:, :7])                 # (N, 8, 3)
    return torch.cat([corners, flat[:, None, :3]], dim=1).reshape(rois.shape[:-1] + (9, 3))


def head_params(model_cfg) -> dict:
    """The head's sizes from its config (the reference schema, with the
    legacy flat keys as fallbacks): T frames, G groups, K points a crop, d
    channels, encoder layers, heads, the proxy grid, the pool radii and
    `sa_mlp`'s widths."""
    cfg = as_cfg(model_cfg)
    tr = cfg.get('Transformer', {}) or {}
    gp = cfg.get('ROI_GRID_POOL', {}) or {}
    return {
        'T': int(cfg.get('NUM_FRAMES', 4)),
        'G': int(tr.get('num_groups', cfg.get('NUM_GROUPS', 2))),
        'K': int(tr.get('num_lidar_points', cfg.get('SAMPLE_POINTS_PER_FRAME', 32))),
        'd': int(cfg.get('TRANS_INPUT', cfg.get('HIDDEN_CHANNEL', 64))),
        'enc_layers': int(tr.get('enc_layers', 1)),
        'nhead': int(tr.get('nheads', cfg.get('NUM_HEADS', 4))),
        'grid': int(gp.get('GRID_SIZE', 4)),
        'radii': [float(r) for r in gp.get('POOL_RADIUS', [0.8, 1.6])],
        'mlp': [int(c) for c in (gp.get('MLPS', [[32, 32]]) or [[32, 32]])[0]],
    }


def init_mppnet_memory(head_cfg, batch_size: int, num_rois: int, device=None) -> dict:
    """The empty memory bank of step 0 of a streamed sequence: T - 1 past
    frames of boxes with velocity ('rois'), validity ('valid') and projected
    proxy features ('feat'). Invalid slots match nothing, so step 0 falls
    back to the current frame's features."""
    hp = head_params(head_cfg)
    P, T, d = hp['grid'] ** 3, hp['T'], hp['d']
    return {
        'rois': torch.zeros((batch_size, T - 1, num_rois, 9), device=device),
        'valid': torch.zeros((batch_size, T - 1, num_rois), dtype=torch.bool, device=device),
        'feat': torch.zeros((batch_size, T - 1, num_rois, P, d), device=device),
    }


class MPPNetHead(RoIHeadTemplate):
    """Config: NUM_FRAMES, TRANS_INPUT, Transformer {num_lidar_points,
    num_proxy_points, num_groups, enc_layers, nheads, hidden_dim},
    ROI_GRID_POOL {GRID_SIZE, POOL_RADIUS, MLPS}, NMS_CONFIG, TARGET_CONFIG,
    LOSS_CONFIG. The submodules carry the JAX package's names."""

    # the parameters the head holds itself, named as in the flax tree, with
    # the deviation of their normal initialisation
    flax_params = {'traj_query': 0.02}
    code_size = 7

    def __init__(self, model_cfg, num_class: int, device=None):
        super().__init__(model_cfg, num_class)
        hp = self.hp = head_params(self.model_cfg)
        d, nr = hp['d'], max(len(hp['radii']), 1)
        self.up_geometry = MLP3(29, 64, d // nr, device=device)
        self.sa_mlp = SharedMLP(3 + d // nr, hp['mlp'], device=device)
        for j in range(self.sa_mlp.n):
            getattr(self.sa_mlp, f'BatchNorm_{j}').stat_updates = len(hp['radii'])
        self.geo_proj = nn.Linear(len(hp['radii']) * hp['mlp'][-1], d, device=device)
        self.up_motion = MLP3(30, 64, d, device=device)
        c = 8
        for i, ch in enumerate((64, 128, d)):
            self.add_module(f'seqbox_{i}', nn.Linear(c, ch, device=device))
            c = ch
        self.seqbox_reg = nn.Linear(d, self.code_size, device=device)
        self.point_embed = nn.Linear(d, d, device=device)
        for li in range(hp['enc_layers']):
            self.add_module(f'enc_{li}', EncoderLayer(d, hp['nhead'], device=device))
        self.traj_query = nn.Parameter(torch.empty((1, 1, d), device=device))
        self.cross_group = MultiHeadAttention(d, d, hp['nhead'], device=device)
        self.cls_trunk = SharedMLP(d, (d,), device=device)
        self.class_embed = nn.Linear(d, 1, device=device)
        self.jointembed = MLP3(hp['G'] * d + d, d, self.code_size, layers=4, device=device)

    @torch.no_grad()
    def proposal_layer(self, batch: dict) -> dict:
        """Offline proposals (USE_PREDBOX): with per-frame stage-1 boxes in
        the batch ('roi_boxes' (B, T, R, 9), 'roi_scores', 'roi_labels'),
        frame 0's are the ROIs (their velocity kept as 'roi_vel', the mask
        where every size is positive) and the whole stack feeds the
        trajectory matching as 'proposals_multi_frame'; no NMS runs.
        Otherwise the template's NMS over the first stage's boxes."""
        rb = batch.get('roi_boxes')
        if rb is not None and rb.dim() == 4:
            batch['rois'] = rb[:, 0, :, :7]
            batch['roi_vel'] = rb[:, 0, :, 7:9]
            batch['roi_scores'] = batch['roi_scores'][:, 0]
            batch['roi_labels'] = batch['roi_labels'][:, 0].to(torch.int32)
            batch['roi_mask'] = (rb[:, 0, :, 3:6] > 0).all(-1)
            batch['proposals_multi_frame'] = rb
            return batch
        return super().proposal_layer(batch)

    @torch.no_grad()
    def generate_trajectory(self, rois: torch.Tensor, roi_mask, proposals_mf,
                            with_match: bool = False) -> tuple:
        """rois (B, R, 7 or 9; columns 7:9 the velocity when given),
        proposals_mf (B, T, P, 9) the proposals of each frame or None (every
        frame a copy of the current boxes). Returns the trajectories (B, T,
        R, 7) and their validity (B, T, R); with `with_match` also the
        matched proposal of each frame (B, T, R) int32, frame 0 the
        identity (the memory bank's matching table)."""
        T = self.hp['T']
        B, R = rois.shape[:2]
        cur = rois[..., :7]
        vel = rois[..., 7:9] if rois.shape[-1] > 8 else rois.new_zeros((B, R, 2))
        traj = [cur]
        valid = [torch.ones((B, R), dtype=torch.bool, device=rois.device)
                 if roi_mask is None else roi_mask]
        match = [torch.arange(R, dtype=torch.int32, device=rois.device).expand(B, R)]
        prev = torch.cat([cur, vel], -1)
        for t in range(1, T):
            if proposals_mf is None:
                traj.append(cur)
                valid.append(valid[0])
                match.append(match[0])
                continue
            shifted = prev[..., :7].clone()
            shifted[..., 0:2] = shifted[..., 0:2] + (-prev[..., 7:9] * 0.1)
            props = proposals_mf[:, t]                                     # (B, P, 9)
            ious = iou3d.boxes_iou3d(shifted, props[..., :7])              # (B, R, P)
            best = torch.argmax(ious, dim=-1)                              # the first maximum
            fg = ious.amax(dim=-1) >= 0.5
            matched = torch.gather(props, 1, best[..., None].expand(-1, -1, props.shape[-1]))
            traj.append(torch.where(fg[..., None], matched[..., :7], cur))
            valid.append(fg & valid[0])
            match.append(best.to(torch.int32))
            prev = torch.where(fg[..., None], matched, torch.cat([shifted, prev[..., 7:9]], -1))
        out = (torch.stack(traj, dim=1), torch.stack(valid, dim=1))
        return out + (torch.stack(match, dim=1),) if with_match else out

    def aggregate(self, rel: torch.Tensor, pf: torch.Tensor, masks: list) -> torch.Tensor:
        """`sa_mlp` over each (point, proxy) pair's [offset, point feature],
        max-pooled over the points within each radius: rel (B, R, P, K, 3),
        pf (B, R, K, C), masks one (B, R, P, K) a radius. Returns (B, R, P,
        radii * C'); a proxy with no point in a radius gets zeros there."""
        mlp = self.sa_mlp
        w0 = mlp.Dense_0.weight                                            # (H, 3 + C)
        h = rel @ w0[:, :3].T + (pf @ w0[:, 3:].T)[:, :, None]
        h = torch.relu(mlp.BatchNorm_0(h))
        for j in range(1, mlp.n):
            h = torch.relu(getattr(mlp, f'BatchNorm_{j}')(getattr(mlp, f'Dense_{j}')(h)))
        per_r = []
        for w in masks:
            m = torch.where(w[..., None], h, float('-inf')).amax(dim=3)
            per_r.append(torch.where(w.any(dim=3)[..., None], m, 0.0))
        return torch.cat(per_r, dim=-1)

    def frame_geometry(self, frames_t: torch.Tensor, rois_t: torch.Tensor, diag_t: torch.Tensor,
                       valid_t: torch.Tensor, roi_mask, t: int) -> torch.Tensor:
        """Frame t's points (B, N, 3 + F) cropped into its trajectory boxes
        rois_t (B, R, 7), their geometry features pooled onto the boxes'
        proxies: (B, R, P, radii * C')."""
        hp = self.hp
        B, R = rois_t.shape[:2]
        K = hp['K']
        idx, pvalid = pool_roi_points(frames_t[..., :3], rois_t[..., :7], K, extra=0.5,
                                      roi_mask=roi_mask)
        pvalid = pvalid & valid_t[..., None]
        pooled = dispatch.grouping_operation(frames_t, idx)                # (B, R, K, 3 + F)
        sph = spherical_offsets(pooled[..., :3], box_anchors(rois_t), diag_t)
        tcol = torch.full((B, R, K, 1), t * 0.1, dtype=torch.float32, device=rois_t.device)
        feat_in = torch.cat([sph, pooled[..., 3:4], tcol], -1)             # 29 channels
        pf = self.up_geometry(torch.where(pvalid[..., None], feat_in, 0.0))
        proxies = dense_grid_points(rois_t, hp['grid'])                    # (B, R, P, 3)
        rel = pooled[..., None, :, :3] - proxies[..., None, :]             # (B, R, P, K, 3)
        d2 = (rel * rel).sum(-1)
        masks = [(d2 < r * r) & pvalid[:, :, None, :] for r in hp['radii']]
        return self.aggregate(rel, pf, masks)

    def forward(self, batch: dict, target_generator: torch.Generator | None = None) -> dict:
        """The ROI predictions on one of three feature paths: 'trajectory_rois'
        given (with 'points_multi_frame'), the memory bank ('mppnet_memory':
        the past frames from the bank, the current one cropped; the bank
        rolled by one frame in the output), or the multi-frame stack
        ('points_multi_frame' (B, >= T, N, 3 + F)). In training with ground
        truth, the targets of `assign_targets` (drawn from
        `target_generator`) as 'roi_targets'."""
        hp = self.hp
        T, G, d = hp['T'], hp['G'], hp['d']
        n_proxy = hp['grid'] ** 3
        batch = self.proposal_layer(batch)
        if self.training and 'gt_boxes' in batch:
            batch['roi_targets'] = self.assign_targets(batch, target_generator)
        rois = batch['rois']                                               # (B, R, 7)
        B, R = rois.shape[:2]
        roi_mask = batch.get('roi_mask')

        mem = batch.get('mppnet_memory')
        use_mem = mem is not None and 'trajectory_rois' not in batch
        midx = None
        if 'trajectory_rois' in batch:
            traj = batch['trajectory_rois']
            tvalid = batch.get('trajectory_valid')
            if tvalid is None:
                tvalid = torch.ones(traj.shape[:3], dtype=torch.bool, device=traj.device)
            frames = batch['points_multi_frame']
        elif use_mem:
            # the bank's boxes are the proposals of the past frames; frame 0
            # of the stack is never read (the identity match)
            props = torch.cat([mem['rois'][:, :1], mem['rois']], dim=1)    # (B, T, R, 9)
            traj, tvalid, midx = self.generate_trajectory(rois, roi_mask, props, with_match=True)
            frames = batch.get('points_multi_frame')
            if frames is None:
                frames = batch['points'][:, None]
        else:
            frames = batch['points_multi_frame']
            if frames.shape[1] < T:
                raise ValueError(f'points_multi_frame holds {frames.shape[1]} frames, the head '
                                 f'needs {T}')
            rois_tv = rois if 'roi_vel' not in batch else torch.cat(
                [rois[..., :7], batch['roi_vel']], dim=-1)
            traj, tvalid = self.generate_trajectory(rois_tv, roi_mask,
                                                    batch.get('proposals_multi_frame'))
        batch['trajectory_rois'], batch['trajectory_valid'] = traj, tvalid

        diag = torch.linalg.norm(traj[..., 3:6], dim=-1)                   # (B, T, R)
        anchors0 = box_anchors(traj[:, 0])                                 # (B, R, 9, 3)

        def geometry(t):
            args = (frames[:, t], traj[:, t], diag[:, t], tvalid[:, t], roi_mask, t)
            if torch.is_grad_enabled():
                return checkpoint_call(self.sa_mlp, self.frame_geometry, *args)
            return self.frame_geometry(*args)

        if use_mem:
            # the current frame featurized, the past frames read from the
            # bank; an unmatched past frame falls back to the current one's
            # features, so its tokens stay valid
            proj0 = self.geo_proj(geometry(0))                             # (B, R, P, d)
            feats = [proj0]
            for t in range(1, T):
                cached = torch.gather(mem['feat'][:, t - 1], 1,
                                      midx[:, t].long()[..., None, None].expand(-1, -1, n_proxy, d))
                feats.append(torch.where(tvalid[:, t][..., None, None], cached, proj0))
            proxy_geo = torch.stack(feats, dim=2)                          # (B, R, T, P, d)
            proxy_msk = tvalid[:, 0][:, :, None, None].expand(B, R, T, n_proxy)
            vel = rois[..., 7:9] if rois.shape[-1] > 8 else rois.new_zeros((B, R, 2))
            valid0 = tvalid[:, 0]
            cur9 = torch.where(valid0[..., None], torch.cat([rois[..., :7], vel], -1), 0.0)
            batch['mppnet_memory'] = {
                'rois': torch.cat([cur9[:, None], mem['rois'][:, :-1]], dim=1),
                'valid': torch.cat([valid0[:, None], mem['valid'][:, :-1]], dim=1),
                'feat': torch.cat([proj0[:, None], mem['feat'][:, :-1]], dim=1),
            }
        else:
            proxy_msk = tvalid.transpose(1, 2)[..., None].expand(B, R, T, n_proxy)
            proxy_geo = self.geo_proj(torch.stack([geometry(t) for t in range(T)], dim=2))

        # motion: every frame's proxies relative to frame 0's box
        proxies_seq = torch.stack([dense_grid_points(traj[:, t], hp['grid']) for t in range(T)],
                                  dim=2)                                   # (B, R, T, P, 3)
        sph0 = spherical_offsets(proxies_seq.reshape(B, R, T * n_proxy, 3), anchors0,
                                 diag[:, 0]).reshape(B, R, T, n_proxy, 27)
        times = torch.arange(T, dtype=torch.float32, device=rois.device) * 0.1
        tcodes = times[None, None, :, None, None].expand(B, R, T, n_proxy, 1)
        pad2 = sph0.new_zeros((B, R, T, n_proxy, 2))
        src = proxy_geo + self.up_motion(torch.cat([sph0, pad2, tcodes], -1))

        # the trajectory branch: a PointNet over time in frame 0's box frame
        box_seq = torch.cat([traj[..., :7], times[None, :, None, None].expand(B, T, R, 1)], -1)
        box_seq = torch.cat([box_seq[..., 0:3] - box_seq[:, 0:1, :, 0:3], box_seq[..., 3:]], -1)
        ry0 = torch.remainder(traj[:, 0, :, 6], 2 * np.pi)                 # (B, R)
        flat_seq = box_seq.transpose(1, 2).reshape(B * R, T, 8)
        rot_xyz = box_ops.rotate_points_along_z(flat_seq[..., :3], -ry0.reshape(B * R))
        h_seq = torch.cat([rot_xyz, flat_seq[..., 3:6], flat_seq.new_zeros((B * R, T, 1)),
                           flat_seq[..., 7:]], -1)
        for i in range(3):
            h_seq = torch.relu(getattr(self, f'seqbox_{i}')(h_seq))
        box_feat = h_seq.amax(dim=1)                                       # (B * R, d)
        box_reg_aux = self.seqbox_reg(box_feat)

        # the grouped transformer
        fpg = T // G
        msk = proxy_msk.reshape(B * R * G, fpg * n_proxy)
        emb = self.point_embed(src.reshape(B * R * G, fpg * n_proxy, d))
        for li in range(hp['enc_layers']):
            emb = getattr(self, f'enc_{li}')(emb, msk)
        gtok = torch.where(msk[..., None], emb, float('-inf')).amax(dim=1)
        gtok = torch.where(torch.isfinite(gtok), gtok, 0.0).reshape(B * R, G, d)
        # a copy, not a view: a view of a parameter made without autograd
        # claims a gradient and has no graph, which module hooks (torch's
        # FlopCounterMode) cannot follow
        q = self.traj_query.repeat(B * R, 1, 1)
        q = self.cross_group(q, gtok)[:, 0]                                # (B * R, d)
        rcnn_cls = self.class_embed(self.cls_trunk(q))
        rcnn_reg = self.jointembed(torch.cat([gtok.reshape(B * R, G * d), box_feat], -1))
        batch['rcnn_cls_preds'] = rcnn_cls.reshape(B, R, 1)
        batch['rcnn_reg_preds'] = rcnn_reg.reshape(B, R, self.code_size)
        batch['rcnn_reg_aux_preds'] = box_reg_aux.reshape(B, R, self.code_size)
        return batch

    def get_loss(self, batch: dict, targets: dict) -> tuple:
        """The template's losses plus the trajectory branch's auxiliary box
        regression against the same targets (smooth L1, the mean over the
        codes, over the foreground ROIs)."""
        from ...ops import losses
        loss, tb = super().get_loss(batch, targets)
        if targets is not None and 'rcnn_reg_aux_preds' in batch:
            reg_valid = targets['reg_valid_mask'].to(batch['rcnn_reg_aux_preds'].dtype)
            aux = losses.weighted_smooth_l1(batch['rcnn_reg_aux_preds'],
                                            targets['rcnn_reg_targets'])
            aux = (aux.mean(-1) * reg_valid).sum() / reg_valid.sum().clamp(min=1.0)
            loss = loss + aux
            tb['rcnn_reg_aux_loss'] = aux
        return loss, tb
