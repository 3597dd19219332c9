"""MPPNet: multi-frame two-stage refinement over proposal trajectories
(counterpart of `pdm_ssd_tpu/models/detectors/mppnet.py`).

PV-RCNN's first stage (MeanVFE, the voxel ladder, the BEV backbone, the
anchor head) proposes; `MPPNetHead` refines the proposals against the
ego-aligned multi-frame point stack, or, streamed, against the current
frame and a memory bank of the past ones (`predict_with_state`). No
keypoints and no point head.
"""
from __future__ import annotations

import torch

from ..roi_heads.mppnet_head import MPPNetHead, init_mppnet_memory
from .pv_rcnn import PVRCNN


class MPPNet(PVRCNN):
    def _build_second_stage(self, cfg, ds, device) -> None:
        """No keypoints and no point head; `roi_head` is MPPNet's."""
        self.pfe = None
        self.point_head = None
        self.roi_head = MPPNetHead(cfg.ROI_HEAD, self.num_class, device=device)

    def forward(self, batch: dict, target_generator: torch.Generator | None = None) -> dict:
        """Without 'points_multi_frame' (a single frame), the current frame
        stands for every one of the head's NUM_FRAMES frames."""
        batch = dict(batch)
        if 'points_multi_frame' not in batch:
            T = int(self.model_cfg.ROI_HEAD.get('NUM_FRAMES', 4))
            batch['points_multi_frame'] = batch['points'][:, None].repeat_interleave(T, dim=1)
        return self.roi_head(self.first_stage(batch), target_generator)

    def init_memory(self, batch_size: int, num_rois: int) -> dict:
        """The empty memory bank of a stream's first step, on the model's
        device (`num_rois`: the head's NMS_POST_MAXSIZE, or MAX_PRED_BOXES
        with offline proposals)."""
        return init_mppnet_memory(self.model_cfg.ROI_HEAD, batch_size, num_rois,
                                  device=self.roi_head.traj_query.device)

    @torch.inference_mode()
    def predict_with_state(self, batch: dict) -> tuple:
        """The streaming predict: reads the bank at 'mppnet_memory' (from
        `init_memory` at a stream's first frame) and returns (detections,
        the bank rolled by one frame), to be handed to the next frame's
        call. The model must be in eval mode."""
        if self.training:
            raise RuntimeError('predict_with_state needs eval mode (call model.eval())')
        out = self(batch)
        return self.post_process(out), out.get('mppnet_memory')
