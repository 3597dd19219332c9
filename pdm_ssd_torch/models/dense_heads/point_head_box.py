"""Point-wise box head, the vote branch of the hybrid head (counterpart of
`pdm_ssd_tpu/models/dense_heads/point_head_box.py`): forward and box decode.
Target assignment and losses are training work, not ported yet."""
from __future__ import annotations

import torch
from torch import nn

from ...ops.coders import build_box_coder
from ...utils.config import as_cfg
from ..layers import FCStack


class PointHeadBox(nn.Module):
    def __init__(self, model_cfg, input_channels: int, num_class: int, device=None):
        super().__init__()
        cfg = as_cfg(model_cfg)
        tc = cfg.TARGET_CONFIG
        self.box_coder = build_box_coder(tc.BOX_CODER, **tc.get('BOX_CODER_CONFIG', {}).to_dict())
        self.cls_layers = FCStack(input_channels, tuple(cfg.CLS_FC), num_class, device=device)
        self.box_layers = FCStack(input_channels, tuple(cfg.REG_FC), self.box_coder.code_size,
                                  device=device)

    def forward(self, batch: dict) -> dict:
        feats = batch['point_features']                 # (B, N, C)
        cls_preds = self.cls_layers(feats)
        batch['point_cls_preds'] = cls_preds
        batch['point_box_preds'] = self.box_layers(feats)
        batch['point_cls_scores'] = torch.sigmoid(cls_preds.amax(dim=-1))
        return batch

    def generate_predicted_boxes(self, points, cls_preds, box_preds):
        """Decode per-point boxes with the argmax class's mean size."""
        pred_classes = torch.argmax(cls_preds, dim=-1)
        return cls_preds, self.box_coder.decode(box_preds, points, pred_classes + 1)
