"""Box coders (counterpart of `pdm_ssd_tpu/ops/coders.py`): `ResidualCoder`
(anchor-relative) and `PointResidualCoder` with or without class mean sizes,
encode and decode."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ResidualCoder:
    """Residuals against an anchor box: offsets over the anchor's BEV
    diagonal and height, log size ratios, and the heading's difference (or,
    with `encode_angle_by_sincos`, the differences of its cosine and sine)."""
    code_size: int = 7
    encode_angle_by_sincos: bool = False

    @property
    def full_code_size(self) -> int:
        return self.code_size + (1 if self.encode_angle_by_sincos else 0)

    def encode(self, boxes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
        """boxes and anchors (..., 7 + E) -> (..., full_code_size + E)."""
        xa, ya, za = torch.unbind(anchors[..., :3], dim=-1)
        dxa, dya, dza = torch.unbind(anchors[..., 3:6].clamp(min=1e-5), dim=-1)
        xg, yg, zg = torch.unbind(boxes[..., :3], dim=-1)
        dxg, dyg, dzg = torch.unbind(boxes[..., 3:6].clamp(min=1e-5), dim=-1)
        ra, rg = anchors[..., 6], boxes[..., 6]
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        if self.encode_angle_by_sincos:
            rts = [torch.cos(rg) - torch.cos(ra), torch.sin(rg) - torch.sin(ra)]
        else:
            rts = [rg - ra]
        extras = [boxes[..., 7 + i] - anchors[..., 7 + i] for i in range(boxes.shape[-1] - 7)]
        return torch.stack([(xg - xa) / diagonal, (yg - ya) / diagonal, (zg - za) / dza,
                            torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza),
                            *rts, *extras], dim=-1)

    def decode(self, box_encodings: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
        xa, ya, za, dxa, dya, dza, ra = torch.unbind(anchors[..., :7], dim=-1)
        n_used = 8 if self.encode_angle_by_sincos else 7
        xt, yt, zt, dxt, dyt, dzt, *rt = torch.unbind(box_encodings[..., :n_used], dim=-1)
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        if self.encode_angle_by_sincos:
            rg = torch.atan2(rt[1] + torch.sin(ra), rt[0] + torch.cos(ra))
        else:
            rg = rt[0] + ra
        extras = [box_encodings[..., n_used + i] + anchors[..., 7 + i]
                  for i in range(anchors.shape[-1] - 7)]
        return torch.stack([xt * diagonal + xa, yt * diagonal + ya, zt * dza + za,
                            torch.exp(dxt) * dxa, torch.exp(dyt) * dya, torch.exp(dzt) * dza,
                            rg, *extras], dim=-1)


@dataclasses.dataclass(frozen=True)
class PointResidualCoder:
    """Per-point residual coder; the heading is encoded as cos/sin. With
    `use_mean_size` the offsets are scaled by the class's mean size
    (1-indexed by class id) and the sizes coded as log ratios to it; without,
    the offsets are plain differences and the sizes plain logs."""
    code_size: int = 8
    use_mean_size: bool = True
    mean_size: tuple = ()

    def _anchor_sizes(self, classes: torch.Tensor) -> torch.Tensor:
        ms = torch.tensor(self.mean_size, dtype=torch.float32, device=classes.device)
        return ms[torch.clamp(classes.long() - 1, 0, ms.shape[0] - 1)]

    def encode(self, gt_boxes: torch.Tensor, points: torch.Tensor,
               gt_classes: torch.Tensor | None = None) -> torch.Tensor:
        """gt_boxes (..., 7 + E), points (..., 3), gt_classes (...) 1-indexed
        (read with `use_mean_size` only) -> (..., 8 + E): the centre offsets,
        the size codes, cos and sin of the heading, then the extras."""
        sizes = gt_boxes[..., 3:6].clamp(min=1e-5)
        xg, yg, zg = torch.unbind(gt_boxes[..., :3], dim=-1)
        dxg, dyg, dzg = torch.unbind(sizes, dim=-1)
        rg = gt_boxes[..., 6]
        xa, ya, za = torch.unbind(points[..., :3], dim=-1)
        if self.use_mean_size:
            dxa, dya, dza = torch.unbind(self._anchor_sizes(gt_classes), dim=-1)
            diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
            codes = [(xg - xa) / diagonal, (yg - ya) / diagonal, (zg - za) / dza,
                     torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza)]
        else:
            codes = [xg - xa, yg - ya, zg - za, torch.log(dxg), torch.log(dyg), torch.log(dzg)]
        extras = [gt_boxes[..., 7 + i] for i in range(gt_boxes.shape[-1] - 7)]
        return torch.stack([*codes, torch.cos(rg), torch.sin(rg), *extras], dim=-1)

    def decode(self, box_encodings: torch.Tensor, points: torch.Tensor,
               pred_classes: torch.Tensor | None = None) -> torch.Tensor:
        xt, yt, zt, dxt, dyt, dzt, cost, sint = torch.unbind(box_encodings[..., :8], dim=-1)
        xa, ya, za = torch.unbind(points[..., :3], dim=-1)
        if self.use_mean_size:
            dxa, dya, dza = torch.unbind(self._anchor_sizes(pred_classes), dim=-1)
            diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
            centre = [xt * diagonal + xa, yt * diagonal + ya, zt * dza + za]
            size = [torch.exp(dxt) * dxa, torch.exp(dyt) * dya, torch.exp(dzt) * dza]
        else:
            centre = [xt + xa, yt + ya, zt + za]
            size = [torch.exp(dxt), torch.exp(dyt), torch.exp(dzt)]
        rg = torch.atan2(sint, cost)
        extras = [box_encodings[..., 8 + i] for i in range(box_encodings.shape[-1] - 8)]
        return torch.stack([*centre, *size, rg, *extras], dim=-1)


def build_box_coder(name: str, **kwargs):
    registry = {'ResidualCoder': ResidualCoder, 'PointResidualCoder': PointResidualCoder}
    if name not in registry:
        raise NotImplementedError(f'box coder {name} is not ported')
    if name == 'PointResidualCoder' and 'mean_size' in kwargs:
        kwargs['mean_size'] = tuple(tuple(s) for s in kwargs['mean_size'])
    fields = {f.name for f in dataclasses.fields(registry[name])}
    return registry[name](**{k: v for k, v in kwargs.items() if k in fields})
