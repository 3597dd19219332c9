"""Per-point feature selection as a precomputed column gather (copy of
`pdm_ssd_tpu/datasets/processor/point_feature_encoder.py`): keep xyz, append
the configured subset of source channels."""
from __future__ import annotations

import numpy as np


class PointFeatureEncoder:
    def __init__(self, config, point_cloud_range=None):
        self.cfg = config
        self.point_cloud_range = point_cloud_range
        src = list(config.src_feature_list)
        used = list(config.used_feature_list)
        if src[:3] != ['x', 'y', 'z']:
            raise ValueError(f'source features must lead with xyz, got {src[:3]}')
        if config.encoding_type != 'absolute_coordinates_encoding':
            raise NotImplementedError(config.encoding_type)
        # xyz always leads the output; remaining used channels follow in
        # used-list order, gathered from their source columns
        self._columns = np.array(
            [0, 1, 2] + [src.index(name) for name in used
                         if name not in ('x', 'y', 'z')], np.int64)

    @property
    def num_point_features(self) -> int:
        return len(self._columns)

    def forward(self, data_dict: dict) -> dict:
        data_dict['points'] = data_dict['points'][:, self._columns]
        data_dict['use_lead_xyz'] = True
        return data_dict
