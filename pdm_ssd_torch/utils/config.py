"""YAML config system with `_BASE_CONFIG_` inheritance and dotted overrides.

The same loader as the JAX package's `utils/config.py`, kept here so that the
port imports nothing of that package: recursive base-config merge, dotted
`cfg_from_list` overrides with `literal_eval` type checks, and `CfgNode`, a
dict with attribute access.
"""
from __future__ import annotations

import ast
import collections.abc
import copy
from pathlib import Path

import yaml


class CfgNode(dict):
    """dict with attribute access; recursively wraps nested mappings."""

    def __init__(self, d=None):
        super().__init__()
        if d:
            for k, v in d.items():
                self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, v):
        if isinstance(v, CfgNode):
            return v
        if isinstance(v, collections.abc.Mapping):
            return cls(v)
        if isinstance(v, (list, tuple)):
            return list(cls._wrap(x) for x in v)
        return v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = self._wrap(v)

    def __setitem__(self, k, v):
        super().__setitem__(k, self._wrap(v))

    def __deepcopy__(self, memo):
        return CfgNode({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def get(self, k, default=None):
        return self[k] if k in self else default

    def to_dict(self):
        def unwrap(v):
            if isinstance(v, CfgNode):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(unwrap(x) for x in v)
            return v
        return unwrap(self)


def merge_new_config(config: CfgNode, new_config: dict) -> CfgNode:
    """Recursively merge `new_config` into `config`, honoring `_BASE_CONFIG_`
    includes (a path relative to the working directory)."""
    if '_BASE_CONFIG_' in new_config:
        with open(new_config['_BASE_CONFIG_'], 'r') as f:
            base = yaml.safe_load(f)
        merge_new_config(config, base)

    for key, val in new_config.items():
        if key == '_BASE_CONFIG_':
            continue
        if isinstance(val, dict):
            if not isinstance(config.get(key), CfgNode):
                config[key] = CfgNode()
            merge_new_config(config[key], val)
        else:
            config[key] = copy.deepcopy(val)
    return config


def cfg_from_yaml_file(cfg_file, config: CfgNode | None = None) -> CfgNode:
    config = CfgNode() if config is None else config
    with open(cfg_file, 'r') as f:
        new_config = yaml.safe_load(f)
    merge_new_config(config, new_config)
    config['TAG'] = Path(cfg_file).stem
    # e.g. configs/kitti_models/pdm_ssd.yaml -> 'kitti_models'
    parts = Path(cfg_file).resolve().parts
    config['EXP_GROUP_PATH'] = parts[-2] if len(parts) >= 2 else ''
    return config


def cfg_from_list(cfg_list, config: CfgNode) -> CfgNode:
    """Set config keys from a dotted-path list, e.g. ['MODEL.NAME', 'PDMSSD'];
    values go through `literal_eval` and must keep the key's type."""
    assert len(cfg_list) % 2 == 0, cfg_list
    for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key_list = k.split('.')
        d = config
        for subkey in key_list[:-1]:
            assert subkey in d, f'NotFoundKey: {subkey}'
            d = d[subkey]
        subkey = key_list[-1]
        assert subkey in d, f'NotFoundKey: {subkey}'
        try:
            value = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            value = v
        if isinstance(value, dict):
            for key1, val1 in value.items():
                d[subkey][key1] = val1
        else:
            if value is not None and d[subkey] is not None:
                assert type(value) == type(d[subkey]), \
                    f'type {type(value)} does not match original type {type(d[subkey])}'
            d[subkey] = value
    return config


def as_cfg(obj) -> CfgNode:
    """Wrap any mapping (a plain dict, or the JAX package's config node) into
    a CfgNode for attribute access."""
    if isinstance(obj, CfgNode):
        return obj
    return CfgNode({k: obj[k] for k in obj.keys()})
