"""flax <-> torch weights.

The port's module and parameter names mirror the JAX package's flax tree
(`backbone_3d.sa_0.agg.pre_feat_0`, `dense_head.head.hm_out`, ...), so one
generic rule set maps every leaf. The layout rules are those of
`pdm_ssd_tpu/utils/torch_import.py`, inverted:

- Dense kernel (in, out)             -> Linear weight (out, in)
- Conv kernel (kh, kw, in, out)      -> Conv2d weight (out, in, kh, kw)
- Conv kernel (kd, kh, kw, in, out)  -> Conv3d weight (out, in, kd, kh, kw)
- ConvTranspose kernel (kh, kw, in, out) -> ConvTranspose2d weight
  (in, out, kh, kw), spatially flipped
- ConvTranspose kernel (kd, kh, kw, in, out) -> ConvTranspose3d weight
  (in, out, kd, kh, kw), spatially flipped
- sparse conv kernel (taps * in, out)   -> the same `kernel`
- BatchNorm scale / bias / mean / var -> weight / bias / running_mean /
  running_var
- LayerNorm scale / bias             -> weight / bias
- Embed embedding (num, d)           -> Embedding weight (num, d)
- a parameter a module creates itself (`self.param`, MPPNet's
  `traj_query`)                      -> the module's parameter of that name
  (listed in its `flax_params`), the same array
- DenseGeneral kernel of several axes (an attention's `query`, `key`,
  `value`: (in, heads, head_dim); its `out`: (heads, head_dim, out)) and
  its bias ((heads, head_dim) or (out,)) -> a `HeadsLinear`'s weight
  (out, in) and bias (out,), flattened

`to_flax` applies the same rules the other way, for a model's tensors or for
any tensors keyed like its state dict (gradients, for one).

Epsilon and momentum are properties of the torch modules, which the port
builds with the JAX package's values.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

_BN_PARAM = {'scale': 'weight', 'bias': 'bias'}
_BN_STAT = {'mean': 'running_mean', 'var': 'running_var'}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _convert_param(mod: nn.Module, leaf: str, arr: np.ndarray):
    if leaf in getattr(mod, 'flax_params', ()):
        return leaf, arr                    # a parameter the module holds itself
    if isinstance(mod, (nn.modules.batchnorm._BatchNorm, nn.LayerNorm)) and leaf in _BN_PARAM:
        return _BN_PARAM[leaf], arr
    if isinstance(mod, nn.Embedding) and leaf == 'embedding':
        return 'weight', arr
    if leaf == 'bias' and isinstance(mod, nn.Linear):
        return 'bias', arr.reshape(-1)      # a HeadsLinear's (heads, head_dim) flattened
    if leaf == 'bias' and isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d,
                                           nn.ConvTranspose3d)):
        return 'bias', arr
    if leaf == 'kernel':
        if isinstance(getattr(mod, 'kernel', None), nn.Parameter):
            return 'kernel', arr            # a sparse conv keeps flax's (taps * in, out)
        if isinstance(mod, nn.Linear):
            return 'weight', arr.reshape(mod.in_features, mod.out_features).T
        if isinstance(mod, nn.ConvTranspose2d):
            return 'weight', arr[::-1, ::-1].transpose(2, 3, 0, 1)
        if isinstance(mod, nn.ConvTranspose3d):
            return 'weight', arr[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)
        if isinstance(mod, nn.Conv2d):
            return 'weight', arr.transpose(3, 2, 0, 1)
        if isinstance(mod, nn.Conv3d):
            return 'weight', arr.transpose(4, 3, 0, 1, 2)
    raise KeyError(f'no rule for leaf {leaf!r} of {type(mod).__name__}')


def from_flax(variables: Mapping, model: nn.Module) -> dict:
    """Map the JAX package's `{'params', 'batch_stats'}` (numpy or jax
    arrays) onto `model`'s state dict. Raises on a source leaf without a
    target, a shape mismatch, or a target tensor no leaf reached
    (`num_batches_tracked` counters keep the model's values)."""
    modules = dict(model.named_modules())
    target = model.state_dict()
    out = {}

    def put(path, name, arr):
        key = '.'.join(path[:-1] + (name,))
        if key not in target:
            raise KeyError(f'flax leaf {"/".join(path)} has no target {key}')
        if tuple(target[key].shape) != arr.shape:
            raise ValueError(f'{key}: target {tuple(target[key].shape)} vs source {arr.shape}')
        out[key] = torch.from_numpy(np.array(arr, order="C", copy=True)).to(target[key].dtype)

    for path, arr in _flatten(variables['params']):
        mod = modules.get('.'.join(path[:-1]))
        if mod is None:
            raise KeyError(f'flax leaf {"/".join(path)} has no target module')
        put(path, *_convert_param(mod, path[-1], arr))
    for path, arr in _flatten(variables.get('batch_stats', {})):
        if path[-1] not in _BN_STAT:
            raise KeyError(f'unknown batch stat {"/".join(path)}')
        put(path, _BN_STAT[path[-1]], arr)

    missing = [k for k in target if k not in out and not k.endswith('num_batches_tracked')]
    if missing:
        raise KeyError(f'target tensors not reached by any flax leaf: {missing}')
    for k in target:
        if k not in out:
            out[k] = target[k].clone()
    return out


def _to_flax_leaf(mod: nn.Module, name: str, arr: np.ndarray):
    if name in getattr(mod, 'flax_params', ()):
        return name, arr
    if isinstance(mod, (nn.modules.batchnorm._BatchNorm, nn.LayerNorm)):
        inv = {v: k for k, v in {**_BN_PARAM, **_BN_STAT}.items()}
        if name in inv:
            return inv[name], arr
    elif isinstance(mod, nn.Embedding) and name == 'weight':
        return 'embedding', arr
    elif name == 'bias' and hasattr(mod, 'flax_bias'):
        return 'bias', arr.reshape(mod.flax_bias)
    elif name in ('bias', 'kernel'):
        return name, arr
    elif name == 'weight':
        if hasattr(mod, 'flax_kernel'):
            return 'kernel', arr.T.reshape(mod.flax_kernel)
        if isinstance(mod, nn.Linear):
            return 'kernel', arr.T
        if isinstance(mod, nn.ConvTranspose2d):
            return 'kernel', arr.transpose(2, 3, 0, 1)[::-1, ::-1]
        if isinstance(mod, nn.ConvTranspose3d):
            return 'kernel', arr.transpose(2, 3, 4, 0, 1)[::-1, ::-1, ::-1]
        if isinstance(mod, nn.Conv2d):
            return 'kernel', arr.transpose(2, 3, 1, 0)
        if isinstance(mod, nn.Conv3d):
            return 'kernel', arr.transpose(2, 3, 4, 1, 0)
    raise KeyError(f'no rule for tensor {name!r} of {type(mod).__name__}')


def to_flax(model: nn.Module, tensors: Mapping | None = None) -> dict:
    """The inverse of `from_flax`: `{'params', 'batch_stats'}` as nested dicts
    of numpy arrays in the JAX package's layout. `tensors` maps state-dict
    keys to the tensors to convert (default: the model's own state dict);
    pass `{name: p.grad}` for a gradient tree. `num_batches_tracked`
    counters have no flax leaf and are skipped."""
    modules = dict(model.named_modules())
    if tensors is None:
        tensors = model.state_dict()
    out = {'params': {}, 'batch_stats': {}}
    for key, t in tensors.items():
        path, _, name = key.rpartition('.')
        if name == 'num_batches_tracked':
            continue
        leaf, arr = _to_flax_leaf(modules[path], name, t.detach().cpu().numpy())
        node = out['batch_stats' if leaf in _BN_STAT else 'params']
        for part in filter(None, path.split('.')):     # '' for the model's own tensors
            node = node.setdefault(part, {})
        node[leaf] = np.array(arr, order='C', copy=True)
    return out
