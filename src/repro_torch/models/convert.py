"""Carry the reference's parameter, cache and optimizer-state pytrees across
(whole, or cut into a rank's shards: `shard_params`).

The JAX package's trees are nested dicts of arrays with the stacked
``layers`` leaves (leading ``n_groups`` axis); the port's are nested dicts
of tensors with the same names and shapes.  Arrays arrive as numpy (the
caller converts with ``np.asarray``); bfloat16 arrays go through float32,
which is exact.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import device as _device

_TYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16,
          "int32": torch.int32, "int64": torch.int64}


def _tree(tree, dtype: Optional[torch.dtype], dev: torch.device):
    if isinstance(tree, dict):
        return {k: _tree(v, dtype, dev) for k, v in tree.items()}
    arr = np.asarray(tree)
    name = str(arr.dtype)
    if name not in _TYPES:
        raise TypeError(f"cannot carry an array of type {name} across")
    want = dtype if dtype is not None else _TYPES[name]
    if name == "bfloat16":
        arr = arr.astype(np.float32)
    return torch.tensor(arr, device=dev).to(want)


def params_from_numpy(tree, *, dtype: Optional[torch.dtype] = None, device=None) -> dict:
    """The port's parameters from the reference's tree of arrays: every
    leaf cast to `dtype`, or kept in its own type when `dtype` is None (a
    bfloat16 model's MoE routers stay float32, as the reference keeps
    them)."""
    return _tree(tree, dtype, _device.resolve(device))


def cache_from_numpy(tree, *, dtype: Optional[torch.dtype] = None, device=None) -> dict:
    """The port's decode cache from the reference's cache tree, leaf by
    leaf (same rule for types as `params_from_numpy`)."""
    return _tree(tree, dtype, _device.resolve(device))



def opt_state_from_numpy(tree, *, dtype: Optional[torch.dtype] = None, device=None) -> dict:
    """The port's optimizer state from the reference's (`adamw_init`'s
    ``{"m", "v", "step"}`` or `sgdm_init`'s ``{"mom", "step"}``): the
    moments leaf by leaf as `params_from_numpy` carries parameters, the step
    an int32 scalar."""
    dev = _device.resolve(device)
    return {k: _tree(v, torch.int32 if k == "step" else dtype, dev) for k, v in tree.items()}


def shard_params(tree, cfg, rules, *, dtype: Optional[torch.dtype] = None,
                 device=None) -> dict:
    """This rank's shards of a full parameter tree (the reference's, as
    numpy): each leaf cut by `repro_torch.sharding.rules.param_specs` under
    `rules`, then carried across as `params_from_numpy` carries it."""
    from ..sharding.rules import axes_of, param_specs

    specs = param_specs(tree, cfg, rules)
    mesh = rules.mesh

    def cut(node, spec):
        if isinstance(node, dict):
            return {k: cut(v, spec[k]) for k, v in node.items()}
        arr = np.asarray(node)
        for d, entry in enumerate(spec):
            axes = axes_of(entry)
            if axes:
                n = arr.shape[d] // mesh.size(axes)
                i = mesh.index(axes)
                arr = arr[(slice(None),) * d + (slice(i * n, (i + 1) * n),)]
        return np.ascontiguousarray(arr)

    return params_from_numpy(cut(tree, specs), dtype=dtype, device=device)
