"""Carry params and updater state between the JAX package and the port.

Both packages keep the same tree ``{layer: {param: array}}`` with the same
names and layouts (dense W [n_in, n_out], conv W OIHW), so a carry is a
dtype/device move with shape checks.  The port only sees numpy: a caller
holding JAX arrays passes ``jax.tree.map(np.asarray, graph.params)``.  The
generator EMA (``ProtocolState.ema_gen``) is a params tree of the
generator's layout and crosses with ``params_from_numpy`` /
``params_to_numpy`` like any other.  Updater state is a tree of any depth
(RmsProp: the cache per param; Adam: ``{m, v, t}``; ``Scheduled``:
``{t, inner}``) and keeps the JAX dtypes: float leaves f32, the
``Scheduled`` counter int32.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

NumpyTree = Dict[str, Dict[str, np.ndarray]]
TorchTree = Dict[str, Dict[str, torch.Tensor]]


def params_from_numpy(tree: Mapping, device, like: Optional[TorchTree] = None
                      ) -> TorchTree:
    """f32 tensors on ``device``.  With ``like`` (e.g. a graph's params),
    the layer names, param names and shapes must match it exactly."""
    if like is not None:
        if set(tree) != set(like):
            raise ValueError(f"layer names differ: {sorted(set(tree) ^ set(like))}")
        for layer, lp in tree.items():
            if set(lp) != set(like[layer]):
                raise ValueError(f"{layer}: param names {sorted(lp)} != "
                                 f"{sorted(like[layer])}")
            for n, a in lp.items():
                if tuple(np.shape(a)) != tuple(like[layer][n].shape):
                    raise ValueError(f"{layer}.{n}: shape {np.shape(a)} != "
                                     f"{tuple(like[layer][n].shape)}")
    return {layer: {n: torch.tensor(np.asarray(a, dtype=np.float32), device=device)
                    for n, a in lp.items()}
            for layer, lp in tree.items()}


def params_to_numpy(params: TorchTree) -> NumpyTree:
    return {layer: {n: t.detach().cpu().numpy() for n, t in lp.items()}
            for layer, lp in params.items()}


def _leaf_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    dtype = np.int32 if np.issubdtype(a.dtype, np.integer) else np.float32
    return torch.tensor(a.astype(dtype, copy=False), device=device)


def _check_like(tree: Mapping, like: Mapping, path: str) -> None:
    if set(tree) != set(like):
        raise ValueError(f"{path or 'tree'}: keys differ: "
                         f"{sorted(set(tree) ^ set(like))}")
    for k, v in tree.items():
        where = f"{path}.{k}" if path else k
        if isinstance(v, Mapping):
            if not isinstance(like[k], Mapping):
                raise ValueError(f"{where}: a tree where a leaf is expected")
            _check_like(v, like[k], where)
        elif tuple(np.shape(v)) != tuple(like[k].shape):
            raise ValueError(f"{where}: shape {np.shape(v)} != "
                             f"{tuple(like[k].shape)}")


def opt_state_from_numpy(tree: Mapping, device, like: Optional[Dict] = None
                         ) -> Dict:
    """Updater state onto ``device``: float leaves as f32, integer leaves
    (the ``Scheduled`` counter) as int32.  With ``like`` (e.g. a graph's
    ``opt_state``) the tree's keys and leaf shapes must match it."""
    if like is not None:
        _check_like(tree, like, "")

    def conv(t):
        return {k: conv(v) if isinstance(v, Mapping)
                else _leaf_from_numpy(v, device) for k, v in t.items()}

    return conv(tree)


def opt_state_to_numpy(opt_state: Dict) -> Dict:
    """Updater state as host arrays of the same dtypes, any depth."""
    return {k: opt_state_to_numpy(v) if isinstance(v, dict)
            else v.detach().cpu().numpy() for k, v in opt_state.items()}
