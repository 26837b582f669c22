"""Carry params and updater state between the JAX package and the port.

Both packages keep the same tree ``{layer: {param: array}}`` with the same
names and layouts (dense W [n_in, n_out], conv W OIHW), so a carry is a
dtype/device move with shape checks.  The port only sees numpy: a caller
holding JAX arrays passes ``jax.tree.map(np.asarray, graph.params)``.  The
generator EMA (``ProtocolState.ema_gen``) is a params tree of the
generator's layout and crosses with ``params_from_numpy`` /
``params_to_numpy`` like any other.
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


def opt_state_from_numpy(tree: Mapping, device,
                         like: Optional[TorchTree] = None) -> TorchTree:
    """The RmsProp caches: the same tree shape as the params."""
    return params_from_numpy(tree, device, like)


def opt_state_to_numpy(opt_state: TorchTree) -> NumpyTree:
    return params_to_numpy(opt_state)
