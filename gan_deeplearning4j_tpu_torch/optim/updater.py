"""Graph-level updater: L2 -> elementwise clip -> the layer's rule (torch
twin of ``gan_deeplearning4j_tpu/optim/updater.py``).

L2 weight decay goes onto the gradient of ``W`` leaves only, then every
element is clipped to the threshold, then the layer's updater runs.
Layers with no updater are frozen: RmsProp at lr 0, which still passes
their leaves through the chain (the cache moves, the param stays).  The
RmsProp leaves of one update are one call of
``ops.cuda.fused_rmsprop_chains``: one kernel launch per graph update on
the card, the plain torch chain leaf by leaf on the CPU.  Every other
updater (``Adam``, ``Scheduled``) runs its own ``update_leaf`` in plain
torch ops, as the JAX package runs it outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from gan_deeplearning4j_tpu_torch.ops.cuda.fused_update import (
    Rates,
    fused_rmsprop_chains,
)
from gan_deeplearning4j_tpu_torch.optim.rmsprop import RmsProp

# DL4J regularizes "weight" params only (not biases, not BN gamma/beta)
_L2_PARAM_NAMES = frozenset({"W"})

_FROZEN = RmsProp(0.0, 1e-8, 1e-8)


class GraphUpdater:
    """Per-layer updaters over a {layer: {param: tensor}} tree; kinds may
    mix across the layers of one graph."""

    def __init__(self, layer_updaters: Dict[str, object], l2: float = 0.0,
                 clip_threshold: Optional[float] = 1.0):
        self.layer_updaters = dict(layer_updaters)
        self.l2 = float(l2)
        self.clip_threshold = clip_threshold

    def updater_for(self, layer: str):
        return self.layer_updaters.get(layer) or _FROZEN

    def _l2(self, pname: str) -> float:
        return self.l2 if pname in _L2_PARAM_NAMES else 0.0

    def rates(self, layer: str, pname: str) -> Rates:
        """An RmsProp leaf's rates for the fused chain."""
        up = self.updater_for(layer)
        return Rates(up.learning_rate, up.rms_decay, up.epsilon,
                     self._l2(pname))

    def init(self, params):
        return {
            layer: {pname: self.updater_for(layer).init_leaf(p)
                    for pname, p in layer_params.items()}
            for layer, layer_params in params.items()
        }

    def apply(self, params, grads, cache):
        """Returns (new_params, new_cache), out of place.  Params without a
        gradient entry pass through unchanged."""
        new_params = {layer: dict(lp) for layer, lp in params.items()}
        new_cache = {layer: dict(cache.get(layer, {})) for layer in params}
        keys = [(layer, pname) for layer, lg in grads.items() for pname in lg]
        rms = [k for k in keys if isinstance(self.updater_for(k[0]), RmsProp)]
        if rms:
            ps, cs = fused_rmsprop_chains(
                [params[layer][pname] for layer, pname in rms],
                [grads[layer][pname] for layer, pname in rms],
                [cache[layer][pname] for layer, pname in rms],
                [self.rates(layer, pname) for layer, pname in rms],
                clip=self.clip_threshold)
            for (layer, pname), p, c in zip(rms, ps, cs):
                new_params[layer][pname] = p
                new_cache[layer][pname] = c
        for layer, pname in keys:
            up = self.updater_for(layer)
            if isinstance(up, RmsProp):
                continue
            p, g, l2 = params[layer][pname], grads[layer][pname], self._l2(pname)
            if l2 > 0.0:
                g = g + l2 * p
            if self.clip_threshold is not None:
                g = torch.clamp(g, -self.clip_threshold, self.clip_threshold)
            update, new_cache[layer][pname] = up.update_leaf(
                g, cache[layer][pname])
            new_params[layer][pname] = p - update
        return new_params, new_cache
