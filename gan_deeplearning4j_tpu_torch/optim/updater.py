"""Graph-level updater: L2 -> elementwise clip -> per-layer RmsProp (torch
twin of ``gan_deeplearning4j_tpu/optim/updater.py``).

L2 weight decay goes onto the gradient of ``W`` leaves only, then every
element is clipped to the threshold, then the layer's RmsProp rule runs.
Layers with no updater are frozen: RmsProp at lr 0, which still passes
their leaves through the chain (the cache moves, the param stays).  The
chains of all the leaves with a gradient are one call of
``ops.cuda.fused_rmsprop_chains``: one kernel launch per graph update on
the card, the plain torch chain leaf by leaf on the CPU.
"""

from __future__ import annotations

from typing import Dict, Optional

from gan_deeplearning4j_tpu_torch.ops.cuda.fused_update import (
    Rates,
    fused_rmsprop_chains,
)
from gan_deeplearning4j_tpu_torch.optim.rmsprop import RmsProp

# DL4J regularizes "weight" params only (not biases, not BN gamma/beta)
_L2_PARAM_NAMES = frozenset({"W"})

_FROZEN = RmsProp(0.0, 1e-8, 1e-8)


class GraphUpdater:
    """Per-layer RmsProp over a {layer: {param: tensor}} tree."""

    def __init__(self, layer_updaters: Dict[str, RmsProp], l2: float = 0.0,
                 clip_threshold: Optional[float] = 1.0):
        self.layer_updaters = dict(layer_updaters)
        self.l2 = float(l2)
        self.clip_threshold = clip_threshold

    def updater_for(self, layer: str) -> RmsProp:
        return self.layer_updaters.get(layer) or _FROZEN

    def rates(self, layer: str, pname: str) -> Rates:
        up = self.updater_for(layer)
        return Rates(up.learning_rate, up.rms_decay, up.epsilon,
                     self.l2 if pname in _L2_PARAM_NAMES else 0.0)

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
        ps, cs = fused_rmsprop_chains(
            [params[layer][pname] for layer, pname in keys],
            [grads[layer][pname] for layer, pname in keys],
            [cache[layer][pname] for layer, pname in keys],
            [self.rates(layer, pname) for layer, pname in keys],
            clip=self.clip_threshold)
        for (layer, pname), p, c in zip(keys, ps, cs):
            new_params[layer][pname] = p
            new_cache[layer][pname] = c
        return new_params, new_cache
