"""Graph-level updater: L2 -> elementwise clip -> per-layer RmsProp (torch
twin of ``gan_deeplearning4j_tpu/optim/updater.py``).

L2 weight decay goes onto the gradient of ``W`` leaves only, then every
element is clipped to the threshold, then the layer's RmsProp rule runs.
Layers with no updater are frozen: RmsProp at lr 0, which still passes
their leaves through the chain (the cache moves, the param stays).  Each
leaf's whole chain is one call of ``ops.cuda.fused_rmsprop_chain``: one
kernel launch on the card, the plain torch chain on the CPU.
"""

from __future__ import annotations

from typing import Dict, Optional

from gan_deeplearning4j_tpu_torch.ops.cuda.fused_update import (
    fused_rmsprop_chain,
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
        for layer, layer_grads in grads.items():
            up = self.updater_for(layer)
            for pname, g in layer_grads.items():
                l2 = self.l2 if pname in _L2_PARAM_NAMES else 0.0
                new_params[layer][pname], new_cache[layer][pname] = (
                    fused_rmsprop_chain(
                        params[layer][pname], g, cache[layer][pname],
                        lr=up.learning_rate, rho=up.rms_decay,
                        eps=up.epsilon, l2=l2, clip=self.clip_threshold))
        return new_params, new_cache
