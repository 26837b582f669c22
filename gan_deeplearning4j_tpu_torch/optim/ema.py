"""Generator weight EMA (torch twin of ``gan_deeplearning4j_tpu/optim/
ema.py``): the trajectory-averaged generator the protocol step can carry
beside the live one."""

from __future__ import annotations

from typing import Dict

import torch

Tree = Dict[str, Dict[str, torch.Tensor]]


def ema_init(gen) -> Tree:
    """Seed an EMA tree from a generator graph: from its carried
    ``ema_params`` when it has one, else from its live params.  Fresh
    buffers, never aliases of the live params: the step's updates are out
    of place, but a CUDA graph copies each new leaf back into its static
    buffer, and two leaves on one buffer would take each other's values."""
    src = getattr(gen, "ema_params", None) or gen.params
    return {layer: {n: t.detach().clone() for n, t in lp.items()}
            for layer, lp in src.items()}


def ema_update(ema: Tree, params: Tree, decay: float) -> Tree:
    """One EMA step, out of place: ema <- decay*ema + (1-decay)*params,
    rounded as written (two products, then their sum).  Each of the three
    passes is one multi-tensor call over all leaves."""
    keys = [(layer, n) for layer, lp in ema.items() for n in lp]
    scaled = torch._foreach_mul([ema[l][n] for l, n in keys], decay)
    mixed = torch._foreach_mul([params[l][n] for l, n in keys], 1.0 - decay)
    out = torch._foreach_add(scaled, mixed)
    new = {layer: {} for layer in ema}
    for (layer, n), t in zip(keys, out):
        new[layer][n] = t
    return new
