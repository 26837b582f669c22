"""Gradient clipping over ``{layer: {param: tensor}}`` trees (torch twin of
``gan_deeplearning4j_tpu/ops/clipping.py``)."""

from __future__ import annotations

import torch


def clip_elementwise(grads, threshold: float = 1.0):
    """DL4J ClipElementWiseAbsoluteValue: every element into [-t, t]."""
    return {layer: {n: torch.clamp(g, -threshold, threshold)
                    for n, g in lg.items()}
            for layer, lg in grads.items()}


def clip_by_global_norm(grads, max_norm: float):
    leaves = [g for lg in grads.values() for g in lg.values()]
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves))
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return {layer: {n: g * scale for n, g in lg.items()}
            for layer, lg in grads.items()}
