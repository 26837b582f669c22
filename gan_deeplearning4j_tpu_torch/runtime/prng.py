"""Seeding discipline (torch twin of ``gan_deeplearning4j_tpu/runtime/
prng.py``): named, independent, reproducible streams from one root seed,
as explicit ``torch.Generator``s instead of ``jax.random`` keys.  The two
packages draw different numbers from the same seed; parity tests make
their random inputs with numpy and hand them to both."""

from __future__ import annotations

import hashlib

import torch

NUMBER_OF_THE_BEAST = 666


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit seed for the stream ``name`` under ``seed`` (stable across
    runs and processes)."""
    h = hashlib.sha256(f"{seed}/{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, name: str, device="cpu") -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, name))
    return gen
