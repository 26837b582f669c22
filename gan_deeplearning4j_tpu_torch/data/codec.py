"""Exact fixed-point transport codec (own copy of
``gan_deeplearning4j_tpu/data/codec.py``, pinned bitwise to it by
tests/test_torch_data.py).

The dataset contract is 2-decimal fixed point: ``export_mnist_csv``
writes pixels with ``%.2f``.  When every feature value is exactly
``n/100`` with ``n in [0, 255]`` the table can live on the card as uint8
codes (1/4 the bytes) and be decoded on the card through a 256-entry f32
table, which reproduces the CSV-parsed float32 values BITWISE: each entry
is the correctly rounded f32 of n/100, the value the CSV parser produces
for the text of n/100.  ``u8x100_lossless`` verifies that against the
actual data before the codec is engaged; training with the codec on is
bit-identical to training without it (the protocol step's ``data_codec``
gathers through the table after slicing).
"""

from __future__ import annotations

import numpy as np

# table[n] = correctly-rounded float32 of n/100 (f64 divide is exact to
# <0.5 ulp f64, so the f64->f32 rounding lands on the correctly-rounded
# f32 — the same value decimal parsing yields for "0.37" etc.)
U8X100_TABLE = (np.arange(256, dtype=np.float64) / 100.0).astype(np.float32)


def u8x100_encode(features) -> np.ndarray:
    """f32 (n/100)-valued array -> uint8 codes.  Caller must have
    verified ``u8x100_lossless`` first; rounding here matches its
    quantizer exactly.  Block-scanned like the gate, so the f64
    temporaries stay ~tens of MB for arbitrarily large chunks."""
    f = np.asarray(features)
    out = np.empty(f.shape, np.uint8)
    flat_in, flat_out = f.reshape(-1), out.reshape(-1)
    block = 8 << 20
    for lo in range(0, flat_in.size, block):
        part = flat_in[lo:lo + block]
        flat_out[lo:lo + block] = np.rint(
            part.astype(np.float64) * 100.0).astype(np.uint8)
    return out


def u8x100_lossless(features) -> bool:
    """True iff every value decodes back BITWISE through the table —
    the gate for engaging the transport codec.  Scans in row blocks so
    the transient f64 temporaries stay ~tens of MB even for multi-GiB
    tables; NaN/inf values fail the range check (not an IndexError)."""
    f = np.asarray(features)
    if f.dtype != np.float32 or f.size == 0:
        return False
    flat = f.reshape(-1)
    block = 8 << 20  # 8M elements -> ~64 MB of f64 temporary
    for lo in range(0, flat.size, block):
        part = flat[lo:lo + block]
        q = np.rint(part.astype(np.float64) * 100.0)
        # element-wise comparisons are False for NaN, so non-finite
        # values are rejected here rather than crashing the gather below
        if not np.all((q >= 0) & (q <= 255)):
            return False
        if not np.array_equal(U8X100_TABLE[q.astype(np.intp)], part):
            return False
    return True


def u8x100_decode_np(codes) -> np.ndarray:
    """Host-side decode (tests / host consumers); the device-side decode
    is the same table gather inside the protocol step (``data_codec`` in
    train/fused_step.py).  Block-scanned: the intp index temporary is 8
    bytes/element, so an unblocked gather over a multi-GiB table would
    transiently double-plus its footprint."""
    c = np.asarray(codes)
    out = np.empty(c.shape, np.float32)
    flat_in, flat_out = c.reshape(-1), out.reshape(-1)
    block = 8 << 20
    for lo in range(0, flat_in.size, block):
        flat_out[lo:lo + block] = U8X100_TABLE[
            flat_in[lo:lo + block].astype(np.intp)]
    return out
