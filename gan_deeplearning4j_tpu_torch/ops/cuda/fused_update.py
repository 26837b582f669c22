"""The RmsProp update chain over a list of leaves: L2, clip, cache EMA,
scaled step — one kernel launch for all of a graph's leaves.

Replaces ``fused_rmsprop_chain`` / ``_chain_kernel`` of
``gan_deeplearning4j_tpu/ops/pallas/fused_update.py`` (one pass per leaf
there).  CUDA source: ``csrc/fused_update.cu``.

    g  = clip(g + l2*p, +-clip)       # l2 only on W leaves (the caller's)
    c' = rho*c + (1-rho)*g^2
    p' = p - lr*g*rsqrt(c' + eps)

Bound on the card: device memory, 20 bytes per element (read p, g, c; write
p', c'); the DCGAN protocol step moves about 217 MB through it, 65 us at
3.35 TB/s.  Most of a graph's leaves are tiny (biases, BN vectors), so a
launch per leaf costs far more than its bytes, on the device and on the
host.  The kernel is multi-tensor: ``launch_plan`` lays a graph's leaves
out as one table — each leaf's offset in two flat output buffers (on
4-element, 16-byte boundaries), its range of 4,096-element blocks, its
rates, and whether all its pointers are 16-byte aligned (float4 loads) —
and one launch updates every leaf.  The parts of the table that do not
change from step to step are cached per list of sizes and rates, so a step
fills in only the pointers.  Every RmsProp leaf takes it on the card: the
TPU package's 64K-element gate (a tile-padding threshold) is not carried
over.

Out of place, so a leaf aliased by a weight sync keeps its old value.  The
updated leaves are views into the launch's two flat buffers (p' and c'), so
a leaf keeps its whole buffer alive, and ``torch.save`` of one leaf would
write the whole buffer; the port saves no tensor with ``torch.save``
(``interop.py`` copies through numpy).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from gan_deeplearning4j_tpu_torch.ops.cuda import build

# csrc/fused_update.cu kMaxLeaves, kChunk: the leaves of one launch (the
# table then fits the classic 4 KB kernel-parameter limit) and the elements
# of one block
MAX_LEAVES = 48
CHUNK = 4096
ALIGN = 4  # output offsets in elements: 16 bytes


class Rates(NamedTuple):
    """One leaf's RmsProp rates; ``l2`` is the caller's (W leaves only)."""

    lr: float
    rho: float
    eps: float
    l2: float = 0.0


_LeafPtrs = ctypes.c_void_p * MAX_LEAVES
_LeafFloats = ctypes.c_float * MAX_LEAVES
_LeafInts64 = ctypes.c_longlong * MAX_LEAVES


class _Table(ctypes.Structure):
    """csrc/fused_update.cu ``Table``, field for field."""

    _fields_ = [("p", _LeafPtrs), ("g", _LeafPtrs), ("c", _LeafPtrs),
                ("p_out", ctypes.c_void_p), ("c_out", ctypes.c_void_p),
                ("n", _LeafInts64), ("offset", _LeafInts64),
                ("first_block", ctypes.c_int * (MAX_LEAVES + 1)),
                ("lr", _LeafFloats), ("rho", _LeafFloats),
                ("one_minus_rho", _LeafFloats), ("eps", _LeafFloats),
                ("l2", _LeafFloats), ("clip", ctypes.c_float),
                ("has_clip", ctypes.c_int), ("n_leaves", ctypes.c_int),
                ("vec", ctypes.c_ubyte * MAX_LEAVES)]


@dataclasses.dataclass(frozen=True)
class Launch:
    """The part of one launch's table that is the same on every step."""

    start: int  # index of the launch's first leaf in the caller's list
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]  # in p_out / c_out, multiples of ALIGN
    first_blocks: Tuple[int, ...]  # len(sizes) + 1; the last is the grid
    total: int  # elements of p_out and of c_out
    rates: Tuple[Rates, ...]
    clip: Optional[float]

    @property
    def grid(self) -> int:
        return self.first_blocks[-1]

    @functools.cached_property
    def table(self) -> _Table:
        """The ctypes table with every field but the pointers and the vec
        flags filled in; a launch fills a copy."""
        t = _Table()
        k = len(self.sizes)
        t.n[:k] = self.sizes
        t.offset[:k] = self.offsets
        t.first_block[:k + 1] = self.first_blocks
        t.lr[:k] = [r.lr for r in self.rates]
        t.rho[:k] = [r.rho for r in self.rates]
        t.one_minus_rho[:k] = [1.0 - r.rho for r in self.rates]
        t.eps[:k] = [r.eps for r in self.rates]
        t.l2[:k] = [r.l2 for r in self.rates]
        t.clip = 0.0 if self.clip is None else self.clip
        t.has_clip = int(self.clip is not None)
        t.n_leaves = k
        return t


class Plan(NamedTuple):
    launches: Tuple[Launch, ...]
    vec: Tuple[bool, ...]  # per leaf: all five pointers 16-byte aligned


@functools.lru_cache(maxsize=64)
def _launches(sizes: Tuple[int, ...], rates: Tuple[Rates, ...],
              clip: Optional[float]) -> Tuple[Launch, ...]:
    launches = []
    for start in range(0, len(sizes), MAX_LEAVES):
        part = sizes[start:start + MAX_LEAVES]
        offsets, first_blocks, off, blocks = [], [0], 0, 0
        for n in part:
            offsets.append(off)
            off += -(-n // ALIGN) * ALIGN
            blocks += -(-n // CHUNK)
            first_blocks.append(blocks)
        launches.append(Launch(start, part, tuple(offsets), tuple(first_blocks),
                               off, rates[start:start + MAX_LEAVES], clip))
    return tuple(launches)


def launch_plan(sizes: Sequence[int], ptrs: Sequence[int],
                rates: Sequence[Rates], clip: Optional[float] = None) -> Plan:
    """The leaf table of ``csrc/fused_update.cu`` for leaves of ``sizes``
    elements: at most MAX_LEAVES leaves per launch, leaf i of a launch at
    ``offsets[i]`` of its flat outputs and on blocks ``[first_blocks[i],
    first_blocks[i+1])`` of CHUNK elements each.  ``ptrs[i]``: leaf i's
    input addresses (p, g, c) or-ed together; its outputs start 16-byte
    aligned (torch's allocations are, and every offset is a multiple of
    ALIGN; the C entry checks both), so ``vec[i]`` is whether ``ptrs[i]``
    is.  The launches are cached per (sizes, rates, clip); only ``vec`` is
    worked out anew."""
    return Plan(_launches(tuple(sizes), tuple(rates), clip),
                tuple(ptr % 16 == 0 for ptr in ptrs))


def rmsprop_chain_plain(p: torch.Tensor, g: torch.Tensor, c: torch.Tensor, *,
                        lr: float, rho: float, eps: float, l2: float = 0.0,
                        clip: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain of one leaf in plain torch ops, in the kernel's order."""
    if l2:
        g = g + l2 * p
    if clip is not None:
        g = torch.clamp(g, -clip, clip)
    c2 = rho * c + (1.0 - rho) * g * g
    return p - lr * g * torch.rsqrt(c2 + eps), c2


@functools.lru_cache(maxsize=None)
def _entry():
    size = build.function("fused_update", "gan4j_fused_rmsprop_table_bytes",
                          [])()
    if size != ctypes.sizeof(_Table):
        raise RuntimeError(f"fused_update: the C table is {size} bytes, the "
                           f"Python one {ctypes.sizeof(_Table)}")
    return build.function("fused_update", "gan4j_fused_rmsprop_multi",
                          [ctypes.c_void_p, ctypes.c_void_p])


def _launch(launch: Launch, ptrs, vec, ps, shapes, device, stream, p_new,
            c_new):
    """One launch over ``launch``'s leaves; appends their (p', c') views."""
    p_out = torch.empty(launch.total, dtype=torch.float32, device=device)
    c_out = torch.empty(launch.total, dtype=torch.float32, device=device)
    k = len(launch.sizes)
    s = slice(launch.start, launch.start + k)
    t = _Table.from_buffer_copy(launch.table)
    t.p[:k], t.g[:k], t.c[:k] = (x[s] for x in ptrs)
    t.vec[:k] = vec[s]
    t.p_out, t.c_out = p_out.data_ptr(), c_out.data_ptr()
    if launch.grid:  # else every leaf is empty
        build.check(_entry()(ctypes.byref(t), stream), "fused_rmsprop_chains")
        fused_rmsprop_chains.launches += 1
    # each leaf's p' and c': views at its offset with the leaf's own
    # (contiguous) strides
    for p, shape, off in zip(ps[s], shapes[s], launch.offsets):
        stride = p.stride()
        p_new.append(p_out.as_strided(shape, stride, off))
        c_new.append(c_out.as_strided(shape, stride, off))


def fused_rmsprop_chains(ps: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                         cs: Sequence[torch.Tensor], rates: Sequence[Rates], *,
                         clip: Optional[float] = None
                         ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """([p'], [c']) for f32 leaves of any shapes, all on one device:
    leaf i is (ps[i], gs[i], cs[i]) with ``rates[i]``; ``clip`` is shared.
    CPU leaves take the plain version leaf by leaf; CUDA leaves launch the
    kernel once per MAX_LEAVES leaves."""
    n = len(ps)
    if not len(gs) == len(cs) == len(rates) == n:
        raise ValueError(f"fused_rmsprop_chains: {n} params, {len(gs)} "
                         f"gradients, {len(cs)} caches, {len(rates)} rates")
    if not n:
        return [], []
    device, f32, shapes = ps[0].device, torch.float32, []
    for i, (p, g, c) in enumerate(zip(ps, gs, cs)):
        shape = p.shape
        if g.shape != shape or c.shape != shape:
            raise ValueError(f"fused_rmsprop_chains: leaf {i}: g "
                             f"{tuple(g.shape)} / cache {tuple(c.shape)} does "
                             f"not match p {tuple(shape)}")
        if p.dtype != f32 or g.dtype != f32 or c.dtype != f32:
            raise TypeError(f"fused_rmsprop_chains takes float32 only, got "
                            f"{p.dtype}/{g.dtype}/{c.dtype} at leaf {i}")
        if not p.device == g.device == c.device == device:
            raise ValueError(f"fused_rmsprop_chains: leaf {i} on "
                             f"{p.device}/{g.device}/{c.device} does not match "
                             f"leaf 0 on {device}")
        shapes.append(shape)
    if device.type == "cpu":
        outs = [rmsprop_chain_plain(p, g, c, lr=r.lr, rho=r.rho, eps=r.eps,
                                    l2=r.l2, clip=clip)
                for p, g, c, r in zip(ps, gs, cs, rates)]
        return [o[0] for o in outs], [o[1] for o in outs]
    if device.type != "cuda":
        raise ValueError(f"fused_rmsprop_chains: unsupported device {device}")
    # the contiguous tensors stay referenced until every launch is enqueued
    ps, gs, cs = ([t.contiguous() for t in ts] for ts in (ps, gs, cs))
    ptrs = tuple([t.data_ptr() for t in ts] for ts in (ps, gs, cs))
    plan = launch_plan([p.numel() for p in ps],
                       [a | b | c for a, b, c in zip(*ptrs)], rates, clip)
    stream = torch.cuda.current_stream(device).cuda_stream
    p_new: List[torch.Tensor] = []
    c_new: List[torch.Tensor] = []
    for launch in plan.launches:
        _launch(launch, ptrs, plan.vec, ps, shapes, device, stream, p_new,
                c_new)
    return p_new, c_new


def fused_rmsprop_chain(p: torch.Tensor, g: torch.Tensor, c: torch.Tensor, *,
                        lr: float, rho: float, eps: float, l2: float = 0.0,
                        clip: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(p', c') for one f32 leaf (the JAX function's name): the multi-leaf
    wrapper with one leaf."""
    (p2,), (c2,) = fused_rmsprop_chains([p], [g], [c], [Rates(lr, rho, eps, l2)],
                                        clip=clip)
    return p2, c2


fused_rmsprop_chains.launches = 0
