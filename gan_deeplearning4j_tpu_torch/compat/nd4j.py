"""``Nd4j`` / ``INDArray`` migration shim (torch twin of
``gan_deeplearning4j_tpu/compat/nd4j.py``) — the ND4J host-array idioms
the reference's mains are written in (``Nd4j.randn(b, z).muli(2).subi(1)``
for latent draws, ``Nd4j.linspace`` grids, ``vstack`` batch assembly,
``getDouble`` scalar reads), so that data-prep code ports line for line.

Numpy-backed, as in the JAX package: every call the mains make with this
API is host-side batch assembly and artifact formatting.  Arrays enter
torch at the graph boundary (``np.asarray`` / ``torch.as_tensor`` read
these wrappers through ``__array__``).  In-place ``-i`` methods mutate and
return self (ND4J semantics); the non-``i`` variants copy.

Covered surface = every Nd4j/INDArray call in the two reference mains:
randn, rand, ones, zeros, linspace, vstack, create, setDataType,
getRandom().setSeed, getMemoryManager, getBackend; add/addi, sub/subi,
mul/muli, div/divi, reshape, dup, getDouble, putScalar, transpose,
shape/rows/columns.  ``setDataType`` sets the factories' dtype only (the
JAX shim also sets its package's compute dtype; the port's precision
policy is ``runtime/backend.py``'s flags); ``getBackend`` names the
port's torch device.
"""

from __future__ import annotations

import numpy as np


class INDArray:
    """Thin mutable wrapper over a numpy array with ND4J method names."""

    __slots__ = ("a",)

    def __init__(self, a):
        self.a = np.asarray(a)

    # numpy/torch interop: np.asarray(x) / torch.as_tensor(x) both work,
    # so these wrappers pass straight into graph.fit / score_on
    def __array__(self, dtype=None):
        return self.a if dtype is None else self.a.astype(dtype)

    def data(self) -> np.ndarray:
        return self.a

    # -- elementwise (non-i: copy; -i: in-place, returns self) ----------
    def add(self, o): return INDArray(self.a + _raw(o))
    def sub(self, o): return INDArray(self.a - _raw(o))
    def mul(self, o): return INDArray(self.a * _raw(o))
    def div(self, o): return INDArray(self.a / _raw(o))

    def addi(self, o):
        self.a += _raw(o)
        return self

    def subi(self, o):
        self.a -= _raw(o)
        return self

    def muli(self, o):
        self.a *= _raw(o)
        return self

    def divi(self, o):
        self.a /= _raw(o)
        return self

    # -- shape / access ---------------------------------------------------
    def reshape(self, *shape):
        return INDArray(self.a.reshape(
            shape[0] if len(shape) == 1 and isinstance(shape[0], (tuple, list))
            else shape))

    def dup(self):
        return INDArray(self.a.copy())

    def transpose(self):
        return INDArray(self.a.T)

    def ravel(self):
        return INDArray(self.a.ravel())

    def getDouble(self, *idx) -> float:
        return float(self.a[idx if len(idx) > 1 else idx[0]])

    def putScalar(self, idx, value):
        self.a[tuple(idx) if isinstance(idx, (tuple, list)) else idx] = value
        return self

    def shape(self):
        return self.a.shape

    def rows(self) -> int:
        return self.a.shape[0]

    def columns(self) -> int:
        return self.a.shape[1]

    def length(self) -> int:
        return self.a.size

    def __repr__(self):
        return f"INDArray{self.a.shape}\n{self.a!r}"


def _raw(o):
    return o.a if isinstance(o, INDArray) else o


class _Random:
    def __init__(self):
        self.state = np.random.RandomState(666)  # the reference's seed

    def setSeed(self, seed: int) -> None:
        self.state = np.random.RandomState(seed)


class _MemoryManager:
    """``Nd4j.getMemoryManager().setAutoGcWindow(5000)`` shim: torch's
    caching allocator owns device memory, so there is nothing to configure
    — kept so the reference's setup lines port without edits."""

    def setAutoGcWindow(self, ms: int) -> None:
        pass


class _Nd4j:
    """Module-style singleton mirroring the ``Nd4j`` static surface."""

    def __init__(self):
        self._random = _Random()
        self._dtype = np.float32
        self._memory = _MemoryManager()

    # -- factories (DL4J shapes: (rows, cols) args or a shape tuple) ------
    def _shape(self, args):
        if len(args) == 1 and isinstance(args[0], (tuple, list)):
            return tuple(args[0])
        return tuple(int(a) for a in args)

    def randn(self, *shape) -> INDArray:
        return INDArray(self._random.state.randn(
            *self._shape(shape)).astype(self._dtype))

    def rand(self, *shape) -> INDArray:
        return INDArray(self._random.state.rand(
            *self._shape(shape)).astype(self._dtype))

    def ones(self, *shape) -> INDArray:
        return INDArray(np.ones(self._shape(shape), self._dtype))

    def zeros(self, *shape) -> INDArray:
        return INDArray(np.zeros(self._shape(shape), self._dtype))

    def linspace(self, lower, upper, num) -> INDArray:
        # ND4J returns a 1 x num ROW VECTOR (the reference reshapes it
        # into its z-grid, dl4jGANComputerVision.java:363-370)
        return INDArray(np.linspace(lower, upper, int(num),
                                    dtype=self._dtype).reshape(1, -1))

    def vstack(self, *arrays) -> INDArray:
        arrs = arrays[0] if (len(arrays) == 1
                             and isinstance(arrays[0], (list, tuple))) else arrays
        return INDArray(np.vstack([_raw(a) for a in arrs]))

    def create(self, data) -> INDArray:
        return INDArray(np.asarray(_raw(data), dtype=self._dtype))

    # -- runtime config ----------------------------------------------------
    def setDataType(self, dtype) -> None:
        """``Nd4j.setDataType(DataBuffer.Type.FLOAT)``: accepts 'float' /
        'double' / a numpy dtype."""
        if isinstance(dtype, str):
            dtype = {"float": np.float32, "double": np.float64}[dtype.lower()]
        self._dtype = np.dtype(dtype).type

    def getRandom(self) -> _Random:
        return self._random

    def getMemoryManager(self) -> _MemoryManager:
        return self._memory

    def getBackend(self) -> str:
        """The port's device: ``torch-cuda`` when a card is attached
        (the port's entry points default to it), else ``torch-cpu``."""
        import torch

        return f"torch-{'cuda' if torch.cuda.is_available() else 'cpu'}"


Nd4j = _Nd4j()
