"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` (with the headers it includes from ``csrc/``) is
compiled by ``nvcc`` for ``sm_90a`` into its own shared library with a
plain C interface, loaded with ``ctypes``.  All sources compile at once
(one ``nvcc`` process each, started together) the first time any kernel is
needed, into ``build/torch_kernels/<digest>/`` at the root of the
checkout, where ``digest`` hashes the sources and the
flags: an edit to any source builds a fresh set, and a finished set is
reused by later processes.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "torch_kernels"
KERNELS = ("fused_update", "bn_act", "upsample_bwd", "bn_moments_apply",
           "bn_act_4d")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# loaded libraries by kernel name and declared entry points by symbol,
# filled once per process by library() and function()
_loaded: Dict[str, ctypes.CDLL] = {}
_functions: Dict[str, ctypes._CFuncPtr] = {}


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / _digest()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME); "
                       "the CUDA kernels cannot be built")


def build(names: Sequence[str] = KERNELS) -> Dict[str, float]:
    """Compile every missing library of ``names`` in parallel.  Returns the
    wall seconds of the build (0.0 for each library already built) and
    raises with the compiler's output if any source fails."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not (out / f"lib{n}.so").exists()]
    seconds = {n: 0.0 for n in names}
    if not todo:
        return seconds
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = out / f"lib{n}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out / f"lib{n}.log").write_text(log)
        seconds[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            # atomic publish: a concurrent process never loads half a file
            os.replace(tmp, out / f"lib{n}.so")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building all kernels first if
    this checkout has no build of the current sources."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_dir() / f"lib{name}.so"
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def function(lib_name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """A C entry point with its argument types declared (an undeclared
    pointer would be passed as a 32-bit int) and an int return code."""
    fn = _functions.get(symbol)
    if fn is None:
        fn = getattr(library(lib_name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[symbol] = fn
    return fn


def check(code: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if code != 0:
        raise RuntimeError(f"{what}: kernel launch failed with cudaError_t "
                           f"{code}")
