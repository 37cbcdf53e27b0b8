"""Native host-side runtime (C++ through ctypes).

Counterpart of dostransformer_tpu/native: the periodic neighbour search
behind data/neighbors.py, from the port's own copy of the source
(``native/src/dostpu_native.cc``, ABI version 3). It gives the same bits as
the NumPy version beside it.

Unlike the JAX package, nothing falls back silently: the library is built at
first use (native/build.py) and a failed build, or a library of another ABI,
raises :class:`NativeError` and says why. The NumPy path is taken only when
asked for, with ``DOSTPU_NO_NATIVE=1`` (the JAX package's name).
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import numpy as np

ABI_VERSION = 3
_lib = None


class NativeError(RuntimeError):
    """The native library cannot be built or loaded, or misbehaved: a fault
    of the installation, never of one record's data."""


def enabled() -> bool:
    """False when ``DOSTPU_NO_NATIVE=1`` asks for the NumPy path."""
    return os.environ.get("DOSTPU_NO_NATIVE") != "1"


def library() -> ctypes.CDLL:
    """The loaded library, built at first use. Raises NativeError when it
    cannot be built or loaded, or reports another ABI version."""
    global _lib
    if _lib is not None:
        return _lib
    from dostransformer_tpu_torch.native.build import build

    path = build()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise NativeError(f"loading the native library {path} failed: {e}; "
                          f"rebuild it (python -m "
                          f"dostransformer_tpu_torch.native.build --force)"
                          ) from e
    lib.dostpu_abi_version.restype = ctypes.c_int64
    lib.dostpu_abi_version.argtypes = []
    version = lib.dostpu_abi_version()
    if version != ABI_VERSION:
        raise NativeError(f"native library {path} has ABI version {version}, "
                          f"this package binds version {ABI_VERSION}; "
                          f"rebuild it (python -m "
                          f"dostransformer_tpu_torch.native.build --force)")
    # full argtypes everywhere: without them ctypes passes the int64_t sizes
    # as c_int (a 32-bit cap)
    i64 = ctypes.c_int64
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.dostpu_neighbor_list.argtypes = [
        f64p, i64, f64p, ctypes.c_double, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), i64, i64p, i64p, i64p]
    lib.dostpu_neighbor_list.restype = i64
    _lib = lib
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def neighbor_list(positions: np.ndarray, cell: np.ndarray, cutoff: float,
                  pbc: Tuple[bool, bool, bool] = (True, True, True),
                  self_interaction: bool = True):
    """The C++ periodic neighbour search: (src [E], dst [E], shifts [E, 3])
    int64 in (shift, i, j) order, the contract of
    data.neighbors.neighbor_list_pbc on in-cell positions."""
    lib = library()
    positions = np.ascontiguousarray(positions, np.float64)
    cell = np.ascontiguousarray(cell, np.float64)
    pbc_arr = np.ascontiguousarray(pbc, np.uint8)
    if pbc_arr.shape != (3,):
        raise ValueError(f"pbc must have 3 entries, got {pbc_arr.shape}")
    args = (_ptr(positions, ctypes.c_double), positions.shape[0],
            _ptr(cell, ctypes.c_double), float(cutoff), int(self_interaction),
            _ptr(pbc_arr, ctypes.c_uint8))
    count = lib.dostpu_neighbor_list(*args, 0, None, None, None)
    if count < 0:
        raise ValueError(f"native neighbour search: singular cell {cell!r}")
    src = np.empty(count, np.int64)
    dst = np.empty(count, np.int64)
    shifts = np.empty((count, 3), np.int64)
    got = lib.dostpu_neighbor_list(*args, count, _ptr(src, ctypes.c_int64),
                                   _ptr(dst, ctypes.c_int64),
                                   _ptr(shifts, ctypes.c_int64))
    if got != count:
        raise NativeError(f"native neighbour search returned {got} pairs, "
                           f"counted {count}")
    return src, dst, shifts
