"""ctypes binding for the native (C++/OpenMP) preprocessing library.

``native/doublets.cpp`` implements the doublet cross-join without the
O(n1*n2) temporaries of the numpy path — the preprocessing hot loop that
costs the reference minutes per mu200 file
(`/root/reference/gnn/GraphConstructionDev_mu200.ipynb:cell9`).

The library is optional: if ``native/libgnn_native.so`` hasn't been built
(``make -C native``), everything falls back to the numpy implementation in
:mod:`gnn_fpga_jax.data.doublets`.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native",
    "libgnn_native.so")

_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int64)
    lib.select_segments_f64.restype = ctypes.c_int64
    lib.select_segments_f64.argtypes = [
        dp, dp, dp, ctypes.c_int64,
        dp, dp, dp, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double,
        ip, ip, ctypes.c_int64,
    ]
    lib.count_segments_f64.restype = ctypes.c_int64
    lib.count_segments_f64.argtypes = [
        dp, dp, dp, ctypes.c_int64,
        dp, dp, dp, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double,
    ]
    lib.num_threads.restype = ctypes.c_int
    lib.num_threads.argtypes = []
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def num_threads() -> int:
    lib = _load()
    return lib.num_threads() if lib else 0


def _as_f64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64))


def select_segments_native(
    r1, phi1, z1, r2, phi2, z2,
    phi_slope_cut: float, z0_max: float,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native cross-join doublet selection; None if the library is absent.

    Same contract as
    :func:`gnn_fpga_jax.data.doublets.select_segments_arrays`.
    """
    lib = _load()
    if lib is None:
        return None
    r1, phi1, z1 = _as_f64(r1), _as_f64(phi1), _as_f64(z1)
    r2, phi2, z2 = _as_f64(r2), _as_f64(phi2), _as_f64(z2)
    n1, n2 = len(r1), len(r2)
    if n1 == 0 or n2 == 0:
        z = np.zeros(0, np.int64)
        return z, z

    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int64)

    def run(cap: int):
        out1 = np.empty(cap, np.int64)
        out2 = np.empty(cap, np.int64)
        n = lib.select_segments_f64(
            r1.ctypes.data_as(dp), phi1.ctypes.data_as(dp),
            z1.ctypes.data_as(dp), n1,
            r2.ctypes.data_as(dp), phi2.ctypes.data_as(dp),
            z2.ctypes.data_as(dp), n2,
            float(phi_slope_cut), float(z0_max),
            out1.ctypes.data_as(ip), out2.ctypes.data_as(ip), cap)
        return n, out1, out2

    cap = max(1024, (n1 * n2) // 8)
    n, out1, out2 = run(cap)
    if n < 0:  # capacity miss: retry with the exact required size
        n, out1, out2 = run(-n)
    return out1[:n], out2[:n]
