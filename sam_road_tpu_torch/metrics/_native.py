"""ctypes loader for the native TOPO kernels, native/topo.cc (counterpart of
sam_road_tpu/metrics/_native.py, with the same ctypes signatures).

Built at first use by the port's _native.build_and_load with the JAX
package's flags: -ffp-contract=off keeps the C++ doubles on the Python
doubles bit for bit (no fma contraction). A missing g++, a failed compile
or a library that does not load raises RuntimeError; nothing falls back to
Python. The Python bodies in topo_graph.py and topo.py are the plain
versions of the native calls, and run only when USE_NATIVE is False (the
switch the tests set, as JAX's tests set its _NATIVE to None)."""

from __future__ import annotations

import ctypes
import functools

from sam_road_tpu_torch._native import build_and_load, native_source

USE_NATIVE = True


@functools.cache
def _lib():
    dll = build_and_load(
        "samroad_topo", "g++", ["-O2", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17"],
        [native_source("topo.cc")])
    i64, f64 = ctypes.c_int64, ctypes.c_double
    pi64 = ctypes.POINTER(ctypes.c_int64)
    pf64 = ctypes.POINTER(ctypes.c_double)
    dll.topo_graph_create.restype = ctypes.c_void_p
    dll.topo_graph_create.argtypes = [i64, pf64, pi64, pi64, pi64, pi64]
    dll.topo_graph_free.restype = None
    dll.topo_graph_free.argtypes = [ctypes.c_void_p]
    dll.topo_walk.restype = i64
    dll.topo_walk.argtypes = [
        ctypes.c_void_p, i64, f64, f64, ctypes.c_int, ctypes.c_int,
        i64, i64, f64, f64, ctypes.c_int, pf64, i64,
    ]
    dll.topo_loc_distance.restype = f64
    dll.topo_loc_distance.argtypes = [
        ctypes.c_void_p, i64, i64, f64, f64, i64, i64, f64, f64, f64,
    ]
    dll.topo_match.restype = i64
    dll.topo_match.argtypes = [pf64, i64, pf64, i64, f64, ctypes.c_int]
    return dll


def load_topo_native():
    """The native TOPO library (built at the first call), or None when
    USE_NATIVE is False. A failed build raises."""
    return _lib() if USE_NATIVE else None
