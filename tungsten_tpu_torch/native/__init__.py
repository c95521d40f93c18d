"""Host C++ runtime of the port: the BVH build (bvh_builder.cpp) and the
OBJ parser (objloader.cpp), compiled together with g++ at first use into
one library and bound through ctypes.  The flags are the JAX package's,
so the port builds byte-identical trees from the same triangles; where
g++ is missing, scene/bvh.py falls back to its numpy build and
io/mesh.py to its Python OBJ parser, which give the same results."""
from __future__ import annotations

import ctypes
import functools
import subprocess
import sys
import threading

import numpy as np

from tungsten_tpu_torch._build import build_shared

_SOURCES = ["native/bvh_builder.cpp", "native/objloader.cpp"]
# trt_load_obj stages its result in a global that trt_obj_fetch frees:
# one load at a time (the server renders in a thread of its own)
_obj_lock = threading.Lock()


@functools.lru_cache(maxsize=1)
def get_lib():
    """The loaded library, or None when it cannot be built here."""
    try:
        path = build_shared("tungsten_rt", _SOURCES,
                            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC"],
                            timeout=120)
    except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
        sys.stderr.write(f"tungsten_tpu_torch: native build skipped: {e}\n")
        return None
    lib = ctypes.CDLL(path)
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.trt_build_bvh.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_int,
                                  f32p, f32p, i32p, i32p, i32p]
    lib.trt_build_bvh.restype = ctypes.c_int
    lib.trt_load_obj.argtypes = [ctypes.c_char_p, i64p, i64p]
    lib.trt_load_obj.restype = ctypes.c_int
    lib.trt_obj_fetch.argtypes = [f32p, f32p, f32p, i32p]
    lib.trt_obj_fetch.restype = ctypes.c_int
    return lib


def available() -> bool:
    return get_lib() is not None


def build_bvh_native(prim_min: np.ndarray, prim_max: np.ndarray,
                     max_leaf: int = 4):
    """Native binned-SAH build; returns (bounds_min, bounds_max, meta,
    skip, order) or None when the library is unavailable."""
    lib = get_lib()
    n = int(prim_min.shape[0])
    if lib is None or n == 0:
        return None
    pmin = np.ascontiguousarray(prim_min, np.float32)
    pmax = np.ascontiguousarray(prim_max, np.float32)
    cap = 2 * n
    out_min = np.empty((cap, 3), np.float32)
    out_max = np.empty((cap, 3), np.float32)
    out_meta = np.empty((cap, 2), np.int32)
    out_skip = np.empty(cap, np.int32)
    out_order = np.empty(n, np.int32)
    num = lib.trt_build_bvh(pmin, pmax, n, max_leaf, out_min, out_max,
                            out_meta, out_skip, out_order)
    if num <= 0:
        return None
    return (out_min[:num].copy(), out_max[:num].copy(),
            out_meta[:num].copy(), out_skip[:num].copy(), out_order)


def load_obj_native(path: str):
    """Native OBJ parse; returns (pos, normal, uv, indices) or None (no
    library, an unreadable file, or no vertex or no triangle)."""
    lib = get_lib()
    if lib is None:
        return None
    nv = ctypes.c_int64()
    nt = ctypes.c_int64()
    with _obj_lock:
        if lib.trt_load_obj(str(path).encode(), ctypes.byref(nv),
                            ctypes.byref(nt)) != 0:
            return None
        nv, nt = nv.value, nt.value
        pos = np.empty((nv, 3), np.float32)
        nrm = np.empty((nv, 3), np.float32)
        uv = np.empty((nv, 2), np.float32)
        idx = np.empty((nt, 3), np.int32)
        if lib.trt_obj_fetch(pos, nrm, uv, idx) != 0:
            return None
    if nv == 0 or nt == 0:
        return None
    return pos, nrm, uv, idx
