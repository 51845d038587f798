"""ctypes bindings for the C++ SAH BVH builder (csrc/tpurt_native.cpp).

The library is built with g++ at first use into ``build/tpurt_torch/``
(see _build.py). Large meshes build their BVH here, small ones with the
numpy builder in accel/bvh.py — the same split tpurt makes, with the
same builder code, so both packages build the same trees. A failed
build raises: the port does not switch builders behind the caller's
back.
"""

from __future__ import annotations

import ctypes

import numpy as np


class TnNode(ctypes.Structure):
    _fields_ = [
        ("bmin", ctypes.c_float * 3),
        ("bmax", ctypes.c_float * 3),
        ("child", ctypes.c_int64),
        ("first", ctypes.c_int64),
        ("ntris", ctypes.c_int64),
    ]


def _lib() -> ctypes.CDLL:
    from tpurt_torch import _build

    lib = _build.load("tpurt_native")
    if not getattr(lib, "_tpurt_ready", False):
        lib.tn_build_bvh.restype = ctypes.c_int64
        lib.tn_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(TnNode),
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ]
        lib._tpurt_ready = True
    return lib


def build_bvh(tri_pos: np.ndarray, tri_nrm: np.ndarray, first: int, n: int,
              max_depth: int, leaf_cap: int, aux: np.ndarray = None):
    """Native SAH build over tri_pos/tri_nrm[first : first + n] (permuted
    in place; C-contiguous float32 (T, 3, 3)), and ``aux`` (optional,
    C-contiguous int64 (T,)) permuted alongside. Returns the subtree's
    (bmin, bmax, child, first, ntris) numpy arrays, child links relative
    to the subtree's root at 0."""
    for name, a in (("tri_pos", tri_pos), ("tri_nrm", tri_nrm)):
        if not a.flags.c_contiguous or a.dtype != np.float32:
            raise ValueError(f"{name} must be a C-contiguous float32 array")
    if aux is not None and (not aux.flags.c_contiguous or aux.dtype != np.int64
                            or aux.shape != tri_pos.shape[:1]):
        raise ValueError("aux must be a C-contiguous int64 array, one a triangle")
    if first < 0 or n < 0 or first + n > tri_pos.shape[0]:
        raise ValueError(f"triangle range [{first}, {first + n}) out of bounds")
    cap = 2 * max(n, 1) + 1
    out = (TnNode * cap)()
    count = ctypes.c_int64(0)
    fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    root = _lib().tn_build_bvh(
        fp(tri_pos), fp(tri_nrm),
        ctypes.POINTER(ctypes.c_int64)() if aux is None
        else aux.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        first, n, max_depth, leaf_cap, out, 0, cap, ctypes.byref(count),
    )
    if root < 0:
        raise RuntimeError("native BVH build exceeded its node capacity")
    raw = np.frombuffer(bytes(out)[: count.value * ctypes.sizeof(TnNode)],
                        dtype=np.dtype([
                            ("bmin", np.float32, 3), ("bmax", np.float32, 3),
                            ("child", np.int64), ("first", np.int64),
                            ("ntris", np.int64),
                        ]))
    return (raw["bmin"].copy(), raw["bmax"].copy(), raw["child"].copy(),
            raw["first"].copy(), raw["ntris"].copy())
