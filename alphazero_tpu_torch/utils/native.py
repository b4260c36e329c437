"""ctypes bindings for the native replay core (native/replay_core.cpp):
the port's own copy of ``alphazero_tpu/utils/native.py``.

Falls back to numpy/zlib transparently when the shared library hasn't been
built (``make -C native``)."""

from __future__ import annotations

import ctypes
import os
import zlib

import numpy as np

_LIB = None


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.path.join(here, "native", "libreplay_core.so")
    if not os.path.exists(path):
        _LIB = False
        return False
    lib = ctypes.CDLL(path)
    lib.rc_compress.restype = ctypes.c_longlong
    lib.rc_compress.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                ctypes.c_char_p, ctypes.c_longlong,
                                ctypes.c_int]
    lib.rc_decompress.restype = ctypes.c_longlong
    lib.rc_decompress.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                  ctypes.c_char_p, ctypes.c_longlong]
    lib.rc_sample_weighted.restype = ctypes.c_longlong
    lib.rc_sample_weighted.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint32)]
    lib.rc_sample_uniform.restype = ctypes.c_longlong
    lib.rc_sample_uniform.argtypes = [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint32)]
    _LIB = lib
    return lib


def have_native() -> bool:
    return bool(_load())


def compress(data: bytes, level: int = 1) -> bytes:
    lib = _load()
    if not lib:
        return zlib.compress(data, level)
    cap = len(data) + (len(data) >> 9) + 64
    dst = ctypes.create_string_buffer(cap)
    n = lib.rc_compress(data, len(data), dst, cap, level)
    if n < 0:
        return zlib.compress(data, level)
    return dst.raw[:n]


def decompress(data: bytes, expected_size: int) -> bytes:
    lib = _load()
    if not lib:
        return zlib.decompress(data)
    dst = ctypes.create_string_buffer(expected_size)
    n = lib.rc_decompress(data, len(data), dst, expected_size)
    if n < 0:
        return zlib.decompress(data)
    return dst.raw[:n]


def sample_weighted(weights: np.ndarray, k: int, seed: int) -> np.ndarray:
    """k distinct indices ~ weights (without replacement)."""
    lib = _load()
    n = len(weights)
    if not lib:
        rng = np.random.default_rng(seed)
        p = np.maximum(weights.astype(np.float64), 1e-12)
        return rng.choice(n, size=min(k, n), replace=False, p=p / p.sum())
    w = np.ascontiguousarray(weights, np.float32)
    out = np.empty(min(k, n), np.uint32)
    m = lib.rc_sample_weighted(
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, k,
        seed & 0xFFFFFFFFFFFFFFFF,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return out[:m].astype(np.int64)


def sample_uniform(n: int, k: int, seed: int) -> np.ndarray:
    lib = _load()
    if not lib:
        rng = np.random.default_rng(seed)
        return rng.choice(n, size=min(k, n), replace=False)
    out = np.empty(min(k, n), np.uint32)
    m = lib.rc_sample_uniform(n, k, seed & 0xFFFFFFFFFFFFFFFF,
                              out.ctypes.data_as(
                                  ctypes.POINTER(ctypes.c_uint32)))
    return out[:m].astype(np.int64)
