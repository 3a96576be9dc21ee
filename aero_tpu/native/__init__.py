"""Native (C++) host-side components.

The reference leans on native libraries for its runtime (libcorrect Viterbi,
libacars, libzmq; SURVEY.md §2).  Here the device compute path is JAX,
and the host-side hot spots get native equivalents:

- ``libaeroviterbi.so``: K=7 r=1/2 soft Viterbi (libcorrect replacement)
  used by StreamingViterbi for single-frame host decodes.
- ``libaeroingest.so``: the SDR reader thread's per-sample work
  (ref: publish/publisher.cpp:234-306) — DC correction, IQ quantization to
  the int4/int8/int16 wire dtypes, PCM conversion.

Libraries are built on demand with g++ if the shared object is missing;
everything degrades gracefully to the pure-numpy/JAX implementations.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_libs = {}


def _build_and_load(name: str, src_base: str, extra_flags=()):
    if name in _libs:
        return _libs[name]
    so = os.path.join(_DIR, name)
    src = os.path.join(_DIR, src_base)
    # Rebuild when missing OR stale (source edited after the .so was built) —
    # a stale shared object would silently mask source changes.
    stale = (not os.path.exists(so)
             or (os.path.exists(src)
                 and os.path.getmtime(src) > os.path.getmtime(so)))
    if stale:
        try:
            subprocess.run(["g++", "-O3", *extra_flags, "-shared", "-fPIC",
                            "-o", so, src],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            if not os.path.exists(so):
                _libs[name] = None
                return None
            # Build failed but an older .so exists: fall back to it.
    try:
        _libs[name] = ctypes.CDLL(so)
    except OSError:
        _libs[name] = None
    return _libs[name]


def _load():
    lib = _build_and_load("libaeroviterbi.so", "viterbi.cc")
    if lib is not None and not hasattr(lib, "_sigs_set"):
        lib.aero_viterbi_decode_soft.restype = ctypes.c_int
        lib.aero_viterbi_decode_soft.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.aero_viterbi_decode_soft_batch.restype = ctypes.c_int
        lib.aero_viterbi_decode_soft_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8)]
        lib._sigs_set = True
    return lib


def _load_ingest():
    lib = _build_and_load("libaeroingest.so", "ingest.cc",
                          extra_flags=("-march=native", "-funroll-loops"))
    if lib is not None and not hasattr(lib, "_sigs_set"):
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.aero_dc_correct.argtypes = [f32p, ctypes.c_long, ctypes.c_float,
                                        f32p]
        lib.aero_quantize_int4.argtypes = [f32p, ctypes.c_long,
                                           ctypes.c_float,
                                           ctypes.POINTER(ctypes.c_uint8)]
        lib.aero_quantize_int2.argtypes = [f32p, ctypes.c_long,
                                           ctypes.c_float,
                                           ctypes.POINTER(ctypes.c_uint8)]
        lib.aero_quantize_int8.argtypes = [f32p, ctypes.c_long,
                                           ctypes.c_float,
                                           ctypes.POINTER(ctypes.c_int8)]
        lib.aero_quantize_int16.argtypes = [f32p, ctypes.c_long,
                                            ctypes.c_float,
                                            ctypes.POINTER(ctypes.c_int16)]
        lib.aero_pcm16_to_f32.argtypes = [ctypes.POINTER(ctypes.c_int16),
                                          ctypes.c_long, f32p]
        lib._sigs_set = True
    return lib


def have_native() -> bool:
    return _load() is not None


def have_native_ingest() -> bool:
    return _load_ingest() is not None


def _as_f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def dc_correct_native(iq: np.ndarray, alpha: float,
                      state: np.ndarray) -> np.ndarray:
    """In-place one-pole DC correction of complex64 [n]; ``state`` is a
    float32 [2] carry, updated in place.  Returns ``iq``."""
    lib = _load_ingest()
    assert iq.dtype == np.complex64 and iq.flags.c_contiguous
    assert state.dtype == np.float32 and state.size == 2
    lib.aero_dc_correct(_as_f32p(iq.view(np.float32)), iq.size,
                        ctypes.c_float(alpha), _as_f32p(state))
    return iq


def quantize_native(iq: np.ndarray, dtype: str) -> np.ndarray:
    """complex64 [n] -> packed uint8 [n] ("int4") or planar [2, n]
    ("int8"/"int16").  Bit-exact with the numpy paths in FusedStation."""
    lib = _load_ingest()
    if lib is None:
        raise RuntimeError("native ingest unavailable")
    iq = np.ascontiguousarray(iq, np.complex64)
    p = _as_f32p(iq.view(np.float32))
    n = iq.size
    if dtype == "int4":
        out = np.empty(n, np.uint8)
        lib.aero_quantize_int4(p, n, ctypes.c_float(7.0),
                               out.ctypes.data_as(
                                   ctypes.POINTER(ctypes.c_uint8)))
    elif dtype == "int2":
        assert n % 2 == 0
        arms = iq.view(np.float32)
        sigma = float(np.sqrt(np.mean(arms * arms))) or 1.0
        out = np.empty(n // 2, np.uint8)
        lib.aero_quantize_int2(p, n, ctypes.c_float(sigma),
                               out.ctypes.data_as(
                                   ctypes.POINTER(ctypes.c_uint8)))
        return out, np.float32(sigma)
    elif dtype == "int8":
        out = np.empty((2, n), np.int8)
        lib.aero_quantize_int8(p, n, ctypes.c_float(127.0),
                               out.ctypes.data_as(
                                   ctypes.POINTER(ctypes.c_int8)))
    elif dtype == "int16":
        out = np.empty((2, n), np.int16)
        lib.aero_quantize_int16(p, n, ctypes.c_float(32767.0),
                                out.ctypes.data_as(
                                    ctypes.POINTER(ctypes.c_int16)))
    else:
        raise ValueError(dtype)
    return out


def pcm16_to_f32_native(pcm: np.ndarray) -> np.ndarray:
    lib = _load_ingest()
    if lib is None:
        raise RuntimeError("native ingest unavailable")
    pcm = np.ascontiguousarray(pcm, "<i2")
    out = np.empty(pcm.size, np.float32)
    lib.aero_pcm16_to_f32(pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                          pcm.size, _as_f32p(out))
    return out


def viterbi_decode_soft_native(soft) -> np.ndarray:
    """soft: array-like of soft bytes (0..255); returns hard bits [T//2]."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native viterbi unavailable")
    soft = np.ascontiguousarray(np.clip(np.asarray(soft), 0, 255),
                                dtype=np.uint8)
    out = np.empty(soft.size // 2, np.uint8)
    lib.aero_viterbi_decode_soft(
        soft.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), soft.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out
