"""ctypes bindings for the host-side native kernels.

The shared library is compiled from the tracked source on first use
(g++) into ``_build/``, under a name keyed on a hash of the source, the
compiler flags and the host architecture, so a library built for
another source or another machine is never loaded: a key mismatch
builds anew.  This mirrors the reference's reliance on JIT-compiled
native code (numba LLVM kernels, reference annchor/utils.py:274-621)
without requiring any pre-built wheel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "annchor_native.cpp")
_BUILD_DIR = os.path.join(_HERE, "_build")
# portable flags: no -march=native, so the key needs no CPU model
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib = None


class NativeBuildError(RuntimeError):
    pass


def build_key(src: str = _SRC) -> str:
    """Hash of the source, the flags and the host architecture."""
    h = hashlib.sha256()
    with open(src, "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(_FLAGS).encode())
    h.update(platform.machine().encode())
    return h.hexdigest()[:16]


def lib_path(src: str = _SRC) -> str:
    return os.path.join(_BUILD_DIR, f"annchor_native-{build_key(src)}.so")


def _build(out: str) -> None:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *_FLAGS, "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except FileNotFoundError as e:  # no g++
        raise NativeBuildError("g++ not available") from e
    except subprocess.CalledProcessError as e:
        raise NativeBuildError(f"native build failed:\n{e.stderr}") from e
    os.replace(tmp, out)  # atomic: concurrent builders never see half


def get_lib():
    """Load (building if necessary) the native library, or raise."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = lib_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)

        lib.emd_single.restype = ctypes.c_double
        lib.emd_single.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.emd_single_ssp.restype = ctypes.c_double
        lib.emd_single_ssp.argtypes = lib.emd_single.argtypes
        lib.emd_batch.restype = ctypes.c_int
        lib.emd_batch.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_long,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.lev_batch.restype = ctypes.c_int
        lib.lev_batch.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_long,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.unpack_pairs.restype = ctypes.c_long
        lib.unpack_pairs.argtypes = [
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_long,
            ctypes.c_long,
            ctypes.c_long,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.unpack_pairs_rows.restype = ctypes.c_long
        lib.unpack_pairs_rows.argtypes = [
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_long,
            ctypes.c_long,
            ctypes.c_long,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    try:
        get_lib()
        return True
    except NativeBuildError:
        return False


def _cptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


# Solver packs (bin_i << 16 | bin_j) cell ids into SIGNED int32_t, so
# bin_i must stay below 1 << 15 to keep the packed id non-negative
# (ADVICE r4: 65535 overstated the safe range — i >= 32768 overflowed
# into the sign bit and cell >> 16 indexed negatively).
_MAX_EMD_BINS = 32767


def _check_bins(nbins: int) -> None:
    if nbins > _MAX_EMD_BINS:
        raise ValueError(
            f"exact EMD supports at most {_MAX_EMD_BINS} histogram bins "
            f"(got {nbins}); use the Sinkhorn scout engine for larger "
            "supports"
        )


def emd_single(a, b, cost) -> float:
    """Exact 1-Wasserstein distance between two histograms (network
    simplex)."""
    lib = get_lib()
    a = np.ascontiguousarray(a, dtype=np.float64)
    _check_bins(a.shape[0])
    b = np.ascontiguousarray(b, dtype=np.float64)
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    return lib.emd_single(
        _cptr(a, ctypes.c_double),
        _cptr(b, ctypes.c_double),
        a.shape[0],
        _cptr(cost, ctypes.c_double),
    )


def emd_single_ssp(a, b, cost) -> float:
    """Exact EMD via the independent SSP solver (test cross-check)."""
    lib = get_lib()
    a = np.ascontiguousarray(a, dtype=np.float64)
    b = np.ascontiguousarray(b, dtype=np.float64)
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    return lib.emd_single_ssp(
        _cptr(a, ctypes.c_double),
        _cptr(b, ctypes.c_double),
        a.shape[0],
        _cptr(cost, ctypes.c_double),
    )


def emd_batch(X, Y, cost, I, J) -> np.ndarray:
    """Exact EMD for pairs (X[I[k]], Y[J[k]]). Returns float64 (m,)."""
    lib = get_lib()
    X = np.ascontiguousarray(X, dtype=np.float64)
    Y = np.ascontiguousarray(Y, dtype=np.float64)
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    I = np.ascontiguousarray(I, dtype=np.int64)
    J = np.ascontiguousarray(J, dtype=np.int64)
    m = I.shape[0]
    _check_bins(X.shape[1])
    out = np.zeros(m, dtype=np.float64)
    rc = lib.emd_batch(
        _cptr(X, ctypes.c_double),
        X.shape[0],
        _cptr(Y, ctypes.c_double),
        Y.shape[0],
        X.shape[1],
        _cptr(cost, ctypes.c_double),
        _cptr(I, ctypes.c_long),
        _cptr(J, ctypes.c_long),
        m,
        _cptr(out, ctypes.c_double),
    )
    if rc != 0:
        raise ValueError("emd_batch: index out of range")
    return out


def lev_batch(codes, lengths, I, J) -> np.ndarray:
    """Edit distance for pairs of pre-encoded strings. int32 (m,)."""
    lib = get_lib()
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    I = np.ascontiguousarray(I, dtype=np.int64)
    J = np.ascontiguousarray(J, dtype=np.int64)
    m = I.shape[0]
    out = np.zeros(m, dtype=np.int32)
    rc = lib.lev_batch(
        _cptr(codes, ctypes.c_int32),
        _cptr(lengths, ctypes.c_int32),
        codes.shape[0],
        codes.shape[1],
        _cptr(I, ctypes.c_long),
        _cptr(J, ctypes.c_long),
        m,
        _cptr(out, ctypes.c_int32),
    )
    if rc != 0:
        raise ValueError("lev_batch: index out of range")
    return out


def unpack_pairs(words, nx, row_off=0):
    """Decode a bit-packed (B, W)-uint32 candidate-mask block into
    (rows, cols) int32 coordinate arrays (bit b of word w = column
    32w+b, rows offset by row_off).  ~memory-bandwidth speed; replaces
    the numpy unpackbits+nonzero round trip on the locality path."""
    lib = get_lib()
    words = np.ascontiguousarray(words, dtype=np.uint32)
    B, W = words.shape
    null = ctypes.POINTER(ctypes.c_int32)()
    cap = lib.unpack_pairs(
        _cptr(words, ctypes.c_uint32), B, W, nx, row_off, null, null
    )
    out_i = np.empty(cap, dtype=np.int32)
    out_j = np.empty(cap, dtype=np.int32)
    cnt = lib.unpack_pairs(
        _cptr(words, ctypes.c_uint32), B, W, nx, row_off,
        _cptr(out_i, ctypes.c_int32), _cptr(out_j, ctypes.c_int32),
    )
    return out_i[:cnt], out_j[:cnt]


def count_pairs(words) -> int:
    """Set-bit count of a packed (B, W)-uint32 mask block."""
    lib = get_lib()
    words = np.ascontiguousarray(words, dtype=np.uint32)
    null = ctypes.POINTER(ctypes.c_int32)()
    return lib.unpack_pairs(
        _cptr(words, ctypes.c_uint32), words.shape[0], words.shape[1],
        words.shape[1] * 32, 0, null, null,
    )


def unpack_pairs_into(words, nx, row_off, out_ij) -> int:
    """Decode a packed mask block directly into rows of a preallocated
    int32 (m, 2) array slice; returns rows written.  `out_ij` must be
    C-contiguous with at least popcount(words) free rows."""
    lib = get_lib()
    words = np.ascontiguousarray(words, dtype=np.uint32)
    assert out_ij.dtype == np.int32 and out_ij.flags.c_contiguous
    return lib.unpack_pairs_rows(
        _cptr(words, ctypes.c_uint32), words.shape[0], words.shape[1],
        nx, row_off, _cptr(out_ij, ctypes.c_int32),
    )
