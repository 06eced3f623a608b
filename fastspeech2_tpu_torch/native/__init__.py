"""Native (C++) host code of the port: a DIO-style F0 estimator (``dio.cc``,
the port's own copy of ``fastspeech2_tpu/native/dio.cc``) bound with
ctypes, with the JAX package's C signature.

It is host code, not a kernel. The library is built with ``g++`` at first
use into ``build/native/`` at the repository root, under a name that hashes
the source and flags, so an edited source is rebuilt and a stale library is
never loaded; several processes may build at once (each writes its own
temporary file and renames it into place).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

log = logging.getLogger("fastspeech2_tpu_torch.native")

_SRC = Path(__file__).resolve().parent / "dio.cc"
_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _lib_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    return (Path(__file__).resolve().parents[2] / "build" / "native"
            / f"libfs2native_{h.hexdigest()[:16]}.so")


def _build(dst: Path) -> None:
    dst.parent.mkdir(parents=True, exist_ok=True)
    tmp = dst.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    log.info("building native library: %s", " ".join(cmd))
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    os.replace(tmp, dst)


def load() -> Optional[ctypes.CDLL]:
    """The native library, building it on first use. None if it cannot be
    built (callers take the pure-Python path)."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            path = _lib_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.fs2_dio.restype = ctypes.c_int
            lib.fs2_dio.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
                ctypes.c_int, ctypes.c_double, ctypes.c_double,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ]
            lib.fs2_native_version.restype = ctypes.c_char_p
            _lib = lib
        except Exception as e:  # missing toolchain, read-only checkout, ...
            log.warning("native library unavailable (%s); using Python paths", e)
            _build_failed = True
    return _lib


def available() -> bool:
    return load() is not None


def dio(wav: np.ndarray, sample_rate: int, hop_length: int,
        f0_floor: float = 71.0, f0_ceil: float = 800.0) -> np.ndarray:
    """Interval-based F0 track, (len(wav)//hop + 1,) float32 Hz, 0=unvoiced."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    wav32 = np.ascontiguousarray(wav, dtype=np.float32)
    n_frames = len(wav32) // hop_length + 1
    out = np.empty(n_frames, np.float32)
    got = lib.fs2_dio(
        wav32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(wav32),
        sample_rate, hop_length, f0_floor, f0_ceil,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_frames)
    if got != n_frames:
        raise RuntimeError(f"fs2_dio failed (returned {got}, want {n_frames})")
    return out
