"""Native (C++) host-side components, loaded with ctypes.

Counterpart of ``spotlight_tpu/native/__init__.py``, with the port's own
copy of ``markov.cpp``.  ``g++`` builds the library at first use into
``build/native/`` at the root of the checkout (never beside the sources);
the file name carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded.  This is host code,
not a device kernel: where the build fails (no compiler), :func:`load`
returns None and :func:`markov_walk` returns None, and callers run the
Python loop, which gives the same states.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / 'markov.cpp'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'native'
FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')

_lock = threading.Lock()
_lib = None
_build_failed = False


def library_path():
    """Path of the library built from ``markov.cpp`` as it is now."""
    digest = hashlib.sha256(' '.join(FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / 'markov-{}.so'.format(digest.hexdigest()[:16])


def _build(path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name('{}.{}.tmp'.format(path.name, os.getpid()))
    subprocess.run(['g++', *FLAGS, '-o', str(tmp), str(SOURCE)], check=True,
                   capture_output=True)
    os.replace(tmp, path)


def load():
    """Load (building if necessary) the native library; None when it cannot
    be built or loaded."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.CalledProcessError):
            _build_failed = True
            return None
        lib.markov_walk.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.markov_walk.restype = None
        _lib = lib
        return _lib


def markov_walk(cumulative, rvs, state, out=None):
    """Order-k Markov walk over cumulative transition rows.

    Parameters
    ----------
    cumulative : (num_states, num_states) float64
        Per-state cumulative transition probabilities.
    rvs : (num_steps,) float64 uniform draws
    state : (order,) int64 initial window, read only (the walk advances a
        contiguous copy)
    out : optional (num_steps,) int32 output buffer

    Returns
    -------
    (num_steps,) int32 generated states, or None when the native library is
    unavailable (callers then run the Python loop).
    """
    lib = load()
    if lib is None:
        return None

    cumulative = np.ascontiguousarray(cumulative, dtype=np.float64)
    rvs = np.ascontiguousarray(rvs, dtype=np.float64)
    state = np.array(state, dtype=np.int64)
    num_states = cumulative.shape[0]
    if cumulative.shape != (num_states, num_states):
        raise ValueError('cumulative must be square, got {}'.format(
            cumulative.shape))
    if len(state) < 1 or state.min() < 0 or state.max() >= num_states:
        raise ValueError('state must hold 1 or more ids in [0, {})'.format(
            num_states))
    if out is None:
        out = np.empty(len(rvs), dtype=np.int32)
    if out.dtype != np.int32 or out.shape != rvs.shape or not (
            out.flags.c_contiguous):
        raise ValueError('out must be a contiguous int32 array of {} '
                         'states'.format(len(rvs)))

    lib.markov_walk(
        cumulative.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(num_states),
        ctypes.c_int64(len(state)),
        rvs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(len(rvs)),
        state.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out
