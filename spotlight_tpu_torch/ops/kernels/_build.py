"""Builds and loads the CUDA kernels of ``csrc/``.

Each ``.cu`` source (with ``common.cuh``) is compiled by ``nvcc`` into its
own shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <name>.cu

The build happens at first use, into ``build/kernels/`` at the root of the
checkout.  A library's file name carries a hash of its source, of
``common.cuh`` and of the flags, so an edited source is rebuilt and a stale
library is never loaded.  The sources are compiled in parallel, one
``nvcc`` each.  A failed build raises; nothing falls back.  ``ptxas``
reports each kernel's registers and shared memory; the report is kept
beside the library as ``<name>-<hash>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[3] / 'build' / 'kernels'
SOURCES = ('ranking', 'topk', 'gather_sum', 'row_update')
FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-O3', '-std=c++17',
         '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    'ranking': {
        'spotlight_rank_weights': (_I, [_P, _P, _I, _P, _P, _P, _I, _I, _I,
                                        _I, _I, _I, _P]),
        'spotlight_matched_scores': (_I, [_P, _P, _I, _P, _P, _P, _I, _I, _I,
                                          _P]),
        'spotlight_candidate_scores': (_I, [_P, _P, _I, _P, _P, _P, _I, _I,
                                            _I, _I, _P]),
        'spotlight_rank_counts': (_I, [_P, _P, _I, _P, _P, _P, _P, _P, _I,
                                       _I, _I, _I, _I, _I, _P]),
        'spotlight_rank_max_targets': (_I, [_I]),
        'spotlight_rank_counts_max_targets': (_I, [_I]),
        'spotlight_rank_block_users': (_I, [_I]),
        'spotlight_rank_smem_bytes': (ctypes.c_size_t, [_I, _I]),
    },
    'topk': {
        'spotlight_streaming_topk': (_I, [_P, _P, _I, _P, _P, _P, _I, _I, _I,
                                          _I, _I, _I, _I, _P, _P, _P, _P]),
        'spotlight_topk_stage1_smem_bytes': (ctypes.c_size_t, [_I, _I, _I]),
    },
    'gather_sum': {
        'spotlight_gather_sum': (_I, [_P, _I, _P, _P, _L, _I, _I, _I, _I,
                                      _P]),
        'spotlight_scatter_rows': (_I, [_P, _I, _P, _P, _P, _I, _I, _I, _I,
                                        _I, _P]),
    },
    'row_update': {
        'spotlight_row_adam': (_I, [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                                    _I, _I] + [_F] * 9 + [_P]),
    },
}

_LOADED = {}


def _cuda_home():
    from torch.utils.cpp_extension import CUDA_HOME
    return CUDA_HOME


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    home = _cuda_home()
    if home and os.path.exists(os.path.join(home, 'bin', 'nvcc')):
        return os.path.join(home, 'bin', 'nvcc')
    raise RuntimeError('nvcc was not found (PATH, CUDA_HOME); the CUDA '
                       'kernels cannot be built')


def library_path(name):
    """Path of the library built from ``csrc/<name>.cu`` as it is now."""
    digest = hashlib.sha256()
    digest.update(' '.join(FLAGS).encode())
    for path in (CSRC / 'common.cuh', CSRC / (name + '.cu')):
        digest.update(path.read_bytes())
    return BUILD_DIR / '{}-{}.so'.format(name, digest.hexdigest()[:16])


def build():
    """Compile every source whose library is missing, all at once.

    Returns the list of sources that were compiled."""
    todo = [name for name in SOURCES if not library_path(name).exists()]
    if not todo:
        return []
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in todo:
        final = library_path(name)
        tmp = final.with_name('{}.{}.tmp'.format(final.name, os.getpid()))
        cmd = [nvcc, *FLAGS, '-o', str(tmp), str(CSRC / (name + '.cu'))]
        jobs.append((name, final, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for name, final, tmp, proc in jobs:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append('{}.cu:\n{}'.format(name, output))
            continue
        final.with_suffix('.log').write_text(output)
        os.replace(tmp, final)
    if failures:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(failures))
    return todo


def load(name):
    """The ``ctypes`` library of ``csrc/<name>.cu``, built if needed."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not path.exists():
        build()
    lib = ctypes.CDLL(str(path))
    for fn_name, (restype, argtypes) in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.restype = restype
        fn.argtypes = argtypes
    _LOADED[name] = lib
    return lib


def check(status, what):
    """Raise if a C entry point returned a CUDA error."""
    if status != 0:
        raise RuntimeError('{} failed with cudaError_t {}'.format(what,
                                                                   status))
