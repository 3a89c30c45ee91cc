"""Build and load the CUDA kernels of ``ops/csrc/``.

The sources are compiled at first use with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per ``.cu`` file, all started together, and
linked into one shared library with a plain C interface, loaded with
``ctypes``. The library goes to ``build/torch_kernels/`` at the root of the
checkout, named by a hash of the sources, so an edited source rebuilds and
an unchanged one loads the cached library. A build failure raises: there is
no fallback to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from multiverso_tpu_torch.telemetry.profiling import record_compile

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LOCK = threading.Lock()
_LIB = None
#: seconds the last build took (0.0 when the cached library was loaded)
#: and what nvcc printed for it (``-Xptxas -v``: registers, spills)
build_seconds = 0.0
build_log = ""

_P, _I64, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    # (param, rows, cols, elem_bytes, ids, n, out, stream)
    "mv_row_gather": [_P, _I64, _I64, _I64, _P, _I64, _P, _P],
    # (bases, firsts, count, rows, cols, elem_bytes, ids, inv, L,
    #  zero_foreign, n, out, stream)
    "mv_row_gather_mesh": [_P, _P, _I64, _I64, _I64, _I64, _P, _P, _I64,
                           _I64, _I64, _P, _P],
    # (param, rows, cols, is_int, ids, sorted, deltas, valid, n, workspace,
    #  ws_words, stream)
    "mv_row_scatter_add": [_P, _I64, _I64, _I64, _P, _I64, _P, _P, _I64, _P,
                           _I64, _P],
    # (ids, n, R, workspace, ws_words, stream)
    "mv_row_scatter_plan": [_P, _I64, _I64, _P, _I64, _P],
    # (bases, firsts, count, rows, cols, is_int, plan, deltas, n, stream)
    "mv_row_scatter_add_mesh": [_P, _P, _I64, _I64, _I64, _I64, _P, _P,
                                _I64, _P],
    # (bases, firsts, count, rows, cols, is_int, ids, deltas, valid, lanes,
    #  workspace, ws_words, stream): per-shard lane arrays
    "mv_row_scatter_add_shards": [_P, _P, _I64, _I64, _I64, _I64, _P, _P,
                                  _P, _P, _P, _I64, _P],
    # (param, rows, cols, is_int, rows_ids, cols_ids, vals, valid, n,
    #  workspace, ws_words, stream)
    "mv_coo_scatter_add": [_P, _I64, _I64, _I64, _P, _P, _P, _P, _I64, _P,
                           _I64, _P],
    # (rows_ids, cols_ids, valid, n, R, C, workspace, ws_words, stream)
    "mv_coo_scatter_plan": [_P, _P, _P, _I64, _I64, _I64, _P, _I64, _P],
    # (bases, firsts, count, rows, cols, is_int, rows_ids, cols_ids, vals,
    #  valid, n, plan, stream)
    "mv_coo_scatter_add_mesh": [_P, _P, _I64, _I64, _I64, _I64, _P, _P, _P,
                                _P, _I64, _P, _P],
    # (bases, firsts, count, rows, cols, is_int, rows_ids, cols_ids, vals,
    #  valid, lanes, workspace, ws_words, stream): per-shard lane arrays
    "mv_coo_scatter_add_shards": [_P, _P, _I64, _I64, _I64, _I64, _P, _P,
                                  _P, _P, _P, _P, _I64, _P],
    # (A, a_int16, W, w_bf16, sinv, zi, msk, u1, u2, b, C, alpha, beta,
    #  znew, nkd, stream)
    "mv_gibbs_tiled": [_P, _I64, _P, _I64, _P, _P, _P, _P, _P, _I64, _I64,
                       _F, _F, _P, _P, _P],
    # (ndk or None, n_int16, W, w_bf16, words or None, V, sinv, zi, drel,
    #  msk, u1, u2, nb, tb, maxd, C, alpha, beta, znew, nkd, stream)
    "mv_gibbs_docblock": [_P, _I64, _P, _I64, _P, _I64, _P, _P, _P, _P, _P,
                          _P, _I64, _I64, _I64, _I64, _F, _F, _P, _P, _P],
    # (keys, firsts, count, nb, S, D, vtype, values, query, buckets, inv,
    #  L, zero_foreign, n, default, picked, found, stream): per-shard arrays
    "mv_kv_lookup": [_P, _P, _I64, _I64, _I64, _I64, _I64, _P, _P, _P, _P,
                     _I64, _I64, _I64, _F, _P, _P, _P],
    # (keys, count, nb, S, buckets, query, valid, lanes, slot, n_over,
    #  stream): per-shard arrays
    "mv_kv_probe": [_P, _I64, _I64, _I64, _P, _P, _P, _P, _P, _P, _P],
    # (keys, values, st_a, st_b, count, replicas, nb, S, D, q, vtype,
    #  buckets, query, deltas, lanes, slot, gate, code, s0..s7, stream):
    #  per-copy and per-shard arrays
    "mv_kv_commit": [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64,
                     _I64, _P, _P, _P, _P, _P, _P, _I64] + [_F] * 8
                    + [_P],
}


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "table kernels cannot be built")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"libmvtpu_torch_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library of this source hash exists;
    a real build is recorded as ``profile.compiles{fn=torch_kernels}``
    and its seconds."""
    global build_seconds, build_log
    so = library_path()
    if so.exists():
        build_seconds = 0.0
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    ts, t0 = time.time(), time.perf_counter()
    cu = [s for s in sources() if s.suffix == ".cu"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [os.path.join(work, s.stem + ".o") for s in cu]
        procs = [subprocess.Popen(
            [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c", "-Xcompiler",
             "-fPIC", "-Xptxas", "-v", "-o", obj, str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(cu, objs)]
        logs, failed = [], []
        for src, proc in zip(cu, procs):
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode})")
        tmp = os.path.join(work, "lib.so")
        if not failed:
            link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
                                   *objs], capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            if link.returncode != 0:
                failed.append(f"link ({link.returncode})")
        build_seconds = time.perf_counter() - t0
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n"
                               f"{build_log}")
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
    record_compile("torch_kernels", build_seconds, ts)
    return so


def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB
