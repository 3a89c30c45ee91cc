"""Build the native data library from ``data/csrc/mvtpu_data.cpp``.

The source is compiled with ``g++`` (``-O3 -std=c++17 -fPIC -shared
-pthread``, plus ``-march=x86-64-v2`` where the compiler takes it: a
portable baseline, since the library may load on another host than the
one that built it) into ``build/torch_kernels/`` at the root of the
checkout, named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads the cached library. Each
build compiles into a directory of its own and publishes the library with
``os.replace``, so concurrent builds (test workers) never see a partial
file. A failed build raises with the compiler's output: there is no
fallback to the Python backend.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List

from multiverso_tpu_torch.telemetry.profiling import record_compile

SOURCE = Path(__file__).resolve().parent / "csrc" / "mvtpu_data.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
CXX = "g++"
BASE_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

#: seconds the last build took (0.0 when the cached library was found)
build_seconds = 0.0


def flags() -> List[str]:
    """The compile flags: the base set, and ``-march=x86-64-v2`` when the
    compiler accepts it (as ``native/Makefile`` probes)."""
    probe = subprocess.run(
        [CXX, "-march=x86-64-v2", "-E", "-x", "c++", os.devnull],
        capture_output=True)
    return BASE_FLAGS + (["-march=x86-64-v2"] if probe.returncode == 0
                         else [])


def library_path(cflags: List[str]) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join([CXX] + cflags).encode())
    return BUILD_DIR / f"libmvtpu_data_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless a library of this hash exists; returns
    its path. Raises ``RuntimeError`` with g++'s output on failure. A
    real build is recorded as ``profile.compiles{fn=mvtpu_data}`` and its
    seconds."""
    global build_seconds
    cflags = flags()
    so = library_path(cflags)
    if so.exists():
        build_seconds = 0.0
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    ts, t0 = time.time(), time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        tmp = os.path.join(work, so.name)
        proc = subprocess.run([CXX, *cflags, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"{CXX} failed ({proc.returncode}) building {SOURCE}:\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
    record_compile("mvtpu_data", build_seconds, ts)
    return so
