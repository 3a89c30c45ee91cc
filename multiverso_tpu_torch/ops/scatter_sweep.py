"""Time ``mv_row_scatter_add`` with one tuning constant of
``csrc/row_kernels.cu`` changed at a time, on one card.

Each variant is the source with one or two ``constexpr`` values replaced
(the run split ``kSplit``, the ring's depth ``kStages`` and rows
``kStageRows``, the long-run blocks an SM holds ``kLongBlocksPerSM``, the
add batch ``kBatch``, the short-run load depth ``kShortLoads``, the
column slice ``kSliceBytes``), built with ``nvcc`` with ``row_plan.cu``
into a library of its own (every build started at once), and called on
``chip_smoke.py`` phase 2's row-scatter cases in request order (the whole
call: the plan, then the scatter along it): 4,096 and 24,576 Zipf-1.2
ids and 24,576 lanes of one id into the 10,001 x 100 float32 word2vec
table, and 24,576 uniform ids. Every variant must equal
the plain version on the CPU bit for bit; its time is the mean of CUDA
events over 200 calls queued behind a spin kernel, beside ``index_add_``
on the same lanes. Needs a card and ``nvcc``::

    python -m multiverso_tpu_torch.ops.scatter_sweep [--json PATH]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

from multiverso_tpu_torch.ops import _build
from multiverso_tpu_torch.ops import table_kernels as tk

ROWS, DIM, SEED = 10_001, 100, 0
# name: the constants it sets; "base" is the source as it stands (a ring
# deeper than 2 stages of 512 rows outgrows the 48 KB of shared memory)
VARIANTS = {
    "base": {},
    "split64": {"kSplit": 64},
    "split128": {"kSplit": 128},
    "split256": {"kSplit": 256},
    "stages3_rows256": {"kStages": 3, "kStageRows": 256},
    "stages4_rows256": {"kStages": 4, "kStageRows": 256},
    "rows128": {"kStageRows": 128},
    "rows256": {"kStageRows": 256},
    "resident8": {"kLongBlocksPerSM": 8},
    "batch8": {"kBatch": 8},
    "batch32": {"kBatch": 32},
    "short4": {"kShortLoads": 4},
    "short16": {"kShortLoads": 16},
    "slice16": {"kSliceBytes": 16},
    "slice64_rows256": {"kSliceBytes": 64, "kStageRows": 256},
}
SPIN_CYCLES = 50_000_000  # about 30 ms at the H100's clock


def variant_source(text: str, consts: dict) -> str:
    for name, value in consts.items():
        text, hits = re.subn(rf"(constexpr int(?:64_t)? {name} = )\d+;",
                             rf"\g<1>{value};", text)
        if hits != 1:
            raise ValueError(f"{name}: {hits} definitions in row_kernels.cu")
    return text


def build_all(work: str) -> dict:
    """One library per variant, all nvcc processes started together."""
    src = (_build.CSRC / "row_kernels.cu").read_text()
    procs = {}
    for name, consts in VARIANTS.items():
        cu = os.path.join(work, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(src, consts))
        so = os.path.join(work, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-I", str(_build.CSRC),
             "-o", so, cu, str(_build.CSRC / "row_plan.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed\n{out}")
        fn = ctypes.CDLL(so).mv_row_scatter_add
        fn.argtypes = _build._SIGNATURES["mv_row_scatter_add"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def cases(rng) -> dict:
    def zipf(n):
        return np.clip(rng.zipf(1.2, size=n) - 1, 0, ROWS - 2)
    n = 24_576
    return {"zipf4096": zipf(4096), "zipf24576": zipf(n),
            "one24576": np.zeros(n, np.int64),
            "uniform24576": rng.integers(0, ROWS - 1, n)}


def device_ms(fn, iters: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="write the times here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scatter_sweep: no CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as work:
        libs = build_all(work)
        rng = np.random.default_rng(SEED)
        g = torch.Generator().manual_seed(SEED)
        param0 = torch.randn(ROWS, DIM, generator=g) * 0.05
        table = {}
        for case, ids_h in cases(rng).items():
            n = len(ids_h)
            deltas_h = torch.randn(n, DIM, generator=g)
            ids = torch.as_tensor(ids_h, dtype=torch.int32, device="cuda")
            deltas = deltas_h.cuda()
            want = tk.row_scatter_add_plain(param0.clone(),
                                            torch.as_tensor(ids_h), deltas_h)
            ws = torch.zeros(tk.scatter_workspace_size(n), dtype=torch.int64,
                             device="cuda")
            row = {"longest_run": int(np.bincount(ids_h).max())}
            for name, fn in libs.items():
                p = param0.cuda()

                def call():
                    err = fn(p.data_ptr(), ROWS, DIM, 0, ids.data_ptr(), 0,
                             deltas.data_ptr(), None, n,
                             ws.data_ptr(), ws.numel(),
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                call()
                if not torch.equal(p.cpu(), want):
                    raise SystemExit(f"{name} {case}: kernel != plain "
                                     "version on the CPU")
                row[name] = device_ms(call)
            lib_t = param0.cuda()
            row["index_add_"] = device_ms(
                lambda: lib_t.index_add_(0, ids, deltas))
            table[case] = row
            print(f"{case:13s} longest run {row['longest_run']:6d}  "
                  + "  ".join(f"{k} {v:.4f}" for k, v in row.items()
                              if k != "longest_run"), flush=True)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"ms of a call (plan and scatter), bit-identical to the CPU "
          f"plain version in every variant; {gpu}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": gpu, "variants": VARIANTS, "ms": table}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
