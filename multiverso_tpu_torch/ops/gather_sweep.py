"""Time ``mv_row_gather_mesh`` with its tuning constants of
``csrc/row_kernels.cu`` changed, on one card.

Each variant is the source with some ``constexpr`` values replaced (the
lanes a warp takes ``kGatherLanes``, the units a thread loads before it
stores them ``kGatherLoads``, the warps a block ``kGatherWarps``; "base"
is the source as it stands, 4 lanes and 4 loads), built with ``nvcc``
into a library of its own (every build started at once), and called at
``chip_smoke.py`` phase 2's shapes: the word2vec table padded to 10,004 x 100 float32 on
four shards of one card, 24,576 and 4,096 Zipf-1.2 ids, in both lane forms
(global ids, as ``gather_rows_mesh`` takes them; the host-sliced (4, L)
local ids with ``inv``, as ``gather_rows_sharded`` does), beside the flat
``mv_row_gather`` on the table concatenated and ``index_select``. Every
variant must equal ``index_select`` bit for bit; a time is the mean of
CUDA events over 200 calls queued behind a spin kernel. Needs a card and
``nvcc``::

    python -m multiverso_tpu_torch.ops.gather_sweep [--json PATH]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from multiverso_tpu_torch.ops import _build
from multiverso_tpu_torch.ops import table_kernels as tk
from multiverso_tpu_torch.ops.scatter_sweep import device_ms, variant_source
from multiverso_tpu_torch.tables.hashing import shard_lane_slices

ROWS, DIM, SHARDS, SEED = 10_004, 100, 4, 0
# name: the constants it sets; "base" is the source as it stands
VARIANTS = {
    "base": {},
    "lanes32_loads8": {"kGatherLanes": 32, "kGatherLoads": 8},
    "lanes16_loads4": {"kGatherLanes": 16, "kGatherLoads": 4},
    "lanes8_loads8": {"kGatherLanes": 8, "kGatherLoads": 8},
    "lanes8_loads4": {"kGatherLanes": 8, "kGatherLoads": 4},
    "lanes8_loads2": {"kGatherLanes": 8, "kGatherLoads": 2},
    "lanes4_loads2": {"kGatherLanes": 4, "kGatherLoads": 2},
    "lanes4_loads1": {"kGatherLanes": 4, "kGatherLoads": 1},
    "lanes2_loads2": {"kGatherLanes": 2, "kGatherLoads": 2},
    "lanes2_loads1": {"kGatherLanes": 2, "kGatherLoads": 1},
    "lanes1_loads1": {"kGatherLanes": 1, "kGatherLoads": 1},
    "lanes4_loads2_warps4": {"kGatherLanes": 4, "kGatherLoads": 2,
                             "kGatherWarps": 4},
}


def build_all(work: str) -> dict:
    """Each variant's ``mv_row_gather_mesh``, all nvcc processes started
    together."""
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
             "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed\n{out}")
        fn = ctypes.CDLL(so).mv_row_gather_mesh
        fn.argtypes = _build._SIGNATURES["mv_row_gather_mesh"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def lane_forms(ids: np.ndarray, shards) -> dict:
    """The two lane forms of ``ids``: name -> (ids pointer array, inv
    pointer or None, L, the tensors to keep alive)."""
    rps = ROWS // SHARDS
    g = torch.as_tensor(ids, device="cuda")
    order = np.argsort(ids // rps, kind="stable")
    sh = ids[order] // rps
    local = (ids[order] - sh * rps).astype(np.int32)
    (sliced,), _, pos = shard_lane_slices(sh, SHARDS, [local],
                                          [np.int32(rps - 1)])
    inv = np.zeros(len(ids), np.int32)
    inv[order] = sh * sliced.shape[1] + pos
    lo = torch.as_tensor(sliced, device="cuda")
    iv = torch.as_tensor(inv, device="cuda")
    return {"global": (tk._c_ptrs([g]), None, 0, (g,)),
            "sliced": (tk._c_ptrs(list(lo)), iv.data_ptr(), lo.shape[1],
                       (lo, iv))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="write the times here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gather_sweep: no CUDA device", file=sys.stderr)
        return 2
    rng = np.random.default_rng(SEED)
    g = torch.Generator().manual_seed(SEED)
    whole = (torch.randn(ROWS, DIM, generator=g) * 0.05).cuda()
    shards = [b.contiguous() for b in whole.chunk(SHARDS)]
    table = tk._shard_table(shards, range(SHARDS), ROWS // SHARDS)
    out_ms = {}
    with tempfile.TemporaryDirectory() as work:
        fns = build_all(work)
        for n in (24_576, 4096):
            ids = np.clip(rng.zipf(1.2, n) - 1, 0, ROWS - 2).astype(np.int32)
            gids = torch.as_tensor(ids, device="cuda")
            want = whole.index_select(0, gids.long())
            out = torch.empty_like(want)
            for form, (ids_p, inv_p, lanes, _keep) in lane_forms(
                    ids, shards).items():
                row = {}
                for name, fn in fns.items():
                    def call():
                        err = fn(*table, ROWS // SHARDS, DIM, 4, ids_p,
                                 inv_p, lanes, 1, n, out.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"{name}: CUDA error {err}")
                    out.zero_()
                    call()
                    if not torch.equal(out, want):
                        raise SystemExit(f"{name} {form} n={n}: != "
                                         "index_select")
                    row[name] = device_ms(call)
                out_ms[f"{form}@{n}"] = row
            out_ms[f"flat@{n}"] = {
                "mv_row_gather": device_ms(lambda: tk.gather_rows(whole,
                                                                  gids)),
                "index_select": device_ms(lambda: whole.index_select(
                    0, gids.long()))}
            for key in (f"global@{n}", f"sliced@{n}", f"flat@{n}"):
                print(f"{key:14s} " + "  ".join(
                    f"{k} {v:.5f}" for k, v in out_ms[key].items()),
                    flush=True)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"ms a call on {SHARDS} shards of one card, every variant equal "
          f"to index_select bit for bit; {gpu}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": gpu, "variants": VARIANTS, "ms": out_ms}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
