"""Time ``mv_kv_probe`` with the threads it gives a lane changed, on one
card.

Each variant is ``csrc/kv_kernels.cu`` with ``kLaneThreads`` (the threads
that take a lane, each holding ``kChunk / kLaneThreads`` slots of a
16-slot chunk of the key row) replaced, built with ``nvcc`` into a
library of its own (every build started at once), and called on the
sparse-LR step's lanes of ``chip_smoke.py`` phase 2: 159,000 keys, half
of them already in a 2^25-slot ftrl table (value_dim 2), the batch laid
out by ``KVTable.prepare_add`` and launched on its real lanes; at 16
slots a bucket (the sparse-LR table's) and at 8 (the KVTable default).
Every variant's probe + commit must leave the keys, values and state
bit-identical to the plain version on the CPU; its times are the probe
alone and the probe + commit (the batch applied again and again: every
key matches after the first), the mean of CUDA events over calls queued
behind a spin kernel. The shapes and the key recipe are
``chip_smoke.py``'s, so the sweep imports it: run it from the root of the
repo. Needs a card and ``nvcc``::

    python -m multiverso_tpu_torch.ops.kv_sweep [--json PATH]
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

from chip_smoke import KV_REAL, SLR_CAPACITY, cuda_ms, kv_keys
from multiverso_tpu_torch.ops import _build
from multiverso_tpu_torch.ops import table_kernels as tk
from multiverso_tpu_torch.ops.coo_sweep import variant_source

SEED = 11
SLOTS = (16, 8)
# name: the constants it sets; "base" is the source as it stands
VARIANTS = {
    "base": {},
    "lane1": {"kLaneThreads": 1},
    "lane2": {"kLaneThreads": 2},
    "lane8": {"kLaneThreads": 8},
    "lane16": {"kLaneThreads": 16},
}


def build_all(work: str) -> dict:
    """One library per variant, all nvcc processes started together:
    {name: (mv_kv_probe, mv_kv_commit)}."""
    src = (_build.CSRC / "kv_kernels.cu").read_text()
    procs = {}
    for name, consts in VARIANTS.items():
        cu = os.path.join(work, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(src, consts, "kv_kernels.cu"))
        so = os.path.join(work, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-I", str(_build.CSRC),
             "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed\n{out}")
        lib = ctypes.CDLL(so)
        pair = []
        for fn_name in ("mv_kv_probe", "mv_kv_commit"):
            fn = getattr(lib, fn_name)
            fn.argtypes = _build._SIGNATURES[fn_name]
            fn.restype = ctypes.c_int
            pair.append(fn)
        libs[name] = tuple(pair)
    return libs


def case(slots: int):
    """(table triple on the card, the batch's lane operands on the card,
    real lanes, option): a 2^25-slot ftrl table at value_dim 2 holding
    half of the batch's keys."""
    from multiverso_tpu_torch.tables import KVTable
    rng = np.random.default_rng(SEED)
    keys = kv_keys(rng, KV_REAL)
    t = KVTable(SLR_CAPACITY, value_dim=2, slots_per_bucket=slots,
                updater="ftrl", device="cuda", name=f"kv_sweep_{slots}")
    present = keys[:KV_REAL // 2]
    t.add(present, rng.standard_normal((len(present), 2)).astype(
        np.float32))
    t.wait()
    prep = t.prepare_add(keys, rng.standard_normal((KV_REAL, 2)).astype(
        np.float32))
    lanes = tuple(x[0] for x in (prep.buckets, prep.query, prep.deltas,
                                 prep.valid))
    triple = (t.keys.clone(), t.values.clone(),
              {k: v.clone() for k, v in t.state.items()})
    return triple, lanes, int(prep.counts[0]), prep.option


def launches(fns, triple, lanes, real, option):
    """(probe alone, probe + commit) as calls of the variant's entry
    points on ``triple`` (changed in place by the pair)."""
    probe_fn, commit_fn = fns
    keys, values, state = triple
    b, q, d, ok = lanes
    leaves = [state["z"], state["n"]]
    slot = torch.empty(real, dtype=torch.int32, device="cuda")
    count = torch.zeros(1, dtype=torch.int32, device="cuda")
    one = lambda t: tk._c_ptrs([t])
    real_arr = tk._c_array(ctypes.c_int64, [real])
    scalars = tk._kv_scalars("ftrl", option)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def probe():
        err = probe_fn(one(keys), 1, keys.shape[0], keys.shape[1], one(b),
                       one(q), one(ok), real_arr, slot.data_ptr(),
                       count.data_ptr(), stream())
        if err:
            raise RuntimeError(f"mv_kv_probe: CUDA error {err}")

    def pair():
        count.zero_()
        probe()
        # one replica, its state whole, float32 values
        err = commit_fn(one(keys), one(values), one(leaves[0]),
                        one(leaves[1]), 1, 1, keys.shape[0], keys.shape[1],
                        2, keys.shape[0], 0, one(b), one(q), one(d),
                        real_arr, slot.data_ptr(), count.data_ptr(),
                        tk.KV_UPDATERS["ftrl"], *scalars, stream())
        if err:
            raise RuntimeError(f"mv_kv_commit: CUDA error {err}")

    return probe, pair


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="write the times here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kv_sweep: no CUDA device", file=sys.stderr)
        return 2
    table = {}
    with tempfile.TemporaryDirectory() as work:
        libs = build_all(work)
        for slots in SLOTS:
            triple, lanes, real, option = case(slots)
            cpu = [x.cpu() for x in lanes]
            want = tk.kv_probe_update_plain(
                triple[0].cpu(), triple[1].cpu(),
                {k: v.cpu() for k, v in triple[2].items()}, *cpu, option,
                "ftrl")
            row = {"real": real}
            for name, fns in libs.items():
                mine = (triple[0].clone(), triple[1].clone(),
                        {k: v.clone() for k, v in triple[2].items()})
                probe, pair = launches(fns, mine, lanes, real, option)
                pair()
                torch.cuda.synchronize()
                same = (torch.equal(mine[0].cpu(), want[0])
                        and torch.equal(mine[1].cpu().view(torch.int32),
                                        want[1].view(torch.int32))
                        and all(torch.equal(
                            mine[2][k].cpu().view(torch.int32),
                            want[2][k].view(torch.int32)) for k in want[2]))
                if not same:
                    raise SystemExit(f"{name} S={slots}: kernel != plain "
                                     "version on the CPU")
                row[name] = {"probe_ms": cuda_ms(probe, 50),
                             "pair_ms": cuda_ms(pair, 50)}
                del mine
            table[f"S{slots}"] = row
            print(f"S {slots:2d}, {real} real lanes: " + "  ".join(
                f"{k} probe {v['probe_ms']:.4f} pair {v['pair_ms']:.4f}"
                for k, v in row.items() if k != "real"), flush=True)
            del triple, lanes, want
            torch.cuda.empty_cache()
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"ms of the probe and of the probe + commit, bit-identical to "
          f"the CPU plain version in every variant; {gpu}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": gpu, "variants": VARIANTS, "ms": table}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
