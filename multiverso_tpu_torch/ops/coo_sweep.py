"""Time ``mv_coo_scatter_add`` with one tuning constant of
``csrc/coo_kernels.cu`` or ``csrc/row_plan.cuh`` changed at a time, on
one card.

Each variant is the sources with one or two ``constexpr`` values replaced,
built with ``nvcc`` into a library of its own (every build started at
once). The int32 variants (threads a block ``kThreads``, resident blocks
an SM ``kBlocksPerSM``, lanes a thread loads at once ``kVec``, the block's
shared table ``kHashBits``) are called on LightLDA's lanes into a zero
[50,001, 1024] int32 word table: ``chip_smoke.py`` phase 2's 512,000 Zipf-1.1
(word, uniform topic, 97% 1) lanes in request order and sorted by word
with a mask (the masked form), and the sweep-end rebuild's 10M token
lanes (``chip_smoke.rebuild_lanes``: Zipf-1.1 words in token order, a
0/1 mask as the value) with uniform topics (the rebuild of an initial z),
with skewed topics, and with the z that LightLDA's doc-blocked sweep
samples (``chip_smoke.py`` phase 6's app and corpus, after
``SAMPLED_SWEEPS`` sweeps: the rebuild it really makes). The float32
variants (``--float``: the walk's lanes a batch ``kWalkBatch``, its
blocks an SM ``kWalkBlocksPerSM``, the plan's look-back window
``kLookBack`` and lanes a thread ``kPlanItems``) are called on phase 2's
512,000 Zipf-1.1 lanes with float32 values into a [50,001, 1024] float32
table, in request order, row-sorted with a mask, and all on one element;
the plan alone (``mv_coo_scatter_plan``) is timed beside each. The
shapes and the data recipes are ``chip_smoke.py``'s, so the sweep imports
it: run it from the root of the repo. Every variant must equal the plain
version on the CPU bit for bit; its time is the mean of CUDA events over
calls queued behind a spin kernel, beside ``index_add_`` on the flat
indices. Needs a card and ``nvcc``::

    python -m multiverso_tpu_torch.ops.coo_sweep [--float] [--json PATH]
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

from chip_smoke import (LDA_B, LDA_D, LDA_K, LDA_T, LDA_V, rebuild_lanes,
                        zipf_lda_corpus, zipf_words)
from multiverso_tpu_torch.ops import _build
from multiverso_tpu_torch.ops import table_kernels as tk

V, D, K, B, T = LDA_V, LDA_D, LDA_K, LDA_B, LDA_T
SEED = 0
SAMPLED_SWEEPS = 4
# name: the constants it sets; "base" is the source as it stands
VARIANTS = {
    "base": {},
    "no_table": {"kHashBits": 0},
    "hash10": {"kHashBits": 10},
    "hash12": {"kHashBits": 12},
    "vec1": {"kVec": 1},
    "blocks2": {"kBlocksPerSM": 2},
    "blocks4": {"kBlocksPerSM": 4},
    "threads512_blocks4": {"kThreads": 512, "kBlocksPerSM": 4},
    "threads128_blocks16": {"kThreads": 128, "kBlocksPerSM": 16},
}
# float32: name -> {source file: the constants it sets}
FLOAT_VARIANTS = {
    "base": {},
    "walk4": {"coo_kernels.cu": {"kWalkBatch": 4}},
    "walk16": {"coo_kernels.cu": {"kWalkBatch": 16}},
    "walk_blocks4": {"coo_kernels.cu": {"kWalkBlocksPerSM": 4}},
    "lookback16": {"row_plan.cuh": {"kLookBack": 16}},
    "lookback32": {"row_plan.cuh": {"kLookBack": 32}},
    "items8": {"row_plan.cuh": {"kPlanItems": 8}},
    "items16": {"row_plan.cuh": {"kPlanItems": 16}},
}
SPIN_CYCLES = 50_000_000  # about 30 ms at the H100's clock


def sampled_lanes(n_sweeps: int = SAMPLED_SWEEPS):
    """(words, topics, mask) of the rebuild that LightLDA's doc-blocked
    sweep makes after ``n_sweeps`` sweeps at ``chip_smoke.py`` phase 6's
    width, corpus (seed 0) and app seed (1), as host arrays."""
    from multiverso_tpu_torch.apps.lightlda import LDAConfig, LightLDA
    tw, td = zipf_lda_corpus(V, D, T, seed=0)
    app = LightLDA(tw, td, V, LDAConfig(
        num_topics=K, batch_tokens=B, steps_per_call=1, seed=1,
        sampler="tiled", stale_words=True, doc_blocked=True),
        device="cuda", name="coo_sweep_lda")
    for _ in range(n_sweeps):
        app.sweep()
    return tuple(x.reshape(-1).cpu().numpy()
                 for x in (app._tw, app._z, app._mask))


def variant_source(text: str, consts: dict,
                   source: str = "coo_kernels.cu") -> str:
    """``text`` (the source ``source``) with each ``constexpr int`` of
    ``consts`` set to its value."""
    for name, value in consts.items():
        text, hits = re.subn(rf"(constexpr int {name} = )\d+;",
                             rf"\g<1>{value};", text)
        if hits != 1:
            raise ValueError(f"{name}: {hits} definitions in {source}")
    return text


def build_all(work: str, variants: dict) -> dict:
    """One library per variant (its own copy of the sources, each
    ``{file: constants}`` of it applied), all nvcc processes started
    together: {name: the library}."""
    procs = {}
    for name, files in variants.items():
        src = os.path.join(work, name)
        os.makedirs(src)
        for path in _build.sources():
            text = path.read_text()
            if path.name in files:
                text = variant_source(text, files[path.name], path.name)
            with open(os.path.join(src, path.name), "w") as f:
                f.write(text)
        so = os.path.join(work, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-o", so,
             os.path.join(src, "coo_kernels.cu"),
             os.path.join(src, "row_plan.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed\n{out}")
        lib = ctypes.CDLL(so)
        for fn in ("mv_coo_scatter_add", "mv_coo_scatter_plan"):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def cases(rng) -> dict:
    """name: (rows, cols, vals, valid or None) as int32 numpy lanes."""
    w = zipf_words(rng, V, B)
    z = rng.integers(0, K, B).astype(np.int32)
    ones = (rng.random(B) < 0.97).astype(np.int32)
    order = np.argsort(w, kind="stable")
    keep = (rng.random(B) < 0.9).astype(np.int32)
    return {"call512k": (w, z, ones, None),
            "masked512k_sorted": (w[order], z[order], ones[order], keep),
            "rebuild10M_uniform": (*rebuild_lanes(rng, V, K, T, False),
                                   None),
            "rebuild10M_skewed": (*rebuild_lanes(rng, V, K, T, True), None),
            "rebuild10M_sampled": (*sampled_lanes(), None)}


def device_ms(fn, iters: int) -> float:
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


def float_sweep(work: str) -> dict:
    """The float32 variants on phase 2's lanes: {case: {variant: ms}}."""
    libs = build_all(work, FLOAT_VARIANTS)
    rng = np.random.default_rng(5)
    rows = V + 1
    w = zipf_words(rng, V, B)
    z = rng.integers(0, K, B).astype(np.int32)
    f = rng.standard_normal(B).astype(np.float32)
    order = np.argsort(w, kind="stable")
    keep = rng.random(B) < 0.9
    one = np.full(B, V // 2, np.int32)
    cases = {"call512k": (w, z, f, None),
             "masked512k_sorted": (w[order], z[order], f[order], keep),
             "one_element512k": (one, np.full(B, K - 1, np.int32), f, None)}
    # room for any variant's layout: the widest tile's look-back rows too
    ws = torch.zeros(2 * tk.scatter_workspace_size(B, "coo"),
                     dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    table = {}
    for case, (r_h, c_h, v_h, ok_h) in cases.items():
        host = [torch.from_numpy(x) for x in (r_h, c_h, v_h)]
        ok = None if ok_h is None else torch.from_numpy(ok_h)
        p0 = torch.zeros(rows, K)
        want = (tk.coo_scatter_add_plain(p0.clone(), *host) if ok is None
                else tk.coo_scatter_add_masked_plain(p0.clone(), *host, ok))
        r, c, v = (x.cuda() for x in host)
        ok_d = None if ok is None else ok.cuda()
        okp = None if ok_d is None else ok_d.data_ptr()
        p = torch.zeros(rows, K, device="cuda")
        row = {}
        iters = 3 if case.startswith("one") else 20
        for name, lib in libs.items():
            def call(lib=lib):
                err = lib.mv_coo_scatter_add(
                    p.data_ptr(), rows, K, 0, r.data_ptr(), c.data_ptr(),
                    v.data_ptr(), okp, B, ws.data_ptr(), ws.numel(), stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            def plan(lib=lib):
                err = lib.mv_coo_scatter_plan(
                    r.data_ptr(), c.data_ptr(), okp, B, rows, K,
                    ws.data_ptr(), ws.numel(), stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            p.zero_()
            call()
            if not torch.equal(p.cpu().view(torch.int32),
                               want.view(torch.int32)):
                raise SystemExit(f"{name} {case}: kernel != plain version "
                                 "on the CPU")
            row[name] = device_ms(call, iters)
            row[name + ":plan"] = device_ms(plan, iters)
        table[case] = row
        print(f"{case:20s} " + "  ".join(f"{k} {x:.4f}"
                                         for k, x in row.items()),
              flush=True)
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="write the times here as JSON")
    ap.add_argument("--float", action="store_true",
                    help="the float32 path's variants")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("coo_sweep: no CUDA device", file=sys.stderr)
        return 2
    if args.float:
        with tempfile.TemporaryDirectory() as work:
            table = float_sweep(work)
        return report(args, table, FLOAT_VARIANTS, "the float32 call "
                      "(and its plan alone)")
    rows = V + 1
    with tempfile.TemporaryDirectory() as work:
        libs = {name: lib.mv_coo_scatter_add for name, lib in
                build_all(work, {k: {"coo_kernels.cu": v}
                                 for k, v in VARIANTS.items()}).items()}
        rng = np.random.default_rng(SEED)
        table = {}
        for case, lanes_h in cases(rng).items():
            r_h, c_h, v_h, ok_h = lanes_h
            n = len(r_h)
            host = [torch.from_numpy(x) for x in (r_h, c_h, v_h)]
            if ok_h is None:
                want = tk.coo_scatter_add_plain(
                    torch.zeros(rows, K, dtype=torch.int32), *host)
            else:
                want = tk.coo_scatter_add_masked_plain(
                    torch.zeros(rows, K, dtype=torch.int32), *host,
                    torch.from_numpy(ok_h))
            r, c, v = (x.cuda() for x in host)
            # the kernel's mask: a byte a lane
            ok = None if ok_h is None else torch.from_numpy(ok_h != 0).cuda()
            iters = 50 if n <= B else 10
            flat = want.view(-1)
            row = {"n": n, "touched": int(torch.count_nonzero(flat)),
                   "sectors": int(torch.count_nonzero(
                       flat.view(-1, 8).abs().sum(1)))}
            # bounds at 3.35 TB/s: bytes (lanes x 12, touched elements
            # read and written), and 32-byte sectors read and written
            row["bound_ms"] = (n * 12 + 8 * row["touched"]) / 3.35e9
            row["sector_bound_ms"] = (n * 12 + 64 * row["sectors"]) / 3.35e9
            p = torch.zeros(rows, K, dtype=torch.int32, device="cuda")
            for name, fn in libs.items():
                def call():
                    err = fn(p.data_ptr(), rows, K, 1, r.data_ptr(),
                             c.data_ptr(), v.data_ptr(),
                             None if ok is None else ok.data_ptr(), n, None,
                             0, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                p.zero_()
                call()
                if not torch.equal(p.cpu(), want):
                    raise SystemExit(f"{name} {case}: kernel != plain "
                                     "version on the CPU")
                row[name] = device_ms(call, iters)
            idx = r.long() * K + c.long()
            vals = v if ok is None else v * ok
            row["index_add_"] = device_ms(
                lambda: p.view(-1).index_add_(0, idx, vals), iters)
            table[case] = row
            print(f"{case:20s} n {n:9d} touched {row['touched']:9d} sectors "
                  f"{row['sectors']:9d}  "
                  + "  ".join(f"{k} {x:.4f}" for k, x in row.items()
                              if k not in ("n", "touched", "sectors")),
                  flush=True)
            del p, r, c, v, ok, want
    return report(args, table, VARIANTS, "the int32 kernel")


def report(args, table: dict, variants: dict, what: str) -> int:
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"ms of {what} on each case's lanes, bit-identical to the CPU "
          f"plain version in every variant; {gpu}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": gpu, "variants": variants, "ms": table}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
