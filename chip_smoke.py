#!/usr/bin/env python3
"""Drive multiverso_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py             # the whole check, about a minute
    python3 chip_smoke.py --profile   # also a torch.profiler window on one
                                      # word2vec call (where the time goes)

Phases (any failure ends the run with a non-zero exit code):

1. Device: the card's name and power limit; build the CUDA kernels from
   the sources in this checkout (``multiverso_tpu_torch/ops/csrc``).
2. Kernels vs plain: each kernel against its plain PyTorch version on the
   card, at the word2vec path's shapes (table 10,001 x 100; 4,096 and
   24,576 Zipf-1.2 ids), with its time, the plain version's, one PyTorch
   library call's and the least time the card could take (bound). Then
   a small word2vec run on the card against the same run on the CPU
   (plain versions), from the same weights and negatives.
3. Table Get/Add: MatrixTable add_rows / get_rows with duplicate ids under
   the default, sgd and adagrad updaters, against numpy.
4. word2vec at the bench's width (synthetic Zipf corpus of 1M tokens and
   vocab 10k, dim 100, window 5, 5 negatives, subsample 1e-3, batch 4096,
   512 steps per call): one warm-up call and two timed calls of skip-gram
   negative sampling. The loss must fall and stay finite, and both
   kernels' launch counts must rise by the expected count per step.

Launch counts are set to 0 after phase 2 and read after phase 4, so they
count the main path (phases 3 and 4) only. Before the last line the
script prints one ``{"kernels": [...]}`` JSON line and the card's name
and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# the H100 SXM's published peaks (NVIDIA data sheet): HBM3 bytes/s and
# float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# about 30 ms of spinning at the H100's clock: longer than the host takes
# to queue one timed loop
SPIN_CYCLES = 50_000_000

ROWS, DIM = 10_001, 100          # w2v table: vocab 10k + the scratch row
VOCAB, TOKENS = 10_000, 1_000_000
WINDOW, NEGATIVE, SUBSAMPLE = 5, 5, 1e-3
BATCH, STEPS = 4096, 512
# bench.py's learning rate: at batch 4096 the summed duplicate-row
# gradients of the frequent words diverge at word2vec's usual 0.025, in
# the JAX package as in this one
LR = 0.01
TIMED_CALLS = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    after one warm-up call (CUDA events). A spin kernel ahead of the
    first event holds the device while the host queues the calls, so the
    events time the device and not the Python wrapper's enqueue rate."""
    import torch
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


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def zipf_ids(rng, n: int, rows: int):
    return np.clip(rng.zipf(1.2, size=n) - 1, 0, rows - 2).astype(np.int32)


def scatter_tolerance(torch, param, ids, deltas, valid=None):
    """Elementwise bound on the difference of two float32 sums of the same
    terms in different orders: 2 * m * 2^-24 * (|row| + sum |delta|) for
    a row that receives m deltas."""
    ids = ids.long()
    if valid is not None:
        keep = valid != 0
        ids, deltas = ids[keep], deltas[keep]
    mag = param.abs().clone().index_add_(0, ids, deltas.abs())
    m = torch.bincount(ids, minlength=param.shape[0]).to(param.dtype)
    return 2.0 * m[:, None] * 2.0 ** -24 * mag


def phase_kernels(torch, tk, rng) -> list:
    """Phase 2: each kernel vs its plain version; returns the JSON rows."""
    dev = "cuda"
    g = torch.Generator(device="cpu").manual_seed(0)
    param0 = (torch.randn(ROWS, DIM, generator=g) * 0.05).to(dev)
    rows = []
    results = {}
    for n in (4096, BATCH * (1 + NEGATIVE)):
        ids = torch.as_tensor(zipf_ids(rng, n, ROWS), device=dev)
        uniq = int(torch.unique(ids).numel())
        # gather: exact
        got = tk.gather_rows(param0, ids)
        want = tk.gather_rows_plain(param0, ids)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise SystemExit(f"row_gather n={n}: kernel != plain "
                             f"(max abs err {err})")
        ms = cuda_ms(lambda: tk.gather_rows(param0, ids), 200)
        plain = cuda_ms(lambda: tk.gather_rows_plain(param0, ids), 200)
        lib = cuda_ms(lambda: param0.index_select(0, ids), 200)
        b, by = bound_ms(n * 4 + uniq * DIM * 4 + n * DIM * 4, 0)
        results[("row_gather", n)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
            bound_ms=b, bound_by=by, n=n, unique_rows=uniq)

        # scatter-add (ids in any order): against the plain version on the
        # card (index_add_ with atomics: float32 sum order) within the sum
        # bound, and against the plain version on the CPU, which adds in
        # the kernel's order: exact
        deltas = torch.randn(n, DIM, generator=g).to(dev)
        p_k, p_p = param0.clone(), param0.clone()
        tk.row_scatter_add(p_k, ids, deltas)
        tk.row_scatter_add_plain(p_p, ids, deltas)
        torch.cuda.synchronize()
        err = float((p_k - p_p).abs().max())
        tol = scatter_tolerance(torch, param0, ids, deltas)
        if not bool(((p_k - p_p).abs() <= tol).all()):
            raise SystemExit(f"row_scatter_add n={n}: kernel vs plain "
                             f"beyond the float32 sum bound (max {err})")
        p_c = tk.row_scatter_add_plain(param0.cpu(), ids.cpu(),
                                       deltas.cpu())
        if not torch.equal(p_k.cpu(), p_c):
            raise SystemExit(f"row_scatter_add n={n}: kernel != plain "
                             "version on the CPU (same sum order)")
        p_t = param0.clone()
        ms = cuda_ms(lambda: tk.row_scatter_add(p_t, ids, deltas), 200)
        plain = cuda_ms(lambda: tk.row_scatter_add_plain(p_t, ids, deltas),
                        200)
        lib = cuda_ms(lambda: p_t.index_add_(0, ids, deltas), 200)
        b, by = bound_ms(n * 4 + n * DIM * 4 + 2 * uniq * DIM * 4, n * DIM)
        results[("row_scatter_add", n)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
            bound_ms=b, bound_by=by, n=n, unique_rows=uniq)

        # masked scatter-add over sorted ids (the table's add_rows form)
        sids = torch.sort(ids).values
        valid = torch.as_tensor(rng.random(n) < 0.9, device=dev)
        nv = int(valid.sum())
        uniq_v = int(torch.unique(sids[valid]).numel())
        p_k, p_p = param0.clone(), param0.clone()
        tk.row_scatter_add_masked(p_k, sids, deltas, valid)
        tk.row_scatter_add_masked_plain(p_p, sids, deltas, valid)
        torch.cuda.synchronize()
        err = float((p_k - p_p).abs().max())
        tol = scatter_tolerance(torch, param0, sids, deltas, valid)
        if not bool(((p_k - p_p).abs() <= tol).all()):
            raise SystemExit(f"row_scatter_add_masked n={n}: kernel vs "
                             f"plain beyond the float32 sum bound ({err})")
        p_c = tk.row_scatter_add_masked_plain(
            param0.cpu(), sids.cpu(), deltas.cpu(), valid.cpu())
        if not torch.equal(p_k.cpu(), p_c):
            raise SystemExit(f"row_scatter_add_masked n={n}: kernel != "
                             "plain version on the CPU (same sum order)")
        p_t = param0.clone()
        ms = cuda_ms(lambda: tk.row_scatter_add_masked(p_t, sids, deltas,
                                                       valid), 200)
        plain = cuda_ms(lambda: tk.row_scatter_add_masked_plain(
            p_t, sids, deltas, valid), 200)
        b, by = bound_ms(n * 8 + nv * DIM * 4 + 2 * uniq_v * DIM * 4,
                         nv * DIM)
        results[("row_scatter_add_masked", n)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None,
            bound_ms=b, bound_by=by, n=n, unique_rows=uniq_v)
    for (name, n), r in results.items():
        log(f"  {name:24s} n={n:6d} rows={r['unique_rows']:5d} "
            f"kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
            f"library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} ms  "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
            f"max|err| {r['max_abs_err']:.3g}")
    return results


def w2v_small_parity(torch, Corpus, synthetic_text, W2VConfig,
                     WordEmbedding, tmp) -> None:
    """word2vec on the card vs on the CPU (plain versions): same corpus,
    weights, pairs and negatives; skip-gram NS and CBOW HS."""
    path = os.path.join(tmp, "small.txt")
    synthetic_text(path, num_tokens=40_000, vocab_size=500, seed=3)
    for model, objective in (("skipgram", "ns"), ("cbow", "hs")):
        corpus = Corpus.from_file(path, min_count=1, subsample=1e-3)
        cfg = W2VConfig(embedding_dim=DIM, window=WINDOW, negative=NEGATIVE,
                        model=model, objective=objective, batch_size=256,
                        steps_per_call=4, learning_rate=0.025, seed=3)
        apps = [WordEmbedding(corpus, cfg, device=d) for d in ("cuda", "cpu")]
        it = (corpus.skipgram_batches(256, window=WINDOW, seed=3)
              if model == "skipgram" else
              corpus.cbow_batches(256, window=WINDOW, seed=3,
                                  pad_id=apps[0]._scratch))
        batches = [next(it) for _ in range(8)]
        for call in range(2):
            src = np.stack([b[0] for b in batches[4 * call:4 * call + 4]])
            tgt = np.stack([b[1] for b in batches[4 * call:4 * call + 4]])
            negs = apps[0].negatives(call, 4).cpu() \
                if objective == "ns" else None
            losses = [float(a._dispatch(src, tgt, call, 2, negatives=negs))
                      for a in apps]
        torch.cuda.synchronize()
        for key in ("w_in", "w_out"):
            a, b = (getattr(x, key).get() for x in apps)
            if not np.allclose(a, b, rtol=1e-5, atol=1e-6):
                raise SystemExit(f"w2v {model}/{objective}: {key} on the "
                                 f"card differs from the CPU run "
                                 f"(max {np.abs(a - b).max()})")
        if not np.isclose(losses[0], losses[1], rtol=1e-5):
            raise SystemExit(f"w2v {model}/{objective}: loss {losses}")
        log(f"  w2v {model}/{objective} card vs CPU: w_in, w_out within "
            f"rtol 1e-5 atol 1e-6; loss {losses[0]:.6f} vs {losses[1]:.6f}")


def phase_tables(torch, MatrixTable, AddOption, rng) -> None:
    """Phase 3: Get/Add round trips against numpy."""
    for updater in ("default", "sgd", "adagrad"):
        init = (rng.standard_normal((ROWS - 1, DIM)) * 0.05).astype(
            np.float32)
        opt = AddOption(learning_rate=0.05, lam=1e-6)
        t = MatrixTable(ROWS - 1, DIM, init_value=init, updater=updater,
                        device="cuda", default_option=opt,
                        name=f"smoke_{updater}")
        ref = init.copy()               # float32, like the table
        h = np.zeros_like(ref)
        for _ in range(2):
            ids = zipf_ids(rng, 4000, ROWS)
            if updater == "adagrad":
                ids = np.unique(ids)       # stateful: unique ids per add
            d = rng.standard_normal((len(ids), DIM)).astype(np.float32)
            t.add_rows(ids, d)
            if updater == "default":
                np.add.at(ref, ids, d)
            elif updater == "sgd":
                np.add.at(ref, ids, np.float32(-0.05) * d)
            else:
                h[ids] += d * d
                ref[ids] -= np.float32(0.05) * d / (np.sqrt(h[ids])
                                                    + np.float32(1e-6))
        q = zipf_ids(rng, 3000, ROWS)
        got_rows, got = t.get_rows(q), t.get()
        if not (np.allclose(got, ref, rtol=1e-5, atol=1e-5)
                and np.allclose(got_rows, ref[q], rtol=1e-5, atol=1e-5)):
            raise SystemExit(f"MatrixTable {updater}: get/get_rows differ "
                             f"from numpy (max {np.abs(got - ref).max()})")
        log(f"  MatrixTable {updater:8s} add_rows x2 + get_rows: matches "
            f"numpy (max |err| {np.abs(got - ref).max():.3g}), generation "
            f"{t.generation}")


def phase_w2v(torch, tk, Corpus, synthetic_text, W2VConfig, WordEmbedding,
              tmp, profile: bool) -> dict:
    """Phase 4: full-width skip-gram NS; returns the measured numbers."""
    path = os.path.join(tmp, "corpus.txt")
    synthetic_text(path, num_tokens=TOKENS, vocab_size=VOCAB, seed=1)
    corpus = Corpus.from_file(path, min_count=1, subsample=SUBSAMPLE)
    cfg = W2VConfig(embedding_dim=DIM, window=WINDOW, negative=NEGATIVE,
                    batch_size=BATCH, steps_per_call=STEPS,
                    learning_rate=LR, subsample=SUBSAMPLE, seed=1)
    app = WordEmbedding(corpus, cfg, device="cuda", name="smoke_w2v")
    # pairs per token (words/s = pairs/s / pairs per token, as bench.py)
    t0 = time.perf_counter()
    gen_pairs = sum(len(s) for s, _ in corpus.skipgram_batches(
        BATCH, window=WINDOW, seed=7, epochs=1))
    gen_s = time.perf_counter() - t0
    pairs_per_token = gen_pairs / corpus.num_tokens
    need = (1 + TIMED_CALLS + int(profile)) * STEPS
    batches = []
    for b in corpus.skipgram_batches(BATCH, window=WINDOW, seed=1,
                                     epochs=8):
        batches.append(b)
        if len(batches) == need:
            break
    if len(batches) < need:
        raise SystemExit(f"corpus gave {len(batches)} batches, need {need}")
    log(f"  corpus: vocab {corpus.vocab_size}, {corpus.num_tokens} tokens, "
        f"{pairs_per_token:.3f} pairs/token, host pair generation "
        f"{corpus.num_tokens / gen_s:.0f} words/s")

    start_loss = (1 + NEGATIVE) * float(np.log(2.0))  # w_out = 0 at start
    before = dict(tk.LAUNCHES)
    t0 = time.perf_counter()
    warm = app.train(total_steps=STEPS, batches=batches[:STEPS])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    app.train(total_steps=TIMED_CALLS * STEPS,
              batches=batches[STEPS:(1 + TIMED_CALLS) * STEPS])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    losses = app.loss_history
    steps = (1 + TIMED_CALLS) * STEPS
    grown = {k: tk.LAUNCHES[k] - before[k] for k in tk.LAUNCHES}
    log(f"  warm-up call {warm_s:.3f} s, loss {warm:.5f}; timed calls "
        f"{dt:.3f} s, losses {losses}")
    if not all(np.isfinite(losses)) or not np.isfinite(warm):
        raise SystemExit(f"w2v loss is not finite: {warm}, {losses}")
    if not (losses[-1] < warm < start_loss):
        raise SystemExit(f"w2v loss did not fall: start {start_loss:.5f}, "
                         f"warm-up {warm:.5f}, last {losses[-1]:.5f}")
    # skip-gram NS: 2 gathers (w_in, w_out) + 2 scatter-adds per step
    for name in ("row_gather", "row_scatter_add"):
        if grown[name] != 2 * steps:
            raise SystemExit(f"{name}: {grown[name]} launches over {steps} "
                             f"steps, expected {2 * steps}")
    pairs = TIMED_CALLS * STEPS * BATCH
    words_per_sec = pairs / dt / pairs_per_token
    out = dict(words_per_sec=words_per_sec, seconds=dt,
               pairs_per_token=pairs_per_token, steps=steps,
               loss_start=start_loss, loss_warm=warm, losses=losses,
               launches_per_step={k: grown[k] / steps for k in grown})
    if profile:
        out["profile"] = profile_call(torch, app,
                                      batches[(1 + TIMED_CALLS) * STEPS:],
                                      dt / TIMED_CALLS * 1e3)
    return out


def profile_call(torch, app, batches, call_ms: float) -> dict:
    """One superstep call under torch.profiler: device time by kernel and
    the device's busy time, read from the trace's device events (kernels,
    copies, memsets; the union of their intervals). The profiler slows
    the host, so the busy share is also given against ``call_ms``, the
    same call's wall time without the profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        app.train(total_steps=STEPS, batches=batches)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    path = os.path.join(HERE, "chiprun_out", "w2v_call_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_name = {}
    for e in device:
        ms, count = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3, count + 1)
    busy_ms, end = 0.0, float("-inf")
    for start, stop in sorted((e["ts"], e["ts"] + e["dur"]) for e in device):
        busy_ms += max(0.0, stop - max(start, end)) / 1e3
        end = max(end, stop)
    rows = sorted(((k, ms, c) for k, (ms, c) in by_name.items()),
                  key=lambda r: -r[1])
    log(f"  profile: call wall {wall_ms:.1f} ms under the profiler, "
        f"{call_ms:.1f} ms without; device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / call_ms:.1f}% of the call without the "
        f"profiler)")
    for key, ms, count in rows[:12]:
        log(f"    {ms:9.2f} ms  x{count:6d}  {key[:90]}")
    return dict(wall_ms=wall_ms, call_ms=call_ms, device_busy_ms=busy_ms,
                top=[dict(name=k, ms=m, count=c) for k, m, c in rows[:12]])


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import multiverso_tpu_torch as mvt
    except ImportError as e:
        print(f"chip_smoke: multiverso_tpu_torch is not beside this "
              f"script ({e}); run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    from multiverso_tpu_torch.apps.word_embedding import (W2VConfig,
                                                          WordEmbedding)
    from multiverso_tpu_torch.data import Corpus, synthetic_text
    from multiverso_tpu_torch.ops import _build
    from multiverso_tpu_torch.ops import table_kernels as tk
    from multiverso_tpu_torch.tables import MatrixTable
    from multiverso_tpu_torch.updaters import AddOption
    profile = "--profile" in argv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    log("phase 1: device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"  card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    mvt.init()                              # cuda:0
    t0 = time.perf_counter()
    _build.load()
    log(f"  kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds:.2f} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"    {line.strip()}")

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        log("phase 2: kernels vs plain (tolerance: gather exact; "
            "scatter-add exact against the CPU plain version, within the "
            "float32 sum-order bound against the card's)")
        results = phase_kernels(torch, tk, rng)
        w2v_small_parity(torch, Corpus, synthetic_text, W2VConfig,
                         WordEmbedding, tmp)

        tk.reset_launches()
        log("phase 3: MatrixTable Get/Add on the card")
        phase_tables(torch, MatrixTable, AddOption, rng)
        log("phase 4: word2vec skip-gram NS at full width")
        w2v = phase_w2v(torch, tk, Corpus, synthetic_text, W2VConfig,
                        WordEmbedding, tmp, profile)
    launches = dict(tk.LAUNCHES)
    for name, count in launches.items():
        if count <= 0:
            raise SystemExit(f"{name}: no launch on the main path")
    log(f"  word2vec: {w2v['words_per_sec']:.0f} words/s "
        f"({w2v['seconds']:.3f} s for {TIMED_CALLS} calls of "
        f"{STEPS}x{BATCH} pairs) on {card}")
    log(f"  launches per step: {w2v['launches_per_step']}")

    source = "multiverso_tpu_torch/ops/csrc/row_kernels.cu"
    replaces = {
        "row_gather": "multiverso_tpu/ops/table_kernels.py:580",
        "row_scatter_add": "multiverso_tpu/ops/table_kernels.py:610",
        "row_scatter_add_masked": "multiverso_tpu/ops/table_kernels.py:990",
    }
    main_n = BATCH * (1 + NEGATIVE)       # the w_out gather/scatter width
    kernels = []
    for name in ("row_gather", "row_scatter_add", "row_scatter_add_masked"):
        r = results[(name, main_n)]
        kernels.append(dict(
            name=name, route="cuda", source=source,
            replaces=replaces[name], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump(dict(card=card, kernels=kernels, w2v=w2v,
                       kernel_shapes={f"{k[0]}@{k[1]}": v
                                      for k, v in results.items()},
                       seconds=time.perf_counter() - t_start), f, indent=1)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
