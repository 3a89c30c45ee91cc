"""Time ``mv_gibbs_docblock`` with its tuning constants of
``csrc/lda_kernels.cu`` changed, on one card.

Each variant is the source with one or two ``constexpr`` values of its
``db`` namespace replaced (the warps a block ``kWarps``, the blocks an SM
the register cap allows ``kMinBlocks``, a token's row loads issued during
the draw of the token before ``kOverlap`` or after it, the int16 doc
counts kept as 16-bit pairs in shared memory instead of float32
``kFloatCounts``), built with ``nvcc`` into a library of its
own (every build started at once), and called at the LightLDA step of
``chip_smoke.py`` (512,000 tokens in blocks of 512 tokens and 16 docs, K
1,024, int16 doc counts, bf16 word rows) in three cases: read mode on
gathered random rows, and read and build mode reading the rows of a
[50,001, 1,024] bf16 mirror through 512,000 Zipf-1.1 word ids
(``words=``). Every variant's topics, nkd and doc counts must equal the
package kernel's bit for bit; its time is the mean of CUDA events over
20 calls queued behind a spin kernel. Beside each variant: its registers
and spills (``-Xptxas -v``), shared memory a block, the blocks an SM that
registers and shared memory allow, and the waves of the step's 1,000
blocks over the card's SMs. Needs a card and ``nvcc``::

    python -m multiverso_tpu_torch.ops.docblock_sweep [--json PATH]
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
from multiverso_tpu_torch.ops import lda_sampler as ls
from multiverso_tpu_torch.ops import table_kernels as tk

V, K, B, TB, MAXD, SEED = 50_000, 1024, 512_000, 512, 16, 0
ALPHA, BETA = 50.0 / K, 0.01
# name: the constants it sets; "base" is the source as it stands
VARIANTS = {
    "base": {},
    "no_overlap": {"kOverlap": 0},
    "blocks1": {"kMinBlocks": 1},
    "warps4_blocks4": {"kWarps": 4, "kMinBlocks": 4},
    "warps16_blocks1": {"kWarps": 16, "kMinBlocks": 1},
    "packed_counts": {"kFloatCounts": 0},
    "packed_counts_blocks3": {"kFloatCounts": 0, "kMinBlocks": 3},
}
SPIN_CYCLES = 50_000_000  # about 30 ms at the H100's clock
SMEM_PER_SM, REGS_PER_SM = 233_472, 65_536
# the read-mode, bf16-row, register-path instance (int16 counts, C = 8)
FAST_BF16 = "gibbs_docblock_kernelIs13__nv_bfloat16Lb0ELi8E"


def variant_source(text: str, consts: dict) -> str:
    for name, value in consts.items():
        text, hits = re.subn(rf"(constexpr int {name} = )\d+;",
                             rf"\g<1>{value};", text)
        if hits != 1:
            raise ValueError(f"{name}: {hits} definitions in lda_kernels.cu")
    return text


def _registers(log: str) -> tuple:
    """(registers, spill bytes) of the FAST_BF16 instance in ptxas -v."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and FAST_BF16 in line:
            spill = re.search(r"(\d+) bytes spill stores", lines[i + 2])
            regs = re.search(r"Used (\d+) registers", lines[i + 3])
            return int(regs.group(1)), int(spill.group(1))
    raise ValueError(f"no ptxas line for {FAST_BF16}")


def build_all(work: str) -> dict:
    """{name: (entry point, registers, spill bytes)}, one library per
    variant, all nvcc processes started together."""
    src = (_build.CSRC / "lda_kernels.cu").read_text()
    procs = {}
    for name, consts in VARIANTS.items():
        cu = os.path.join(work, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(src, consts))
        so = os.path.join(work, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I",
             str(_build.CSRC), "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed\n{out}")
        fn = ctypes.CDLL(so).mv_gibbs_docblock
        fn.argtypes = _build._SIGNATURES["mv_gibbs_docblock"]
        fn.restype = ctypes.c_int
        libs[name] = (fn, *_registers(out))
    return libs


def occupancy(consts: dict, regs: int) -> dict:
    """Blocks an SM by registers and by shared memory (1 KB reserved a
    block), and the waves of the step's blocks over 132 SMs."""
    warps = consts.get("kWarps", 8)
    count_bytes = 4 if consts.get("kFloatCounts", 1) else 2
    smem = ls.docblock_shared_bytes(TB, MAXD, K // 128, count_bytes)
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = REGS_PER_SM // (per_warp * warps)
    by_smem = SMEM_PER_SM // (smem + 1024)
    blocks = min(by_regs, by_smem, 64 // warps)
    return dict(smem=smem, blocks_by_regs=by_regs, blocks_by_smem=by_smem,
                blocks_per_sm=blocks, waves=B // TB / (132 * max(blocks, 1)))


def device_ms(fn, iters: int = 20) -> float:
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


def cases(rng) -> dict:
    """{case: (ndk0 or None, W, words or None, vectors)} at the step."""
    c, nb = K // 128, B // TB
    p = 1.0 / np.arange(1, V + 1) ** 1.1
    words = rng.choice(V, B, p=p / p.sum()).astype(np.int32)
    zi = rng.integers(0, K, B).astype(np.int32)
    drel = rng.integers(0, MAXD, B).astype(np.int32)
    msk = (rng.random(B) < 0.97).astype(np.int32)
    words[msk == 0] = V                              # the scratch row
    rows = np.repeat(np.arange(nb), TB) * MAXD + drel
    ndk = np.zeros((nb * MAXD, K), np.int16)
    np.add.at(ndk, (rows[msk > 0], zi[msk > 0]), 1)
    nk = rng.integers(5000, 15_000, (c, 128))
    sinv = (1.0 / (nk + V * BETA)).astype(np.float32)
    vec = [torch.as_tensor(x, device="cuda") for x in (
        sinv, zi, drel, msk, rng.random(B).astype(np.float32),
        rng.random(B).astype(np.float32))]
    ndk0 = torch.as_tensor(ndk, device="cuda").view(nb, MAXD, c, 128)
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def word_rows(n):
        return torch.randint(0, 600, (n, c, 128), generator=g,
                             device="cuda").to(torch.bfloat16)
    gathered, mirror = word_rows(B), word_rows(V + 1)
    w = torch.as_tensor(words, device="cuda")
    return {"gathered": (ndk0, gathered, None, vec),
            "rows": (ndk0, mirror, w, vec),
            "build_rows": (None, mirror, w, vec)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="write the times here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("docblock_sweep: no CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as work:
        libs = build_all(work)
        table = {name: dict(registers=regs, spill_bytes=spill,
                            **occupancy(VARIANTS[name], regs))
                 for name, (_, regs, spill) in libs.items()}
        kw = dict(alpha=ALPHA, beta=BETA, tb=TB)
        for case, (ndk0, W, words, vec) in cases(
                np.random.default_rng(SEED)).items():
            # the package kernel's outputs: each variant must equal them
            if ndk0 is None:
                want = ls.gibbs_sample_docblock_build(W, *vec, maxd=MAXD,
                                                      words=words, **kw)
                want_ndk = None
            else:
                want_ndk = ndk0.clone()
                want = ls.gibbs_sample_docblock(want_ndk, W, *vec,
                                                words=words, **kw)[1:]
            sinv, zi, drel, msk, u1, u2 = vec
            for name, (fn, _, _) in libs.items():
                ndk = None if ndk0 is None else ndk0.clone()
                znew = torch.empty(B, dtype=torch.int32, device="cuda")
                nkd = torch.zeros(K // 128, 128, dtype=torch.int32,
                                  device="cuda")

                def call():
                    err = fn(None if ndk is None else ndk.data_ptr(),
                             int(ndk is not None), W.data_ptr(), 1,
                             None if words is None else words.data_ptr(),
                             W.shape[0] if words is not None else 0,
                             sinv.data_ptr(), zi.data_ptr(), drel.data_ptr(),
                             msk.data_ptr(), u1.data_ptr(), u2.data_ptr(),
                             B // TB, TB, MAXD, K // 128, ALPHA, BETA,
                             znew.data_ptr(), nkd.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                call()
                torch.cuda.synchronize()
                same = torch.equal(znew, want[0]) and torch.equal(nkd,
                                                                  want[1])
                if want_ndk is not None:
                    same = same and torch.equal(ndk, want_ndk)
                if not same:
                    raise SystemExit(f"{name} {case}: differs from the "
                                     "package kernel")
                nkd.zero_()
                table[name][case] = device_ms(call)
            if words is not None:
                table.setdefault("row_gather", {})[case] = device_ms(
                    lambda: tk.gather_rows(W, words))
            print(f"{case:10s} " + "  ".join(
                f"{n} {r[case]:.4f}" for n, r in table.items() if case in r),
                flush=True)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    for name, r in table.items():
        if name != "row_gather":
            print(f"{name:16s} {r['registers']:3d} registers, "
                  f"{r['spill_bytes']} bytes spilled, {r['smem']} bytes of "
                  f"shared memory; {r['blocks_per_sm']} blocks an SM "
                  f"(registers {r['blocks_by_regs']}, shared memory "
                  f"{r['blocks_by_smem']}), {r['waves']:.2f} waves")
    print(f"ms a call at the LightLDA step, every variant bit-identical to "
          f"the package kernel; {gpu}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": gpu, "variants": VARIANTS, "ms": table}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
