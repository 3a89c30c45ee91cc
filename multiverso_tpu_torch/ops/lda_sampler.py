"""LightLDA's fused collapsed-Gibbs sampler: posterior and two-level
inverse-CDF draw over a ``[C, 128]`` topic tile, per token.

Counterpart of ``multiverso_tpu/ops/lda_sampler.py`` with the same
functions, arguments and return values:

- :func:`gibbs_sample_tiled` draws from gathered doc-count rows ``A3`` and
  word-count rows ``W3``;
- :func:`gibbs_sample_docblock` reads each doc block's counts from the
  blocked array ``ndk_blk``, which it updates in place with the block's
  moves;
- :func:`gibbs_sample_docblock_build` builds each block's counts from
  ``(zi, drel, msk)`` instead (the out-of-core mode).

Both doc-blocked functions take ``words=``: ``W3`` is then the word-count
mirror ``[V, C, 128]`` and token t reads its row ``words[t]`` inside the
kernel, so no gathered ``[B, C, 128]`` buffer is written and read back.

Semantics, as in the reference: a token's own count leaves both factors
of the numerator (the summary denominator ``1/S`` keeps it); the other
tokens of a batch (of a doc block) are stale. On a CUDA tensor each
function launches its kernel from ``csrc/lda_kernels.cu`` or raises; on a
CPU tensor it runs its ``*_plain`` version, which takes every float32 sum
in the kernel's order (``csrc/lda_draw.cuh``), so the two agree bit for
bit. Against the TPU kernel, whose sums are matmuls, a draw can differ
only where a threshold ties a CDF boundary in float32.

Each launch adds one to ``LAUNCHES[<function name>]``; a doc-blocked
launch with ``words=`` also to ``LAUNCHES["gibbs_sample_docblock_rows"]``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from multiverso_tpu_torch.ops.table_kernels import _LOCK, _launch

LANES = 128
WARP = 32
MAX_CHUNKS = 64                 # K <= 8192 (the kernel's draw keeps 2/lane)
SHARED_BYTES = 232_448          # dynamic shared memory a Hopper block may use

LAUNCHES = {"gibbs_sample_tiled": 0, "gibbs_sample_docblock": 0,
            "gibbs_sample_docblock_build": 0,
            "gibbs_sample_docblock_rows": 0}

A_DTYPES = (torch.int32, torch.int16)
W_DTYPES = (torch.int32, torch.bfloat16)


def reset_launches() -> None:
    with _LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


# -- plain versions ------------------------------------------------------------


def _posterior_plain(A3: torch.Tensor, W3: torch.Tensor, sinv: torch.Tensor,
                     zi: torch.Tensor, msk: torch.Tensor, alpha: float,
                     beta: float) -> torch.Tensor:
    """``max((A - own + alpha) * (W - own + beta), 0) * sinv`` ``[B, C,
    128]`` float32, ``own`` the one-hot of each real token's topic. Counts
    are cast to float32 first (exact below 2^24)."""
    b, c, _ = A3.shape
    k = torch.arange(c * LANES, device=A3.device).view(1, c, LANES)
    own = ((k == zi.long().view(-1, 1, 1))
           & (msk.view(-1, 1, 1) > 0)).to(torch.float32)
    x = (A3.to(torch.float32) - own) + alpha
    y = (W3.to(torch.float32) - own) + beta
    return torch.clamp_min(x * y, 0.0) * sinv.view(1, c, LANES)


def _draw_plain(probs: torch.Tensor, u1: torch.Tensor,
                u2: torch.Tensor) -> torch.Tensor:
    """The kernel's two-level draw (``lda::draw``), sum for sum: per chunk
    ((p0 + p1) + p2) + p3 per warp lane, then a butterfly over the 32
    lanes; the chunk prefix from 0 in chunk order; in the chosen chunk a
    per-lane prefix and a Hillis-Steele scan of the lane totals. Returns
    topics ``[B]`` int64."""
    b, c, _ = probs.shape
    dev = probs.device
    p4 = probs.view(b, c, WARP, LANES // WARP)
    s = p4[..., 0]
    for j in range(1, LANES // WARP):
        s = s + p4[..., j]
    lane = torch.arange(WARP, device=dev)
    for m in (16, 8, 4, 2, 1):
        s = s + s.index_select(2, lane ^ m)
    cs = s[..., 0]                                     # [B, C]
    run = torch.zeros(b, device=dev)
    ccdf = torch.empty(b, c, device=dev)
    for k in range(c):
        run = run + cs[:, k]
        ccdf[:, k] = run
    t1 = u1 * run
    chunk = (ccdf < t1[:, None]).sum(1).clamp_max(c - 1)
    sub = probs[torch.arange(b, device=dev), chunk].view(b, WARP, -1)
    q = [sub[..., 0]]
    for j in range(1, LANES // WARP):
        q.append(q[-1] + sub[..., j])
    scan = q[-1]
    for d in (1, 2, 4, 8, 16):
        y = torch.cat([scan[:, :d], scan[:, :-d]], 1)  # lane l reads l - d
        scan = torch.where(lane >= d, y + scan, scan)
    excl = torch.cat([torch.zeros(b, 1, device=dev), scan[:, :-1]], 1)
    t2 = u2 * scan[:, -1]
    cnt = sum((excl + qj < t2[:, None]).sum(1) for qj in q)
    return chunk * LANES + cnt.clamp_max(LANES - 1)


def _nk_delta(zi: torch.Tensor, znew: torch.Tensor, msk: torch.Tensor,
              c: int) -> torch.Tensor:
    real = msk > 0
    nkd = torch.zeros(c * LANES, dtype=torch.int32, device=zi.device)
    ones = torch.ones(int(real.sum()), dtype=torch.int32, device=zi.device)
    nkd.index_add_(0, znew[real].long(), ones)
    nkd.index_add_(0, zi[real].long(), -ones)
    return nkd.view(c, LANES)


def gibbs_sample_tiled_plain(A3, W3, sinv, zi, msk, u1, u2, *, alpha: float,
                             beta: float):
    """:func:`gibbs_sample_tiled` in plain PyTorch (the kernel's order)."""
    probs = _posterior_plain(A3, W3, sinv, zi, msk, alpha, beta)
    zn = _draw_plain(probs, u1.to(torch.float32), u2.to(torch.float32))
    znew = torch.where(msk > 0, zn, zi.long()).to(torch.int32)
    return znew, _nk_delta(zi, znew, msk, A3.shape[1])


def _block_rows(drel: torch.Tensor, tb: int, maxd: int) -> torch.Tensor:
    """Row of each token in the ``[NB * MAXD, K]`` view of block counts."""
    blk = torch.arange(drel.shape[0], device=drel.device) // tb
    return blk * maxd + drel.long()


def _doc_rows(flat: torch.Tensor, drel: torch.Tensor, tb: int,
              maxd: int) -> tuple:
    """(rows, in_block, A): each token's row of the ``[NB * MAXD, K]``
    counts ``flat``, whether its ``drel`` lies in ``[0, MAXD)``, and its
    doc-count row, a zero row where it does not (the reference's one-hot
    ``E @ ndk``)."""
    rows = _block_rows(drel, tb, maxd)
    inb = (drel >= 0) & (drel < maxd)
    A = flat.index_select(0, torch.where(inb, rows, 0))
    return rows, inb, torch.where(inb[:, None], A, 0)


def _mirror_rows(W, words: torch.Tensor, c: int) -> torch.Tensor:
    """The word rows ``W[words]`` as ``[B, C, 128]`` (``index_select``:
    raises on an id outside ``[0, V)``)."""
    return W.reshape(W.shape[0], -1).index_select(0, words.long()).view(
        -1, c, LANES)


def gibbs_sample_docblock_plain(ndk_blk, W3, sinv, zi, drel, msk, u1, u2, *,
                                alpha: float, beta: float, tb: int,
                                words=None):
    """:func:`gibbs_sample_docblock` in plain PyTorch: A rows are the
    block-start counts; the moves are applied after all draws and
    ``ndk_blk`` is updated in place. With ``words``, ``W3`` is the mirror
    and its rows are gathered first."""
    nb, maxd, c, _ = ndk_blk.shape
    if words is not None:
        W3 = _mirror_rows(W3, words, c)
    flat = ndk_blk.view(nb * maxd, c * LANES)
    rows, inb, A = _doc_rows(flat, drel, tb, maxd)
    znew, nkd = gibbs_sample_tiled_plain(A.view(-1, c, LANES), W3, sinv, zi,
                                         msk, u1, u2, alpha=alpha,
                                         beta=beta)
    moves = (msk > 0) & inb
    moved = flat.to(torch.int32)
    ones = torch.ones(int(moves.sum()), dtype=torch.int32, device=zi.device)
    moved.index_put_((rows[moves], zi[moves].long()), -ones,
                     accumulate=True)
    moved.index_put_((rows[moves], znew[moves].long()), ones,
                     accumulate=True)
    flat.copy_(moved.to(ndk_blk.dtype))
    return ndk_blk, znew, nkd


def gibbs_sample_docblock_build_plain(W3, sinv, zi, drel, msk, u1, u2, *,
                                      alpha: float, beta: float, tb: int,
                                      maxd: int, words=None):
    """:func:`gibbs_sample_docblock_build` in plain PyTorch: each block's
    counts built from its real tokens, then the tiled draw (padded tokens
    keep their topic). With ``words``, ``W3`` is the mirror and its rows
    are gathered first."""
    c = W3.shape[-2] if words is None else sinv.shape[0]
    if words is not None:
        W3 = _mirror_rows(W3, words, c)
    b = W3.shape[0]
    rows = _block_rows(drel, tb, maxd)
    counted = (msk > 0) & (drel >= 0) & (drel < maxd)
    ndk = torch.zeros(b // tb * maxd, c * LANES, dtype=torch.int32,
                      device=W3.device)
    ones = torch.ones(int(counted.sum()), dtype=torch.int32,
                      device=W3.device)
    ndk.index_put_((rows[counted], zi[counted].long()), ones,
                   accumulate=True)
    A = _doc_rows(ndk, drel, tb, maxd)[2]
    return gibbs_sample_tiled_plain(A.view(b, c, LANES), W3, sinv, zi, msk,
                                    u1, u2, alpha=alpha, beta=beta)


def explained_by_ties(A3, W3, sinv, zi, msk, u1, u2, z_a, z_b, *,
                      alpha: float, beta: float,
                      rtol: float = 1e-5) -> np.ndarray:
    """For two draws ``z_a``, ``z_b`` [B] of the same tokens (e.g. this
    package's and the reference's), True where they agree or where their
    difference is a float32 tie: computed in float64, the level-1
    threshold ``u1 * total`` lies within ``rtol * total`` of every chunk
    boundary between the two topics' chunks, or (same chunk) ``u2 *
    chunk_total`` lies within ``rtol * chunk_total`` of every lane
    boundary between them. Inputs are numpy arrays (``A3``/``W3`` as
    float32 or integers ``[B, C, 128]``)."""
    A3, W3 = np.asarray(A3, np.float64), np.asarray(W3, np.float64)
    b, c, _ = A3.shape
    z_a, z_b = np.asarray(z_a), np.asarray(z_b)
    ok = z_a == z_b
    for i in np.nonzero(~ok)[0]:
        if msk[i] <= 0:
            continue
        own = (np.arange(c * LANES) == zi[i]).astype(np.float64)
        p = np.maximum((A3[i].reshape(-1) - own + alpha)
                       * (W3[i].reshape(-1) - own + beta), 0.0) \
            * np.asarray(sinv, np.float64).reshape(-1)
        p = p.reshape(c, LANES)
        ca, cb = sorted((int(z_a[i]) // LANES, int(z_b[i]) // LANES))
        if ca != cb:
            ccdf = np.cumsum(p.sum(1))
            t1 = float(u1[i]) * ccdf[-1]
            ok[i] = bool(np.all(np.abs(ccdf[ca:cb] - t1)
                                <= rtol * ccdf[-1]))
        else:
            scdf = np.cumsum(p[ca])
            t2 = float(u2[i]) * scdf[-1]
            la, lb = sorted((int(z_a[i]) % LANES, int(z_b[i]) % LANES))
            ok[i] = bool(np.all(np.abs(scdf[la:lb] - t2)
                                <= rtol * scdf[-1]))
    return ok


# -- kernel wrappers -----------------------------------------------------------


def _check_tile(t: torch.Tensor) -> int:
    """The chunk count C of a ``[..., C, 128]`` tile."""
    if t.shape[-1] != LANES:
        raise ValueError(f"last dim must be {LANES}, got {t.shape[-1]}")
    return t.shape[-2]


def _cuda_operands(dtypes: dict, vectors: dict, b: int, c: int,
                   sinv: torch.Tensor, dev: torch.device) -> list:
    """Check the operands of a kernel launch on CUDA device ``dev``;
    returns the per-token vectors as contiguous int32/float32 tensors."""
    if dev.type != "cuda":
        raise ValueError(f"no sampler kernel for device {dev}")
    for name, (t, allowed) in dtypes.items():
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, W3 on {dev}")
        if t.dtype not in allowed:
            raise TypeError(f"{name} must be one of {allowed}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if c > MAX_CHUNKS:
        raise ValueError(f"K = {c * LANES} topics: the kernels take at most "
                         f"{MAX_CHUNKS * LANES}")
    if sinv.shape != (c, LANES):
        raise ValueError(f"sinv shape {tuple(sinv.shape)} != ({c}, {LANES})")
    out = []
    for name, (t, dtype) in vectors.items():
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, W3 on {dev}")
        if t.shape != (b,):
            raise ValueError(f"{name} shape {tuple(t.shape)} != ({b},)")
        out.append(t.to(dtype).contiguous())
    return out


def _token_vectors(**kw) -> dict:
    floats = ("u1", "u2")
    return {k: (v, torch.float32 if k in floats else torch.int32)
            for k, v in kw.items()}


def gibbs_sample_tiled(A3: torch.Tensor, W3: torch.Tensor,
                       sinv: torch.Tensor, zi: torch.Tensor,
                       msk: torch.Tensor, u1: torch.Tensor,
                       u2: torch.Tensor, *, alpha: float, beta: float):
    """Draw new topics for a batch of tokens.

    Args:
      A3:   [B, C, 128] int32/int16 — gathered doc-topic count rows.
      W3:   [B, C, 128] int32/bf16 — gathered word-topic count rows.
      sinv: [C, 128] float32 — 1 / (summary + V*beta).
      zi:   [B] int32 — current topic assignments.
      msk:  [B] int32 — 1 for real tokens, 0 for padded lanes.
      u1, u2: [B] float32 — uniforms (two per token).

    Returns (znew [B] int32, nk_delta [C, 128] int32).

    Replaces ``gibbs_sample_tiled`` (the TPU ``_kernel``)."""
    c = _check_tile(A3)
    _check_tile(W3)
    if W3.device.type == "cpu":
        return gibbs_sample_tiled_plain(A3, W3, sinv, zi, msk, u1, u2,
                                        alpha=alpha, beta=beta)
    b = A3.shape[0]
    if W3.shape != A3.shape:
        raise ValueError(f"W3 shape {tuple(W3.shape)} != A3 shape "
                         f"{tuple(A3.shape)}")
    zi, msk, u1, u2 = _cuda_operands(
        {"A3": (A3, A_DTYPES), "W3": (W3, W_DTYPES),
         "sinv": (sinv, (torch.float32,))},
        _token_vectors(zi=zi, msk=msk, u1=u1, u2=u2), b, c, sinv, W3.device)
    znew = torch.empty(b, dtype=torch.int32, device=W3.device)
    nkd = torch.zeros(c, LANES, dtype=torch.int32, device=W3.device)
    if b:
        _launch("gibbs_sample_tiled", "mv_gibbs_tiled", A3.data_ptr(),
                int(A3.dtype == torch.int16), W3.data_ptr(),
                int(W3.dtype == torch.bfloat16), sinv.data_ptr(),
                zi.data_ptr(), msk.data_ptr(), u1.data_ptr(), u2.data_ptr(),
                b, c, float(alpha), float(beta), znew.data_ptr(),
                nkd.data_ptr(), device=W3.device, counts=LAUNCHES)
    return znew, nkd


def _check_mirror(W: torch.Tensor, words: torch.Tensor, b: int,
                  c: int) -> None:
    """The ``words=`` operands on any device: ``W`` a mirror ``[V, ...]``
    of ``C * 128`` word counts a row, ``words`` ``[B]`` integer ids."""
    if words.shape != (b,):
        raise ValueError(f"words shape {tuple(words.shape)} != ({b},)")
    if words.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"words must be int32 or int64, got {words.dtype}")
    if W.dtype not in W_DTYPES:
        raise TypeError(f"the mirror must be one of {W_DTYPES}, got "
                        f"{W.dtype}")
    width = math.prod(W.shape[1:]) if W.dim() >= 2 else -1
    if width != c * LANES:
        raise ValueError(f"mirror shape {tuple(W.shape)}: a row must hold "
                         f"C * 128 = {c * LANES} word counts")
    if W.device != words.device:
        raise ValueError(f"words on {words.device}, the mirror on "
                         f"{W.device}")


def docblock_shared_bytes(tb: int, maxd: int, c: int,
                          count_bytes: int = 4) -> int:
    """Shared memory a block of the doc-blocked kernel holds: its counts
    ``[maxd, K]`` and a zero row (``count_bytes`` each: int32 or
    float32), per token ``(zi, drel, msk, row)``, ``(u1, u2)`` and the new
    topic, and the ``[K]`` nkd delta (``db::smem_bytes`` in
    ``csrc/lda_kernels.cu``)."""
    k = c * LANES
    return -(-(maxd + 1) * k * count_bytes // 16) * 16 + tb * 28 + k * 4


def _docblock_launch(name: str, ndk_blk, W, sinv, zi, drel, msk, u1, u2,
                     alpha, beta, tb: int, maxd: int, c: int, words):
    b = zi.shape[0]
    nb = b // tb
    if docblock_shared_bytes(tb, maxd, c) > SHARED_BYTES:
        raise ValueError(f"a doc block of {maxd} docs x {c * LANES} topics "
                         f"and {tb} tokens exceeds a block's "
                         f"{SHARED_BYTES} bytes of shared memory")
    operands = {"W3": (W, W_DTYPES), "sinv": (sinv, (torch.float32,))}
    if ndk_blk is not None:
        operands["ndk_blk"] = (ndk_blk, A_DTYPES)
    vectors = dict(zi=zi, drel=drel, msk=msk, u1=u1, u2=u2)
    if words is not None:
        vectors["words"] = words
    vecs = _cuda_operands(operands, _token_vectors(**vectors), b, c, sinv,
                          W.device)
    zi, drel, msk, u1, u2 = vecs[:5]
    for t_name, (t, _) in operands.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{t_name} must be 16-byte aligned")
    znew = torch.empty(b, dtype=torch.int32, device=W.device)
    nkd = torch.zeros(c, LANES, dtype=torch.int32, device=W.device)
    if nb:
        _launch(name, "mv_gibbs_docblock",
                None if ndk_blk is None else ndk_blk.data_ptr(),
                int(ndk_blk is not None and ndk_blk.dtype == torch.int16),
                W.data_ptr(), int(W.dtype == torch.bfloat16),
                None if words is None else vecs[5].data_ptr(),
                W.shape[0] if words is not None else 0,
                sinv.data_ptr(), zi.data_ptr(), drel.data_ptr(),
                msk.data_ptr(), u1.data_ptr(), u2.data_ptr(), nb, tb, maxd,
                c, float(alpha), float(beta), znew.data_ptr(),
                nkd.data_ptr(), device=W.device, counts=LAUNCHES)
        if words is not None:
            with _LOCK:     # replica threads launch at once
                LAUNCHES["gibbs_sample_docblock_rows"] += 1
    return znew, nkd


def gibbs_sample_docblock(ndk_blk: torch.Tensor, W3: torch.Tensor,
                          sinv: torch.Tensor, zi: torch.Tensor,
                          drel: torch.Tensor, msk: torch.Tensor,
                          u1: torch.Tensor, u2: torch.Tensor, *,
                          alpha: float, beta: float, tb: int,
                          words: Optional[torch.Tensor] = None):
    """Doc-blocked fused sampler + doc-count update.

    Args:
      ndk_blk: [NB, MAXD, C, 128] int16/int32 — blocked doc-topic counts;
        block b EXCLUSIVELY owns its MAXD rows (whole docs per block).
        Updated in place (the reference's donated, aliased operand).
      W3:   [NB*TB, C, 128] int32/bf16 — gathered word-count rows; with
        ``words``, the mirror [V, C, 128] (or [V, C*128]) they come from.
      sinv: [C, 128] f32 — 1 / (summary + V*beta).
      zi, drel, msk, u1, u2: [NB*TB] — current topics, doc row within
        block (in [0, MAXD); a token outside it draws against a zero doc
        row and moves nk only), token mask, uniforms.
      tb: tokens per block (NB*TB must equal len(zi)).
      words: [NB*TB] int32/int64 — each token's row of the mirror. The
        kernel reads those rows itself (a masked token reads none; an id
        outside [0, V) reads as a zero row, as ``gather_rows``); the plain
        version gathers them with ``index_select`` (which raises there).

    Returns (ndk_blk, znew [NB*TB] int32, nk_delta [C, 128] int32).

    Replaces ``gibbs_sample_docblock`` (the TPU ``_docblock_kernel``),
    with ``words`` also the ``gather_rows`` in front of it."""
    _check_tile(ndk_blk)
    nb, maxd, c, _ = ndk_blk.shape
    b = zi.shape[0]
    if b != nb * tb:
        raise ValueError(f"token count {b} != blocks {nb} * tb {tb}")
    if words is not None:
        _check_mirror(W3, words, b, c)
    if W3.device.type == "cpu":
        return gibbs_sample_docblock_plain(ndk_blk, W3, sinv, zi, drel, msk,
                                           u1, u2, alpha=alpha, beta=beta,
                                           tb=tb, words=words)
    if words is None and W3.shape != (b, c, LANES):
        raise ValueError(f"W3 shape {tuple(W3.shape)} != ({b}, {c}, "
                         f"{LANES})")
    znew, nkd = _docblock_launch("gibbs_sample_docblock", ndk_blk, W3, sinv,
                                 zi, drel, msk, u1, u2, alpha, beta, tb,
                                 maxd, c, words)
    return ndk_blk, znew, nkd


def gibbs_sample_docblock_build(W3: torch.Tensor, sinv: torch.Tensor,
                                zi: torch.Tensor, drel: torch.Tensor,
                                msk: torch.Tensor, u1: torch.Tensor,
                                u2: torch.Tensor, *, alpha: float,
                                beta: float, tb: int, maxd: int,
                                words: Optional[torch.Tensor] = None):
    """Doc-blocked sampler that BUILDS each block's doc counts from
    ``(zi, drel, msk)`` instead of reading a blocked count array. Same
    draw as :func:`gibbs_sample_docblock`: bit-identical znew for real
    tokens. ``words``: as there (``W3`` the mirror, C from ``sinv``).

    Returns (znew [NB*TB] int32, nk_delta [C, 128] int32).

    Replaces ``gibbs_sample_docblock_build`` (the TPU
    ``_docblock_build_kernel``): the CUDA docblock kernel in build
    mode."""
    if words is None:
        c = _check_tile(W3)
        b = W3.shape[0]
    else:
        c = _check_tile(sinv)
        b = zi.shape[0]
        _check_mirror(W3, words, b, c)
    if b % tb:
        raise ValueError(f"token count {b} not divisible by tb {tb}")
    if W3.device.type == "cpu":
        return gibbs_sample_docblock_build_plain(
            W3, sinv, zi, drel, msk, u1, u2, alpha=alpha, beta=beta, tb=tb,
            maxd=maxd, words=words)
    return _docblock_launch("gibbs_sample_docblock_build", None, W3, sinv,
                            zi, drel, msk, u1, u2, alpha, beta, tb, maxd, c,
                            words)


__all__ = ["LAUNCHES", "docblock_shared_bytes", "explained_by_ties",
           "gibbs_sample_docblock",
           "gibbs_sample_docblock_build",
           "gibbs_sample_docblock_build_plain", "gibbs_sample_docblock_plain",
           "gibbs_sample_tiled", "gibbs_sample_tiled_plain",
           "reset_launches"]
