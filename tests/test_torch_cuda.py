"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The
file imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the gather is exact. The scatter-add kernels add each run of
duplicate ids (COO: each element's lanes) in sorted-lane order, the order
in which the plain version adds on the CPU (``index_add_`` goes lane by
lane there), so the two are compared bit for bit; int32 is exact in any
order, and the int32 COO kernel takes its lanes unsorted. The plain version on the card (``index_add_`` with atomics) adds
float32 in no fixed order and is not the reference here. The Gibbs
sampler kernels take every float32 sum in the order their plain version
takes it (``ops/lda_sampler.py``), so their draws, ``nkd`` and the doc
counts are compared bit for bit too (tightened from the tie rule that
holds against the JAX package: on the card no draw differed).
"""

import time

import numpy as np
import pytest
import torch

from multiverso_tpu_torch.ops import lda_sampler as ls
from multiverso_tpu_torch.ops import table_kernels as tk
from multiverso_tpu_torch.tables import MatrixTable, SparseMatrixTable

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (the CPU tests hold their plain versions)")
    return torch.device("cuda")


def _zipf_ids(rng, n, rows):
    return np.clip(rng.zipf(1.2, size=n) - 1, 0, rows - 1).astype(np.int32)


@pytest.mark.parametrize("cols,n", [(100, 4096), (100, 24_576), (7, 999),
                                    (256, 24_576)])
def test_kernels_match_plain(cuda, cols, n):
    rng = np.random.default_rng(cols + n)
    rows = 10_001
    p = torch.from_numpy(rng.standard_normal((rows, cols)).astype(
        np.float32)).to(cuda)
    ids = torch.from_numpy(_zipf_ids(rng, n, rows)).to(cuda)
    d = torch.from_numpy(rng.standard_normal((n, cols)).astype(
        np.float32)).to(cuda)
    before = dict(tk.LAUNCHES)
    assert torch.equal(tk.gather_rows(p, ids), tk.gather_rows_plain(p, ids))
    got = tk.row_scatter_add(p.clone(), ids, d)
    want = tk.row_scatter_add_plain(p.cpu(), ids.cpu(), d.cpu())
    assert torch.equal(got.cpu(), want)
    sids = torch.sort(ids).values
    valid = torch.from_numpy(rng.random(n) < 0.9).to(cuda)
    got = tk.row_scatter_add_masked(p.clone(), sids, d, valid)
    want = tk.row_scatter_add_masked_plain(p.cpu(), sids.cpu(), d.cpu(),
                                           valid.cpu())
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    for name in ("row_gather", "row_scatter_add", "row_scatter_add_masked"):
        assert tk.LAUNCHES[name] == before[name] + 1


def test_tiled_layout_is_the_flat_rows(cuda):
    rng = np.random.default_rng(1)
    p = torch.from_numpy(rng.standard_normal((50, 2, 128)).astype(
        np.float32)).to(cuda)
    ids = torch.tensor([3, 3, 0, 49], dtype=torch.int32, device=cuda)
    assert torch.equal(tk.gather_rows(p, ids),
                       p.view(50, 256).index_select(0, ids.long()))


def test_wrappers_raise_instead_of_falling_back(cuda):
    p = torch.zeros(8, 4, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        tk.gather_rows(p.half(), torch.zeros(2, dtype=torch.int32,
                                             device=cuda))
    with pytest.raises(ValueError, match="operand on cpu"):
        tk.gather_rows(p, torch.zeros(2, dtype=torch.int32))


def test_matrix_table_round_trip(cuda):
    rng = np.random.default_rng(2)
    t = MatrixTable(300, 100, device=cuda, name="cuda_rt")
    ref = np.zeros((300, 100), np.float32)
    for _ in range(3):
        ids = _zipf_ids(rng, 500, 300)
        d = rng.integers(-4, 5, (500, 100)).astype(np.float32)
        t.add_rows(ids, d)
        np.add.at(ref, ids, d)
    q = _zipf_ids(rng, 77, 300)
    np.testing.assert_array_equal(t.get_rows(q), ref[q])
    np.testing.assert_array_equal(t.get(), ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int16, torch.int32])
def test_gather_copies_narrow_and_int_rows(cuda, dtype):
    rng = np.random.default_rng(3)
    p = torch.from_numpy(rng.integers(-300, 300, (501, 1024))).to(dtype)
    ids = torch.from_numpy(_zipf_ids(rng, 4096, 501))
    want = tk.gather_rows_plain(p, ids)
    got = tk.gather_rows(p.to(cuda), ids.to(cuda))
    assert torch.equal(got.cpu(), want)
    odd = p[:, :7].contiguous()                 # 14-byte rows: 2-byte path
    assert torch.equal(tk.gather_rows(odd.to(cuda), ids.to(cuda)).cpu(),
                       tk.gather_rows_plain(odd, ids))


def test_int32_row_scatter_add(cuda):
    rng = np.random.default_rng(4)
    p = torch.from_numpy(rng.integers(0, 9, (300, 256)).astype(np.int32))
    ids = torch.from_numpy(_zipf_ids(rng, 5000, 300))
    d = torch.from_numpy(rng.integers(-3, 4, (5000, 256)).astype(np.int32))
    want = tk.row_scatter_add_plain(p.clone(), ids, d)
    got = tk.row_scatter_add(p.to(cuda), ids.to(cuda), d.to(cuda))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("dtype,shape,n", [
    (torch.int32, (50_001, 1024), 512_000),
    (torch.int32, (300, 8, 128), 20_000),
    (torch.int32, (40, 5000), 9_000),           # wider than the accumulator
    (torch.float32, (300, 100), 20_000),
    (torch.float32, (300, 2, 128), 20_000),
])
def test_coo_matches_cpu_plain(cuda, dtype, shape, n):
    rng = np.random.default_rng(n)
    rows = torch.from_numpy(np.clip(rng.zipf(1.1, n) - 1, 0,
                                    shape[0] - 1).astype(np.int32))
    cols = torch.from_numpy(rng.integers(0, int(np.prod(shape[1:])), n)
                            .astype(np.int32))
    if dtype == torch.int32:
        vals = torch.from_numpy(rng.integers(-2, 3, n).astype(np.int32))
        p = torch.zeros(shape, dtype=dtype)
    else:
        vals = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        p = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    before = dict(tk.LAUNCHES)
    got = tk.coo_scatter_add(p.to(cuda), rows.to(cuda), cols.to(cuda),
                             vals.to(cuda))
    want = tk.coo_scatter_add_plain(p.clone(), rows, cols, vals)
    assert torch.equal(got.cpu(), want)
    srt = torch.sort(rows, stable=True)
    valid = torch.from_numpy((rng.random(n) < 0.8).astype(np.int32))
    got = tk.coo_scatter_add_masked(
        p.to(cuda), srt.values.to(cuda), cols[srt.indices].to(cuda),
        vals[srt.indices].to(cuda), valid.to(cuda))
    want = tk.coo_scatter_add_masked_plain(
        p.clone(), srt.values, cols[srt.indices], vals[srt.indices], valid)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert tk.LAUNCHES["coo_scatter_add"] == before["coo_scatter_add"] + 1
    assert tk.LAUNCHES["coo_scatter_add_masked"] == \
        before["coo_scatter_add_masked"] + 1


ALPHA, BETA = 50.0 / 1024, 0.01


def _lda_inputs(rng, b, c, a_dtype, w_dtype):
    k = c * 128
    A = rng.integers(0, 6, (b, c, 128))
    W = rng.integers(0, 600, (b, c, 128))
    nk = rng.integers(5000, 50_000, (c, 128))
    sinv = (1.0 / (nk + 50_000 * BETA)).astype(np.float32)
    zi = rng.integers(0, k, b).astype(np.int32)
    msk = (rng.random(b) < 0.97).astype(np.int32)
    u1 = rng.random(b).astype(np.float32)
    u2 = rng.random(b).astype(np.float32)
    return (torch.from_numpy(A).to(a_dtype), torch.from_numpy(W).to(w_dtype),
            *(torch.from_numpy(x) for x in (sinv, zi, msk, u1, u2)))




@pytest.mark.parametrize("a_dtype,w_dtype", [(torch.int16, torch.bfloat16),
                                             (torch.int32, torch.int32)])
def test_gibbs_tiled_matches_plain(cuda, a_dtype, w_dtype):
    rng = np.random.default_rng(7)
    args = _lda_inputs(rng, 8192, 8, a_dtype, w_dtype)
    znew, nkd = ls.gibbs_sample_tiled(*(x.to(cuda) for x in args),
                                      alpha=ALPHA, beta=BETA)
    want, _ = ls.gibbs_sample_tiled_plain(*args, alpha=ALPHA, beta=BETA)
    znew = znew.cpu()
    assert torch.equal(znew, want)
    zi, msk = args[3], args[4]
    assert torch.equal(nkd.cpu(), ls._nk_delta(zi, znew, msk, 8))


@pytest.mark.parametrize("n_dtype,w_dtype", [(torch.int16, torch.bfloat16),
                                             (torch.int32, torch.int32)])
def test_gibbs_docblock_and_build_mode(cuda, n_dtype, w_dtype):
    rng = np.random.default_rng(8)
    nb, maxd, tb, c = 24, 16, 512, 8
    b = nb * tb
    _, W3, sinv, zi, msk, u1, u2 = _lda_inputs(rng, b, c, torch.int32,
                                               w_dtype)
    drel = torch.from_numpy(rng.integers(0, maxd, b).astype(np.int32))
    # consistent block counts: exactly the counts of the block's own z
    rows = ls._block_rows(drel, tb, maxd)
    ndk = torch.zeros(nb * maxd, c * 128, dtype=torch.int32)
    real = msk > 0
    ndk.index_put_((rows[real], zi[real].long()),
                   torch.ones(int(real.sum()), dtype=torch.int32),
                   accumulate=True)
    ndk = ndk.view(nb, maxd, c, 128).to(n_dtype)
    dev_ndk = ndk.to(cuda)
    dev = [x.to(cuda) for x in (W3, sinv, zi, drel, msk, u1, u2)]
    _, znew, nkd = ls.gibbs_sample_docblock(dev_ndk, *dev, alpha=ALPHA,
                                            beta=BETA, tb=tb)
    zb, nkdb = ls.gibbs_sample_docblock_build(*dev, alpha=ALPHA, beta=BETA,
                                              tb=tb, maxd=maxd)
    znew, zb = znew.cpu(), zb.cpu()
    assert torch.equal(zb[real], znew[real])          # build == read
    assert torch.equal(nkdb.cpu(), nkd.cpu())
    p_ndk = ndk.clone()
    _, want, _ = ls.gibbs_sample_docblock_plain(
        p_ndk, W3, sinv, zi, drel, msk, u1, u2, alpha=ALPHA, beta=BETA,
        tb=tb)
    assert torch.equal(znew, want)
    assert torch.equal(dev_ndk.cpu(), p_ndk)
    assert torch.equal(nkd.cpu(), ls._nk_delta(zi, znew, msk, c))
    moved = ndk.view(nb * maxd, -1).to(torch.int32)
    one = torch.ones(int(real.sum()), dtype=torch.int32)
    moved.index_put_((rows[real], zi[real].long()), -one, accumulate=True)
    moved.index_put_((rows[real], znew[real].long()), one, accumulate=True)
    assert torch.equal(dev_ndk.cpu().view(nb * maxd, -1).to(torch.int32),
                       moved)


# topics at chunk and lane edges (K = 128 keeps those below 128)
EDGE_TOPICS = (0, 3, 4, 127, 128, 131, 132, 1023, 1024, 8191)


def _docblock_case(rng, nb, tb, maxd, c, n_dtype, w_dtype):
    """Doc-blocked operands with every edge the kernel has: block 1 ends
    in padded tokens, block 2 is all pads, block 3 has real tokens whose
    drel lies outside [0, maxd), block 4's first tokens have word rows
    peaked at topics on chunk and lane edges, block 5 draws with the
    uniforms at 0 and 1. The block counts are those of the in-block real
    tokens' own (zi, drel): a consistent state."""
    k, b = c * 128, nb * tb
    W3 = torch.from_numpy(rng.integers(0, 600, (b, c, 128), np.int32))
    nk = rng.integers(5000, 50_000, (c, 128))
    sinv = torch.from_numpy((1.0 / (nk + 50_000 * BETA)).astype(np.float32))
    zi = torch.from_numpy(rng.integers(0, k, b).astype(np.int32))
    msk = torch.from_numpy((rng.random(b) < 0.97).astype(np.int32))
    u1 = torch.from_numpy(rng.random(b).astype(np.float32))
    u2 = torch.from_numpy(rng.random(b).astype(np.float32))
    drel = torch.from_numpy(rng.integers(0, maxd, b).astype(np.int32))
    msk[tb - 40:tb] = 0
    msk[tb:2 * tb] = 0
    msk[2 * tb:3 * tb] = 1
    drel[2 * tb:2 * tb + 6] = torch.tensor([-1, maxd, maxd + 5, -7, maxd,
                                            -1], dtype=torch.int32)
    edges = [e for e in EDGE_TOPICS if e < k]
    for j in range(32):
        t = 3 * tb + j
        W3[t] = 0
        W3[t].view(-1)[edges[j % len(edges)]] = 60_000
        msk[t] = 1
    ends = torch.tensor([0.0, 1.0, float(np.nextafter(np.float32(1),
                                                      np.float32(0)))])
    u1[4 * tb:4 * tb + 9] = ends.repeat_interleave(3)
    u2[4 * tb:4 * tb + 9] = ends.repeat(3)
    msk[4 * tb:4 * tb + 9] = 1
    rows = ls._block_rows(drel, tb, maxd)
    inb = (msk > 0) & (drel >= 0) & (drel < maxd)
    ndk = torch.zeros(nb * maxd, k, dtype=torch.int32)
    ndk.index_put_((rows[inb], zi[inb].long()),
                   torch.ones(int(inb.sum()), dtype=torch.int32),
                   accumulate=True)
    return (ndk.view(nb, maxd, c, 128).to(n_dtype), W3.to(w_dtype),
            (sinv, zi, drel, msk, u1, u2))


@pytest.mark.parametrize("n_dtype,w_dtype", [(torch.int16, torch.bfloat16),
                                             (torch.int32, torch.int32),
                                             (torch.int16, torch.int32)])
@pytest.mark.parametrize("k,maxd", [(128, 1), (128, 16), (1024, 1),
                                    (1024, 16), (8192, 1), (8192, 4)])
def test_gibbs_docblock_every_edge_matches_plain(cuda, n_dtype, w_dtype, k,
                                                 maxd):
    """Read and build mode against their plain versions bit for bit at
    K 128 and 8,192 (the generic path) and 1,024 (the register path)."""
    rng = np.random.default_rng(k + maxd)
    nb, tb, c = 6, 256, k // 128
    ndk, W3, vec = _docblock_case(rng, nb, tb, maxd, c, n_dtype, w_dtype)
    sinv, zi, drel, msk, u1, u2 = vec
    kw = dict(alpha=ALPHA, beta=BETA, tb=tb)
    dev_ndk = ndk.clone().to(cuda)
    dev = [x.to(cuda) for x in (W3, *vec)]
    _, znew, nkd = ls.gibbs_sample_docblock(dev_ndk, *dev, **kw)
    zb, nkdb = ls.gibbs_sample_docblock_build(*dev, maxd=maxd, **kw)
    p_ndk = ndk.clone()
    _, want, want_nkd = ls.gibbs_sample_docblock_plain(p_ndk, W3, *vec, **kw)
    wb, wb_nkd = ls.gibbs_sample_docblock_build_plain(W3, *vec, maxd=maxd,
                                                      **kw)
    znew, zb = znew.cpu(), zb.cpu()
    assert torch.equal(znew, want)
    assert torch.equal(nkd.cpu(), want_nkd)
    assert torch.equal(dev_ndk.cpu(), p_ndk)
    assert torch.equal(zb, wb) and torch.equal(nkdb.cpu(), wb_nkd)
    real = msk > 0
    assert torch.equal(zb[real], znew[real])          # build == read
    assert torch.equal(znew[~real], zi[~real])
    out = drel[2 * tb:2 * tb + 6]                      # drew on a zero row
    assert ((out < 0) | (out >= maxd)).all()
    peaked = znew[3 * tb:3 * tb + 32]
    edges = [e for e in EDGE_TOPICS if e < k]
    hits = sum(int(peaked[j]) == edges[j % len(edges)] for j in range(32))
    assert hits >= 24, f"only {hits} of 32 draws on the peaked edge topics"
    assert int(znew[4 * tb]) == 0                      # u1 = u2 = 0


@pytest.mark.parametrize("k,w_dtype", [(1024, torch.bfloat16),
                                       (1024, torch.int32),
                                       (256, torch.bfloat16)])
def test_gibbs_docblock_words_equal_gathered_rows(cuda, k, w_dtype):
    """words= reads the mirror's rows inside the kernel: bit for bit the
    gathered form on the rows ``gather_rows`` gives (zero rows for ids
    outside the mirror), in both modes, pads on the scratch row."""
    rng = np.random.default_rng(11 + k)
    nb, tb, maxd, c = 40, 512, 16, k // 128
    v = 5_001
    ndk, _, vec = _docblock_case(rng, nb, tb, maxd, c, torch.int16,
                                 torch.int32)
    sinv, zi, drel, msk, u1, u2 = vec
    mirror = torch.from_numpy(rng.integers(0, 600, (v + 1, c, 128))) \
        .to(w_dtype).to(cuda)
    words = _zipf_ids(rng, nb * tb, v)
    words[msk.numpy() == 0] = v                        # the scratch row
    words[5 * tb:5 * tb + 4] = [-1, v + 1, 2 ** 31 - 1, -(2 ** 31)]
    words = torch.from_numpy(words)
    dev = [x.to(cuda) for x in vec]
    dw = words.to(cuda)
    W3 = tk.gather_rows(mirror, dw).view(-1, c, 128)
    kw = dict(alpha=ALPHA, beta=BETA, tb=tb)
    ndk_g, ndk_w = ndk.clone().to(cuda), ndk.clone().to(cuda)
    _, zg, ng = ls.gibbs_sample_docblock(ndk_g, W3, *dev, **kw)
    before = dict(ls.LAUNCHES)
    _, zw, nw = ls.gibbs_sample_docblock(ndk_w, mirror, *dev, words=dw, **kw)
    assert ls.LAUNCHES["gibbs_sample_docblock"] == \
        before["gibbs_sample_docblock"] + 1
    assert ls.LAUNCHES["gibbs_sample_docblock_rows"] == \
        before["gibbs_sample_docblock_rows"] + 1
    assert torch.equal(zg, zw) and torch.equal(ng, nw)
    assert torch.equal(ndk_g, ndk_w)
    bg, bng = ls.gibbs_sample_docblock_build(W3, *dev, maxd=maxd, **kw)
    bw, bnw = ls.gibbs_sample_docblock_build(mirror, *dev, maxd=maxd,
                                             words=dw, **kw)
    assert torch.equal(bg, bw) and torch.equal(bng, bnw)
    # the plain version raises on the ids outside the mirror; elsewhere
    # it equals the kernel
    with pytest.raises(IndexError):
        ls.gibbs_sample_docblock_plain(ndk.clone(), mirror.cpu(), *vec,
                                       words=words, **kw)
    words[5 * tb:5 * tb + 4] = v
    dw = words.to(cuda)
    ndk_w = ndk.clone().to(cuda)
    _, zw, nw = ls.gibbs_sample_docblock(ndk_w, mirror, *dev, words=dw, **kw)
    p_ndk = ndk.clone()
    _, want, want_nkd = ls.gibbs_sample_docblock_plain(
        p_ndk, mirror.cpu(), *vec, words=words, **kw)
    assert torch.equal(zw.cpu(), want) and torch.equal(nw.cpu(), want_nkd)
    assert torch.equal(ndk_w.cpu(), p_ndk)


def test_sparse_matrix_table_round_trip(cuda):
    rng = np.random.default_rng(9)
    for tiled, updater, dtype in ((False, "default", "int32"),
                                  (True, "default", "int32"),
                                  (True, "sgd", "float32")):
        t = SparseMatrixTable(300, 256, dtype, updater=updater, device=cuda,
                              tiled=tiled, name=f"cuda_sparse_{tiled}")
        ref = np.zeros((300, 256), dtype)
        for _ in range(3):
            n = 3000
            r = np.clip(rng.zipf(1.2, n) - 1, 0, 299)
            c = rng.integers(0, 256, n)
            v = rng.integers(-3, 4, n).astype(dtype)
            t.add_sparse(r, c, v)
            np.add.at(ref, (r, c), v if updater == "default"
                      else np.float32(-0.1) * v)
        q = np.arange(0, 300, 7)
        np.testing.assert_allclose(t.get(), ref, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(t.get_rows(q), ref[q], rtol=1e-6,
                                   atol=1e-6)
        indptr, cols, vals = t.get_rows_sparse(q)
        dense = np.zeros((len(q), 256), dtype)
        for i in range(len(q)):
            dense[i, cols[indptr[i]:indptr[i + 1]]] = \
                vals[indptr[i]:indptr[i + 1]]
        np.testing.assert_array_equal(dense, t.get_rows(q))


def test_lightlda_on_the_card_matches_cpu(cuda, tmp_path):
    """A small doc-blocked and streamed LightLDA on the card against the
    same run on the CPU (plain versions), from the same uniforms."""
    from multiverso_tpu_torch.apps.lightlda import (LDAConfig, LightLDA,
                                                    load_docs)
    from multiverso_tpu_torch.data import synthetic_docs
    path = tmp_path / "docs.txt"
    synthetic_docs(str(path), num_docs=300, vocab_size=500, avg_doc_len=60,
                   num_topics=10, seed=1)
    tw, td, vocab = load_docs(str(path))
    for extra in ({}, {"stream_blocks": True}):
        cfg = LDAConfig(num_topics=256, batch_tokens=4096, steps_per_call=2,
                        seed=2, sampler="tiled", doc_blocked=True,
                        block_tokens=256, block_docs=8, **extra)
        apps = [LightLDA(tw, td, vocab, cfg, device=d) for d in (cuda, "cpu")]
        for _ in range(2):
            for a in apps:
                a.sweep(uniforms=lambda k: apps[1].uniforms(k))
        z = [a._z_numpy() for a in apps]
        assert np.mean(z[0] == z[1]) >= 0.99
        for a in apps:
            nwk = a.word_topics()
            assert nwk.sum() == a.num_tokens
            assert np.array_equal(a.summary.get(), nwk.sum(0))
            assert np.array_equal(a.doc_topics().sum(1),
                                  np.bincount(td, minlength=a.num_docs))


def test_lightlda_mh_on_the_card_matches_cpu(cuda, tmp_path):
    """sampler="mh" on the card against the same run on the CPU, from the
    same uniforms and integers: z agrees on at least 99% of tokens (the
    stale word CDF is a float32 cumulative sum, which the card adds in
    another order, so a target on a boundary can pick the next topic),
    and on each device the counts are exactly those of its own z."""
    from multiverso_tpu_torch.apps.lightlda import (LDAConfig, LightLDA,
                                                    load_docs)
    from multiverso_tpu_torch.data import synthetic_docs
    path = tmp_path / "docs.txt"
    synthetic_docs(str(path), num_docs=300, vocab_size=500, avg_doc_len=60,
                   num_topics=10, seed=1)
    tw, td, vocab = load_docs(str(path))
    cfg = LDAConfig(num_topics=64, batch_tokens=4096, steps_per_call=2,
                    seed=2, sampler="mh")
    apps = [LightLDA(tw, td, vocab, cfg, device=d) for d in (cuda, "cpu")]
    for _ in range(2):
        for a in apps:
            a.sweep(uniforms=apps[1].uniforms, integers=apps[1].integers)
    z = [a._z_numpy() for a in apps]
    assert np.mean(z[0] == z[1]) >= 0.99
    for a, zz in zip(apps, z):
        nwk = a.word_topics()
        mask = a._mask.cpu().numpy().astype(bool)
        want = np.zeros_like(nwk)
        np.add.at(want, (a._tw.cpu().numpy()[mask], zz[mask]), 1)
        assert np.array_equal(nwk, want)
        assert np.array_equal(a.summary.get(), nwk.sum(0))
        assert np.array_equal(a.doc_topics().sum(1),
                              np.bincount(td, minlength=a.num_docs))


LDA_MODES = {
    "gibbs": dict(num_topics=64, batch_tokens=4096, steps_per_call=2),
    "mh": dict(num_topics=64, batch_tokens=4096, steps_per_call=2,
               sampler="mh"),
    "tiled": dict(num_topics=256, batch_tokens=4096, steps_per_call=2,
                  sampler="tiled"),
    "tiled_stale": dict(num_topics=256, batch_tokens=4096, steps_per_call=2,
                        sampler="tiled", stale_words=True),
    "doc_blocked": dict(num_topics=256, batch_tokens=4096, steps_per_call=2,
                        sampler="tiled", doc_blocked=True, block_tokens=256,
                        block_docs=8),
}


@pytest.mark.parametrize("mode", sorted(LDA_MODES))
def test_lightlda_mesh_on_the_card_matches_one_device(cuda, tmp_path, mode):
    """Each mode on a (2, 2) mesh of the card (replica d on cuda:{d %
    cards}) against its (1, 1) run, fed the app's own draws: z, the word
    and doc counts, the summary and the loglik bit for bit after two
    sweeps, and the replicas of the tables and of z identical."""
    from multiverso_tpu_torch import core
    from multiverso_tpu_torch.apps.lightlda import (LDAConfig, LightLDA,
                                                    load_docs)
    from multiverso_tpu_torch.data import synthetic_docs
    path = tmp_path / "docs.txt"
    synthetic_docs(str(path), num_docs=300, vocab_size=500, avg_doc_len=60,
                   num_topics=10, seed=1)
    tw, td, vocab = load_docs(str(path))
    n = torch.cuda.device_count()
    out = []
    for rows in ([["cuda:0"]], [[f"cuda:{d % n}"] * 2 for d in range(2)]):
        app = LightLDA(tw, td, vocab, LDAConfig(seed=2, **LDA_MODES[mode]),
                       mesh=core.Mesh(rows))
        app.train(num_iterations=2)
        for table in (app.word_topic, app.summary):
            for shards in table.replicas[1:]:
                assert all(_same_bits(a, b) for a, b in
                           zip(shards, table.replicas[0]))
        parts = app._z_l.parts
        if not app._docblock:
            assert all(_same_bits(p, parts[0]) for p in parts[1:])
        out.append((app._z_numpy(), app.word_topics(), app.doc_topics(),
                    app.summary.get(), app.ll_history))
    for a, b in zip(out[0][:4], out[1][:4]):
        assert np.array_equal(a, b)
    assert out[0][4] == out[1][4]


def test_streamed_lightlda_on_a_data_axis_matches_one_device(cuda):
    """The streamed doc-blocked mode on a (2, 1) mesh of the card against
    its (1, 1) run: z, the counts, the summary and the loglik bit for bit
    after two sweeps, the replicas identical."""
    from multiverso_tpu_torch import core
    from multiverso_tpu_torch.apps.lightlda import (LDAConfig, LightLDA,
                                                    load_docs)
    from multiverso_tpu_torch.data import synthetic_docs
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/docs.txt"
        synthetic_docs(path, num_docs=300, vocab_size=500, avg_doc_len=60,
                       num_topics=10, seed=1)
        tw, td, vocab = load_docs(path)
    out = []
    for rows in ([["cuda:0"]], [["cuda:0"], ["cuda:0"]]):
        app = LightLDA(tw, td, vocab, LDAConfig(
            seed=2, stream_blocks=True, **LDA_MODES["doc_blocked"]),
            mesh=core.Mesh(rows))
        app.train(num_iterations=2)
        for table in (app.word_topic, app.summary):
            for shards in table.replicas[1:]:
                assert all(_same_bits(a, b) for a, b in
                           zip(shards, table.replicas[0]))
        out.append((app._z_numpy().copy(), app.word_topics(),
                    app.doc_topics(), app.summary.get(), app.ll_history))
    for a, b in zip(out[0][:4], out[1][:4]):
        assert np.array_equal(a, b)
    assert out[0][4] == out[1][4]


# -- KVTable kernels -------------------------------------------------------------

KV_UPDATERS = ["default", "sgd", "adagrad", "momentum", "adam", "ftrl"]
KV_OPTIONS = {
    "default": dict(),
    "sgd": dict(learning_rate=0.05),
    "adagrad": dict(learning_rate=0.1, lam=1e-6),
    "momentum": dict(learning_rate=0.05, momentum=0.9),
    "adam": dict(learning_rate=0.01, momentum=0.9, rho=0.999, lam=1e-8,
                 step=4),
    "ftrl": dict(learning_rate=0.1, lam=0.01, rho=0.001, momentum=1.0),
}


def _split(keys):
    return np.stack([(keys >> np.uint64(32)).astype(np.uint32),
                     (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)],
                    axis=1).view(np.int32)


def _kv_filled(rng, nb, slots, vdim, fill=0.6):
    """Keys int32 [nb, S, 2] with a random prefix of each bucket live,
    float32 values (some -0.0), and the live mask."""
    keys = np.full((nb, slots, 2), -1, np.int32)
    live = rng.random((nb, slots)).cumprod(1) > (1 - fill)
    n_live = int(live.sum())
    ks = np.unique(rng.integers(1, 2 ** 63, size=2 * n_live,
                                dtype=np.uint64))[:n_live]
    keys[live] = _split(ks)
    shape = (nb, slots, vdim) if vdim else (nb, slots)
    vals = rng.standard_normal(shape).astype(np.float32)
    vals.reshape(nb, slots, -1)[rng.random((nb, slots)) < 0.1] = -0.0
    return keys, vals, live


def _kv_batch(rng, keys, live, over, n_pad):
    """Bucket-sorted lanes over every bucket: the live keys of every other
    bucket (matches), up to two new keys per bucket within its empties
    (claims), with ``over`` one more than bucket 0 holds; padding lanes on
    the last bucket."""
    nb, slots = keys.shape[:2]
    q, b = [], []
    fresh = iter(np.unique(rng.integers(1, 2 ** 63, size=4 * nb + 64,
                                        dtype=np.uint64)))
    for bucket in range(nb):
        if bucket % 2 == 0:
            idx = np.nonzero(live[bucket])[0]
            q.append(keys[bucket, idx])
            b.append(np.full(len(idx), bucket))
        empties = slots - int(live[bucket].sum())
        n_new = empties + 1 if over and bucket == 0 \
            else min(empties, int(rng.integers(0, 3)))
        q.append(_split(np.asarray([next(fresh) for _ in range(n_new)],
                                   np.uint64)).reshape(-1, 2))
        b.append(np.full(n_new, bucket))
    query = np.concatenate(q)
    buckets = np.concatenate(b).astype(np.int32)
    order = np.argsort(buckets, kind="stable")
    query = np.concatenate([query[order], np.full((n_pad, 2), -1, np.int32)])
    buckets = np.concatenate([buckets[order],
                              np.full(n_pad, nb - 1, np.int32)])
    valid = np.arange(len(buckets)) < len(order)
    return query, buckets, valid


def _bits(t):
    return t.cpu().contiguous().view(torch.int32)


@pytest.mark.parametrize("vdim", [0, 2, 5])
def test_kv_lookup_matches_cpu_plain(cuda, vdim):
    rng = np.random.default_rng(20 + vdim)
    nb, slots = 2000, 16
    keys, vals, live = _kv_filled(rng, nb, slots, vdim)
    # a NaN in a live slot whose key is not queried: masked out
    nan_b = np.nonzero(live[:, 1])[0][:50]
    vals.reshape(nb, slots, -1)[nan_b, 1] = np.nan
    live_q = live.copy()
    live_q[nan_b, 1] = False
    bb, ss = np.nonzero(live_q)
    missing = _split(np.arange(10 ** 6, 10 ** 6 + 3000, dtype=np.uint64))
    query = np.concatenate([keys[bb, ss], missing])
    buckets = np.concatenate([bb, rng.integers(0, nb, 3000)]).astype(
        np.int32)
    args = [torch.from_numpy(x) for x in (keys, vals, query, buckets)]
    want_v, want_f = tk.kv_lookup_plain(*args, default_value=0.5)
    before = tk.LAUNCHES["kv_lookup"]
    got_v, got_f = tk.kv_lookup(*(x.to(cuda) for x in args),
                                default_value=0.5)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["kv_lookup"] == before + 1
    assert torch.equal(got_f.cpu(), want_f)
    assert torch.equal(_bits(got_v), _bits(want_v))
    assert int(want_f.sum()) == len(bb)


@pytest.mark.parametrize("over", [False, True])
@pytest.mark.parametrize("vdim", [0, 2])
@pytest.mark.parametrize("name", KV_UPDATERS)
def test_kv_probe_update_matches_cpu_plain(cuda, name, vdim, over):
    """Keys, values, state and n_over bit for bit against the plain version
    on the CPU; an overflowing batch leaves the triple unchanged."""
    from multiverso_tpu_torch import updaters as tup
    rng = np.random.default_rng(KV_UPDATERS.index(name) * 4 + vdim + over)
    nb, slots = 512, 8
    keys, vals, live = _kv_filled(rng, nb, slots, vdim)
    query, buckets, valid = _kv_batch(rng, keys, live, over, 5)
    n = len(buckets)
    deltas = rng.standard_normal((n, vdim) if vdim else (n,)).astype(
        np.float32)
    upd = tup.get_updater(name)
    state = {k: torch.from_numpy(np.abs(rng.standard_normal(vals.shape))
                                 .astype(np.float32))
             for k in upd.init_state(torch.from_numpy(vals))}
    opt = tup.AddOption(**KV_OPTIONS[name])
    lanes = [torch.from_numpy(x) for x in (buckets, query, deltas, valid)]
    cpu = (torch.from_numpy(keys.copy()), torch.from_numpy(vals.copy()),
           {k: v.clone() for k, v in state.items()})
    want = tk.kv_probe_update_plain(*cpu, *lanes, opt, name)
    before = dict(tk.LAUNCHES)
    got = tk.kv_probe_update(
        torch.from_numpy(keys.copy()).to(cuda),
        torch.from_numpy(vals.copy()).to(cuda),
        {k: v.clone().to(cuda) for k, v in state.items()},
        *(x.to(cuda) for x in lanes), opt, name)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["kv_probe_update"] == before["kv_probe_update"] + 1
    assert tk.LAUNCHES["kv_commit"] == before["kv_commit"] + 1
    assert int(got[3]) == int(want[3]) == int(over)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(_bits(got[1]), _bits(want[1]))
    for k in state:
        assert torch.equal(_bits(got[2][k]), _bits(want[2][k])), k
    if over:
        assert torch.equal(got[0].cpu(), torch.from_numpy(keys))
        assert torch.equal(got[1].cpu(), torch.from_numpy(vals))
        for k in state:
            assert torch.equal(got[2][k].cpu(), state[k])
    else:
        assert not torch.equal(got[0].cpu(), torch.from_numpy(keys))


def test_kv_table_on_the_card_matches_cpu(cuda):
    """KVTable adds and gets on the card against the same table on the CPU,
    bit for bit, through an overflow and its deferred raise."""
    from multiverso_tpu_torch.tables import KVTable
    rng = np.random.default_rng(30)
    for updater, vdim in (("ftrl", 2), ("adagrad", 0), ("default", 3)):
        tabs = [KVTable(600, value_dim=vdim, slots_per_bucket=4,
                        updater=updater, device=d, name=f"kv_{d}")
                for d in (cuda, "cpu")]
        pool = np.unique(rng.integers(1, 2 ** 40, 900, dtype=np.uint64))
        for step in range(6):
            keys = rng.choice(pool, size=int(rng.integers(50, 300)),
                              replace=False)
            shape = (len(keys), vdim) if vdim else (len(keys),)
            d = rng.standard_normal(shape).astype(np.float32)
            errs = []
            for t in tabs:
                t.add(keys, d)
                try:
                    t.wait()
                    errs.append(None)
                except RuntimeError as e:
                    errs.append(str(e).replace(t.name, "kv"))
            assert errs[0] == errs[1], step
        gpu, host = tabs
        assert torch.equal(gpu.keys.cpu(), host.keys)
        assert torch.equal(_bits(gpu.values), _bits(host.values))
        for k in host.state:
            assert torch.equal(_bits(gpu.state[k]), _bits(host.state[k]))
        q = rng.choice(pool, size=333)
        for a, b in zip(gpu.get(q), host.get(q)):
            assert np.array_equal(a, b)
        assert len(gpu) == len(host)


def test_kv_table_raises_on_other_value_dtypes(cuda):
    """A KVTable of a type the kernels do not take (float64) raises on the
    card, naming the three they take; a float16 one runs."""
    from multiverso_tpu_torch.tables import KVTable
    keys = np.asarray([1, 2], np.uint64)
    t = KVTable(64, value_dim=2, dtype="float64", updater="default",
                device=cuda, name="kv_f64")
    with pytest.raises(TypeError, match="float32, bfloat16, float16"):
        t.add(keys, np.ones((2, 2), np.float64))
    with pytest.raises(TypeError, match="float32, bfloat16, float16"):
        t.get(keys)
    t16 = KVTable(64, value_dim=2, dtype="float16", updater="default",
                  device=cuda, name="kv_f16")
    t16.add(keys, np.ones((2, 2), np.float16))
    assert t16.get_tensor(keys)[0].dtype == torch.float16


KV_DTYPES = [torch.bfloat16, torch.float16]


def _as_kv(vals, dtype):
    """float32 test values as ``dtype`` (rounded once)."""
    return torch.from_numpy(vals).to(dtype)


@pytest.mark.parametrize("dtype", KV_DTYPES)
@pytest.mark.parametrize("vdim", [0, 2])
def test_kv_lookup_two_byte_matches_cpu_plain(cuda, dtype, vdim):
    """The lookup at bfloat16 and float16: the values' type out, bit for
    bit with the plain version, the default rounded to the type."""
    rng = np.random.default_rng(60 + vdim)
    nb, slots = 1500, 16
    keys, vals, live = _kv_filled(rng, nb, slots, vdim)
    bb, ss = np.nonzero(live)
    missing = _split(np.arange(10 ** 6, 10 ** 6 + 500, dtype=np.uint64))
    query = np.concatenate([keys[bb, ss], missing])
    buckets = np.concatenate([bb, rng.integers(0, nb, 500)]).astype(
        np.int32)
    args = [torch.from_numpy(keys), _as_kv(vals, dtype),
            torch.from_numpy(query), torch.from_numpy(buckets)]
    want_v, want_f = tk.kv_lookup_plain(*args, default_value=0.1)
    got_v, got_f = tk.kv_lookup(*(x.to(cuda) for x in args),
                                default_value=0.1)
    assert got_v.dtype == dtype
    assert torch.equal(got_f.cpu(), want_f)
    assert torch.equal(got_v.cpu().view(torch.int16),
                       want_v.view(torch.int16))


@pytest.mark.parametrize("dtype", KV_DTYPES)
@pytest.mark.parametrize("name", KV_UPDATERS)
def test_kv_probe_update_two_byte_matches_cpu_plain(cuda, name, dtype):
    """The probe + commit at bfloat16 and float16 values (state float32,
    as the updaters make it), flat and sharded (2 shards): keys, values
    and state bit for bit against the plain versions."""
    from multiverso_tpu_torch import updaters as tup
    rng = np.random.default_rng(KV_UPDATERS.index(name) * 7 + 3)
    nb, slots, vdim = 512, 8, 2
    keys, vals, live = _kv_filled(rng, nb, slots, vdim)
    query, buckets, valid = _kv_batch(rng, keys, live, False, 5)
    n = len(buckets)
    deltas = rng.standard_normal((n, vdim)).astype(np.float32)
    upd = tup.get_updater(name)
    state = {k: torch.from_numpy(np.abs(rng.standard_normal(vals.shape))
                                 .astype(np.float32))
             for k in upd.init_state(torch.from_numpy(vals))}
    opt = tup.AddOption(**KV_OPTIONS[name])
    lanes = [torch.from_numpy(x) for x in (buckets, query, deltas, valid)]

    def triple(dev):
        return (torch.from_numpy(keys.copy()).to(dev),
                _as_kv(vals, dtype).to(dev),
                {k: v.clone().to(dev) for k, v in state.items()})

    want = tk.kv_probe_update_plain(*triple("cpu"), *lanes, opt, name)
    got = tk.kv_probe_update(*triple(cuda), *(x.to(cuda) for x in lanes),
                             opt, name)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu().view(torch.int16),
                       want[1].view(torch.int16))
    for k in state:
        assert torch.equal(got[2][k].cpu().view(torch.int32),
                           want[2][k].view(torch.int32)), k
    # the sharded form over 2 shards of the same table
    half = nb // 2
    local = lanes[0] % half
    shard = (lanes[0] // half).numpy()
    order = np.argsort(shard, kind="stable")
    counts = [int((shard[valid] == s).sum()) for s in range(2)]

    def rows(x):
        x = x[torch.from_numpy(order)]
        out = torch.zeros((2, n) + tuple(x.shape[1:]), dtype=x.dtype)
        start = 0
        for s in range(2):
            c = int((shard == s).sum())
            out[s, :c] = x[start:start + c]
            start += c
        return out

    sl = [rows(local), rows(lanes[1]), rows(lanes[2]), rows(lanes[3])]
    for dev in ("cpu", cuda):
        k0, v0, s0 = triple(dev)
        ks = [k0[:half].clone(), k0[half:].clone()]
        vs = [v0[:half].clone(), v0[half:].clone()]
        ss = [{k: v[:half].clone() for k, v in s0.items()},
              {k: v[half:].clone() for k, v in s0.items()}]
        tk.kv_probe_update_sharded(ks, vs, ss, *(x.to(dev) for x in sl),
                                   opt, name, counts=counts)
        if dev == "cpu":
            want_sh = (ks, vs, ss)
    torch.cuda.synchronize()
    for a, b in zip(ks + vs, want_sh[0] + want_sh[1]):
        w = torch.int32 if a.dtype in (torch.int32, torch.float32) \
            else torch.int16
        assert torch.equal(a.cpu().view(w), b.view(w))
    for s in range(2):
        for k in state:
            assert torch.equal(ss[s][k].cpu().view(torch.int32),
                               want_sh[2][s][k].view(torch.int32)), (s, k)


@pytest.mark.parametrize("shard_update", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_replicated_kv_table_on_the_card_matches_cpu(cuda, dtype,
                                                     shard_update):
    """A (2, 2) KVTable on cuda:0 (replicas and, under shard_update, state
    blocks) against the same table on a (2, 2) CPU mesh: every replica's
    keys, values and state bit for bit after each add, one probe and one
    commit a card per add, Gets equal to the one-device table's."""
    from multiverso_tpu_torch import core
    from multiverso_tpu_torch.tables import KVTable
    rng = np.random.default_rng(40)
    tabs = [KVTable(1 << 15, value_dim=2, slots_per_bucket=8, updater="adagrad",
                    dtype=dtype, shard_update=shard_update, name=f"kv{i}",
                    mesh=core._build_mesh([d] * 4, 2, 2))
            for i, d in enumerate(("cuda:0", "cpu"))]
    one = KVTable(1 << 15, value_dim=2, slots_per_bucket=8, updater="adagrad",
                  dtype=dtype, device=cuda, name="one")
    pool = np.unique(rng.integers(1, 2 ** 40, 2000, dtype=np.uint64))
    w = torch.int32 if dtype == "float32" else torch.int16
    for step in range(4):
        keys = rng.choice(pool, size=700, replace=False)
        d = rng.standard_normal((700, 2)).astype(np.float32)
        before = dict(tk.LAUNCHES)
        for t in tabs + [one]:
            t.add(keys, d)
        assert tk.LAUNCHES["kv_probe_update"] - before["kv_probe_update"] \
            == 2 and tk.LAUNCHES["kv_commit"] - before["kv_commit"] == 2
        gpu, host = tabs
        gpu.wait()
        for r in range(2):
            for s in range(2):
                assert torch.equal(gpu.replica_keys[r][s].cpu(),
                                   host.replica_keys[r][s])
                assert torch.equal(gpu.replica_values[r][s].cpu().view(w),
                                   host.replica_values[r][s].view(w))
                for k, leaf in host.replica_states[r][s].items():
                    assert torch.equal(
                        gpu.replica_states[r][s][k].cpu().view(torch.int32),
                        leaf.view(torch.int32))
        q = rng.choice(pool, size=500)
        a, b = gpu.get_tensor(q), one.get_tensor(q)
        assert torch.equal(a[0].view(w), b[0].view(w))
        assert torch.equal(a[1], b[1])


def test_sparse_logreg_on_the_card_matches_cpu(cuda):
    """Two minibatches on the card and on the CPU from the same rows: keys
    bit for bit; losses and values within rtol 1e-5 (the step's einsum
    sums a sample's features in another order on the card)."""
    from multiverso_tpu_torch.apps.sparse_logreg import (
        SparseLogisticRegression, SparseLRConfig, synthetic_sparse)
    rows, y = synthetic_sparse(n=512, dim=20_000, num_classes=2, nnz=12,
                               seed=5)
    cfg = SparseLRConfig(max_features=16, capacity=1 << 14,
                         minibatch_size=256, updater="ftrl")
    apps = [SparseLogisticRegression(cfg, device=d, name=f"slr_{d}")
            for d in (cuda, "cpu")]
    for s in (0, 256):
        losses = [a.train_batch(rows[s:s + 256], y[s:s + 256])
                  for a in apps]
        assert losses[0] == pytest.approx(losses[1], rel=1e-5)
    gpu, host = (a.table for a in apps)
    assert torch.equal(gpu.keys.cpu(), host.keys)
    np.testing.assert_allclose(gpu.values.cpu().numpy(),
                               host.values.numpy(), rtol=1e-5, atol=1e-6)


# -- sharded forms and sharded tables ------------------------------------------


def _mesh(devices):
    from multiverso_tpu_torch import core
    return core.Mesh([list(devices)])


def _slice_lanes(global_ids, per_shard, shards, arrays, pads):
    """Shard-sorted global ids -> the (shards, L) lane slices of local ids
    (``hashing.shard_lane_slices``), valid and the real-lane counts."""
    from multiverso_tpu_torch.tables.hashing import shard_lane_slices
    shard_ids = global_ids // per_shard
    local = (global_ids - shard_ids * per_shard).astype(np.int32)
    sliced, valid, pos = shard_lane_slices(
        shard_ids, shards, [local, *arrays], [np.int32(per_shard - 1), *pads])
    return sliced, valid, valid.sum(1), shard_ids, pos


def _on(x, dev, shards=None):
    """A copy of ``x`` on ``dev``, or cut into ``shards`` row blocks."""
    t = torch.tensor(np.ascontiguousarray(x))
    if shards is None:
        return t.to(dev)
    return [b.contiguous().to(dev) for b in t.chunk(shards)]


@pytest.mark.parametrize("cols,tiles,dtype", [
    (100, 0, np.float32), (100, 0, np.int32), (1024, 8, np.int32),
    (256, 2, np.float32)])
def test_sharded_row_and_coo_forms_match_cpu_plain(cuda, cols, tiles, dtype):
    """Four virtual shards on one card: each form launched over the real
    lanes of its shards equals its plain version over the full (S, L)
    layout on the CPU, bit for bit; the row gather, scatter-add and COO
    add launch once per card (the scatters counted under the masked
    kernel's name too, the gather not under the flat gather's)."""
    rng = np.random.default_rng(cols + tiles)
    S, rows, n = 4, 2000, 24_576
    rps = rows // S
    param = (rng.standard_normal((rows, cols)) * 4).astype(dtype)
    if tiles:
        param = param.reshape(rows, tiles, 128)
    ids = _zipf_ids(rng, n, rows)
    # gather: request order, unpermuted through inv
    order = np.argsort(ids // rps, kind="stable")
    (local,), valid, counts, sh, pos = _slice_lanes(ids[order], rps, S,
                                                    [], [])
    inv = np.zeros(n, np.int32)
    inv[order] = sh * local.shape[1] + pos
    before = dict(tk.LAUNCHES)
    got = tk.gather_rows_sharded(_on(param, cuda, S), _on(local, cuda),
                                 _on(inv, cuda), counts=counts)
    want = tk.gather_rows_sharded_plain(_on(param, "cpu", S),
                                        _on(local, "cpu"), _on(inv, "cpu"))
    assert torch.equal(got.cpu(), want)
    assert tk.LAUNCHES["row_gather"] == before["row_gather"]
    assert tk.LAUNCHES["row_gather_sharded"] == \
        before["row_gather_sharded"] + 1
    # the row scatter-add over sorted ids
    sids = np.sort(ids)
    deltas = (rng.standard_normal((n, cols)) * 3).astype(dtype)
    (local, sd), valid, counts, _, _ = _slice_lanes(sids, rps, S, [deltas],
                                                    [0])
    shards = _on(param, cuda, S)
    tk.row_scatter_add_sharded(shards, _on(local, cuda), _on(sd, cuda),
                               _on(valid, cuda), counts=counts)
    host = _on(param, "cpu", S)
    tk.row_scatter_add_sharded_plain(host, _on(local, "cpu"), _on(sd, "cpu"),
                                     _on(valid, "cpu"))
    torch.cuda.synchronize()
    for a, b in zip(shards, host):
        assert torch.equal(a.cpu(), b)
    for name in ("row_scatter_add_sharded", "row_scatter_add_masked"):
        assert tk.LAUNCHES[name] == before[name] + 1
    # the COO add over row-sorted lanes
    c = rng.integers(0, cols, n).astype(np.int32)
    v = rng.integers(-3, 4, n).astype(dtype)
    (lr, sc, sv), valid, counts, _, _ = _slice_lanes(
        sids, rps, S, [c, v], [np.int32(0), 0])
    shards = _on(param, cuda, S)
    tk.coo_scatter_add_sharded(shards, *(_on(x, cuda)
                                         for x in (lr, sc, sv, valid)),
                               counts=counts)
    host = _on(param, "cpu", S)
    tk.coo_scatter_add_sharded_plain(host, *(_on(x, "cpu")
                                             for x in (lr, sc, sv, valid)))
    torch.cuda.synchronize()
    for a, b in zip(shards, host):
        assert torch.equal(a.cpu(), b)
    for name in ("coo_scatter_add_sharded", "coo_scatter_add_masked"):
        assert tk.LAUNCHES[name] == before[name] + 1


@pytest.mark.parametrize("over", [False, True])
@pytest.mark.parametrize("name", KV_UPDATERS)
def test_sharded_kv_forms_match_cpu_plain(cuda, name, over):
    """Probe + commit and lookup on four virtual shards against the plain
    versions on the CPU, bit for bit; a batch that overflows one bucket of
    shard 0 leaves all four shards untouched, with the global count."""
    from multiverso_tpu_torch import updaters as tup
    rng = np.random.default_rng(KV_UPDATERS.index(name) * 2 + over)
    S, nb, slots, vdim = 4, 512, 8, 2
    bps = nb // S
    keys, vals, live = _kv_filled(rng, nb, slots, vdim)
    query, buckets, _ = _kv_batch(rng, keys, live, over, 0)
    n = len(buckets)
    deltas = rng.standard_normal((n, vdim)).astype(np.float32)
    (lb, lq, ld), valid, counts, _, _ = _slice_lanes(
        buckets, bps, S, [query, deltas], [np.int32(-1), 0])
    upd = tup.get_updater(name)
    state = {k: np.abs(rng.standard_normal(vals.shape)).astype(np.float32)
             for k in upd.init_state(torch.from_numpy(vals))}
    opt = tup.AddOption(**KV_OPTIONS[name])

    def triple(dev):
        return (_on(keys, dev, S), _on(vals, dev, S),
                [{k: sh for k, sh in zip(state, parts)}
                 for parts in zip(*(_on(state[k], dev, S) for k in state))]
                if state else [{} for _ in range(S)])

    gk, gv, gs = triple(cuda)
    hk, hv, hs = triple("cpu")
    before = dict(tk.LAUNCHES)
    n_over = tk.kv_probe_update_sharded(
        gk, gv, gs, *(_on(x, cuda) for x in (lb, lq, ld, valid)), opt, name,
        counts=counts)[3]
    want = tk.kv_probe_update_sharded_plain(
        hk, hv, hs, *(_on(x, "cpu") for x in (lb, lq, ld, valid)), opt,
        name)[3]
    torch.cuda.synchronize()
    assert int(n_over) == int(want) and (int(want) > 0) == over
    # once per card: the four shards share one probe and one commit
    assert tk.LAUNCHES["kv_probe_update"] == before["kv_probe_update"] + 1
    assert tk.LAUNCHES["kv_commit"] == before["kv_commit"] + 1
    assert tk.LAUNCHES["kv_probe_update_sharded"] == \
        before["kv_probe_update_sharded"] + 1
    for s in range(S):
        assert torch.equal(gk[s].cpu(), hk[s])
        assert torch.equal(_bits(gv[s]), _bits(hv[s]))
        for k in state:
            assert torch.equal(_bits(gs[s][k]), _bits(hs[s][k]))
    if over:
        assert torch.equal(torch.cat(hk), torch.from_numpy(keys))
        assert torch.equal(torch.cat(hv), torch.from_numpy(vals))
    # lookup of every batch key from the updated shards
    order = np.arange(n)
    (lb2, lq2), _, _, sh, pos = _slice_lanes(
        buckets, bps, S, [query], [np.int32(-1)])
    inv = sh * lb2.shape[1] + pos
    got = tk.kv_lookup_sharded(gk, gv, _on(lq2, cuda), _on(lb2, cuda),
                               _on(inv[order], cuda), 0.5)
    want = tk.kv_lookup_sharded_plain(hk, hv, _on(lq2, "cpu"),
                                      _on(lb2, "cpu"), _on(inv, "cpu"), 0.5)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(_bits(got[0]), _bits(want[0]))


@pytest.mark.parametrize("vdim", [0, 2])
@pytest.mark.parametrize("S", [4, 20])
def test_kv_lookup_once_per_card_matches_plain_on_every_lane(cuda, S, vdim):
    """The sharded lookup on S shards of one card: one ``mv_kv_lookup``
    launch per group of 16 shards, equal to the plain version bit for bit
    on every lane of ``inv``: shard 0 has no real lanes, so ``inv``'s pow2
    padding names its padding lane (query (-1, -1)), and S more lanes name
    each shard's last lane; stored -0.0 values, and a NaN in a live slot
    no query matches. The flat lookup (the same kernel, one shard, no
    ``inv``) on the table concatenated gives the caller lanes' bits."""
    rng = np.random.default_rng(10 * S + vdim)
    bps, slots = 64, 16
    nb = S * bps
    keys, vals, live = _kv_filled(rng, nb, slots, vdim)
    keys[bps - 1, -1], live[bps - 1, -1] = -1, False   # padding matches
    nan_b = np.nonzero(live[:, 1])[0][:20]
    vals.reshape(nb, slots, -1)[nan_b, 1] = np.nan
    queried = live.copy()
    queried[:bps] = False
    queried[nan_b, 1] = False
    bb, ss = np.nonzero(queried)
    missing = _split(np.arange(10 ** 6, 10 ** 6 + 500, dtype=np.uint64))
    q = np.concatenate([keys[bb, ss], missing])
    gb = np.concatenate([bb, rng.integers(bps, nb, 500)]).astype(np.int32)
    perm = rng.permutation(len(gb))
    q, gb = q[perm], gb[perm]
    order = np.argsort(gb // bps, kind="stable")
    (lb, lq), valid, counts, sh, pos = _slice_lanes(
        gb[order], bps, S, [q[order]], [np.int32(-1)])
    L, n = lb.shape[1], len(gb)
    inv = np.zeros(1 << (n + S - 1).bit_length(), np.int32)
    inv[order] = sh * L + pos
    inv[n:n + S] = np.arange(S) * L + L - 1
    assert counts[0] == 0 and len(inv) > n + S
    gk, gv = _on(keys, cuda, S), _on(vals, cuda, S)
    before = dict(tk.LAUNCHES)
    got_v, got_f = tk.kv_lookup_sharded(gk, gv, _on(lq, cuda),
                                        _on(lb, cuda), _on(inv, cuda), 0.5)
    want_v, want_f = tk.kv_lookup_sharded_plain(
        _on(keys, "cpu", S), _on(vals, "cpu", S), _on(lq, "cpu"),
        _on(lb, "cpu"), _on(inv, "cpu"), 0.5)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["kv_lookup"] == before["kv_lookup"] + (S + 15) // 16
    assert tk.LAUNCHES["kv_lookup_sharded"] == \
        before["kv_lookup_sharded"] + 1
    assert got_v.shape == want_v.shape and len(got_f) == len(inv)
    assert torch.equal(got_f.cpu(), want_f)
    assert torch.equal(_bits(got_v), _bits(want_v))
    assert bool(want_f[n + S:].all()) and int(want_f[:n].sum()) == len(bb)
    flat_v, flat_f = tk.kv_lookup(*(_on(x, cuda) for x in (keys, vals, q,
                                                           gb)), 0.5)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["kv_lookup"] == before["kv_lookup"] + (S + 15) // 16 + 1
    assert torch.equal(flat_f.cpu(), want_f[:n])
    assert torch.equal(_bits(flat_v), _bits(want_v[:n]))


def _kv_scattered(rng, nb, slots, vdim):
    """Keys int32 [nb, S, 2] with a random half of each bucket's slots
    live, empties scattered through the row; float32 values."""
    keys = np.full((nb, slots, 2), -1, np.int32)
    live = rng.random((nb, slots)) < 0.5
    n_live = int(live.sum())
    ks = np.unique(rng.integers(1, 2 ** 63, size=2 * n_live,
                                dtype=np.uint64))[:n_live]
    rng.shuffle(ks)
    keys[live] = _split(ks)
    shape = (nb, slots, vdim) if vdim else (nb, slots)
    return keys, rng.standard_normal(shape).astype(np.float32), live


def _kv_runs(rng, keys, live, over, n_pad):
    """Bucket-sorted lanes in batch order within each bucket: in every
    third bucket its live keys and a run of new keys that fills it
    exactly, in the others some live keys and a shorter run; with
    ``over`` one bucket gets two new keys more than it has empties. The
    last bucket's real lanes come before the padding on it."""
    nb, slots = keys.shape[:2]
    fresh = iter(np.unique(rng.integers(1, 2 ** 63, size=slots * nb + 64,
                                        dtype=np.uint64)))
    q, b = [], []
    overflowing = int(rng.integers(0, nb)) if over else -1
    for bucket in range(nb):
        idx = np.flatnonzero(live[bucket])
        idx = idx if bucket % 3 == 0 else idx[rng.random(len(idx)) < 0.5]
        empties = slots - int(live[bucket].sum())
        n_new = empties if bucket % 3 == 0 else int(
            rng.integers(0, empties + 1))
        if bucket == overflowing:
            n_new = empties + 2
        new = _split(np.asarray([next(fresh) for _ in range(n_new)],
                                np.uint64)).reshape(-1, 2)
        lanes = np.concatenate([keys[bucket, idx], new])
        q.append(lanes[rng.permutation(len(lanes))])
        b.append(np.full(len(lanes), bucket))
    query = np.concatenate(q)
    buckets = np.concatenate(b).astype(np.int32)
    query = np.concatenate([query, np.full((n_pad, 2), -1, np.int32)])
    buckets = np.concatenate([buckets, np.full(n_pad, nb - 1, np.int32)])
    valid = np.arange(len(buckets)) < len(buckets) - n_pad
    return query, buckets, valid


@pytest.mark.parametrize("over", [False, True])
@pytest.mark.parametrize("name", KV_UPDATERS)
@pytest.mark.parametrize("vdim", [0, 2, 8])
@pytest.mark.parametrize("slots", [8, 16, 40])
def test_kv_probe_commit_at_every_width_match_cpu_plain(cuda, slots, vdim,
                                                         name, over):
    """mv_kv_probe + mv_kv_commit at 8, 16 and 40 slots a bucket (a half
    warp, a warp, chunks of 32 slots per lane) and 1, 2 and 8 value
    columns, on rows with scattered empties and runs that fill a bucket
    exactly: keys, values, state and n_over bit for bit against the plain
    version on the CPU (the flat form given only the real lanes, the plain
    version the padded batch) and the sharded form four shards on the
    card; an overflowing batch writes nothing."""
    from multiverso_tpu_torch import updaters as tup
    rng = np.random.default_rng(slots * 100 + vdim * 10
                                + KV_UPDATERS.index(name) * 2 + over)
    nb, S = 256, 4
    keys, vals, live = _kv_scattered(rng, nb, slots, vdim)
    query, buckets, valid = _kv_runs(rng, keys, live, over, 7)
    n, real = len(buckets), int(valid.sum())
    deltas = rng.standard_normal((n, vdim) if vdim else (n,)).astype(
        np.float32)
    upd = tup.get_updater(name)
    state = {k: np.abs(rng.standard_normal(vals.shape)).astype(np.float32)
             for k in upd.init_state(torch.from_numpy(vals))}
    opt = tup.AddOption(**KV_OPTIONS[name])
    lanes = [torch.from_numpy(x) for x in (buckets, query, deltas, valid)]

    def triple(dev):
        return (torch.from_numpy(keys.copy()).to(dev),
                torch.from_numpy(vals.copy()).to(dev),
                {k: torch.from_numpy(v.copy()).to(dev)
                 for k, v in state.items()})

    want = tk.kv_probe_update_plain(*triple("cpu"), *lanes, opt, name)
    assert (int(want[3]) > 0) == over
    before = dict(tk.LAUNCHES)
    got = tk.kv_probe_update(*triple(cuda),
                             *(x[:real].to(cuda) for x in lanes), opt, name)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["kv_probe_update"] == before["kv_probe_update"] + 1
    assert tk.LAUNCHES["kv_commit"] == before["kv_commit"] + 1
    assert int(got[3]) == int(want[3])
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(_bits(got[1]), _bits(want[1]))
    for k in state:
        assert torch.equal(_bits(got[2][k]), _bits(want[2][k])), k
    if over:
        assert torch.equal(got[0].cpu(), torch.from_numpy(keys))

    # the same batch on four shards of the card
    bps = nb // S
    (lb, lq, ld), svalid, counts, _, _ = _slice_lanes(
        buckets[:real], bps, S, [query[:real], deltas[:real]],
        [np.int32(-1), 0])
    split = [(_on(keys, d, S), _on(vals, d, S),
              [{k: sh for k, sh in zip(state, parts)}
               for parts in zip(*(_on(state[k], d, S) for k in state))]
              if state else [{} for _ in range(S)])
             for d in (cuda, "cpu")]
    ops = lambda d: [_on(x, d) for x in (lb, lq, ld, svalid)]
    g_over = tk.kv_probe_update_sharded(*split[0], *ops(cuda), opt, name,
                                        counts=counts)[3]
    h_over = tk.kv_probe_update_sharded_plain(*split[1], *ops("cpu"), opt,
                                              name)[3]
    torch.cuda.synchronize()
    assert int(g_over) == int(h_over) == int(want[3])
    for s in range(S):
        assert torch.equal(split[0][0][s].cpu(), split[1][0][s])
        assert torch.equal(_bits(split[0][1][s]), _bits(split[1][1][s]))
        for k in state:
            assert torch.equal(_bits(split[0][2][s][k]),
                               _bits(split[1][2][s][k])), k
    assert torch.equal(torch.cat(split[1][0]), want[0])


def test_sharded_forms_count_only_real_launches(cuda):
    """A sharded form counts its launches under its own name, and nothing
    when no shard has a real lane; the row scatter-add launches once per
    card over the shards with real lanes, counted under the masked
    kernel's name too; a one-shard table's row add goes through the
    sharded form, one launch."""
    S, rps, cols = 4, 8, 4
    shards = [torch.zeros(rps, cols, device=cuda) for _ in range(S)]
    ids = torch.zeros(S, 8, dtype=torch.int32, device=cuda)
    inv = torch.zeros(8, dtype=torch.int32, device=cuda)
    deltas = torch.ones(S, 8, cols, device=cuda)
    valid = torch.zeros(S, 8, dtype=torch.bool, device=cuda)
    before = dict(tk.LAUNCHES)
    tk.gather_rows_sharded(shards, ids, inv, counts=[0] * S)
    tk.row_scatter_add_sharded(shards, ids, deltas, valid, counts=[0] * S)
    assert tk.LAUNCHES == before
    valid[2, :3] = True
    tk.row_scatter_add_sharded(shards, ids, deltas, valid,
                               counts=[0, 0, 3, 0])
    torch.cuda.synchronize()
    assert float(shards[2][0, 0]) == 3.0
    assert tk.LAUNCHES["row_scatter_add_masked"] == \
        before["row_scatter_add_masked"] + 1
    assert tk.LAUNCHES["row_scatter_add_sharded"] == \
        before["row_scatter_add_sharded"] + 1
    t = MatrixTable(30, cols, device=cuda, name="one_shard")
    t.add_rows([1, 1, 7], np.ones((3, cols), np.float32))
    assert tk.LAUNCHES["row_scatter_add_masked"] == \
        before["row_scatter_add_masked"] + 2
    assert tk.LAUNCHES["row_scatter_add_sharded"] == \
        before["row_scatter_add_sharded"] + 2
    assert t.get_rows([1, 7]).tolist() == [[2.0] * cols, [1.0] * cols]


def _sharded_vs_unsharded(cuda_devices, flat_device):
    """Sharded tables on ``cuda_devices`` against the unsharded tables of
    the same geometry on ``flat_device``: bit-identical logical regions."""
    from multiverso_tpu_torch.tables import KVTable
    rng = np.random.default_rng(len(cuda_devices))
    mesh = _mesh(cuda_devices)
    S = len(cuda_devices)
    for updater in ("default", "adagrad"):
        a = MatrixTable(1001, 100, updater=updater, mesh=mesh, name="mt_s")
        b = MatrixTable(1001, 100, updater=updater, device=flat_device,
                        name="mt_f")
        for _ in range(3):
            ids = _zipf_ids(rng, 4096, 1001)
            if updater == "adagrad":
                ids = np.unique(ids)
            d = rng.standard_normal((len(ids), 100)).astype(np.float32)
            a.add_rows(ids, d)
            b.add_rows(ids, d)
        q = _zipf_ids(rng, 3000, 1001)
        assert np.array_equal(a.get(), b.get())
        assert np.array_equal(a.get_rows(q), b.get_rows(q))
    for tiled in (False, True):
        a = SparseMatrixTable(999, 256, "int32", tiled=tiled, mesh=mesh,
                              name="st_s")
        b = SparseMatrixTable(999, 256, "int32", tiled=tiled,
                              device=flat_device, name="st_f")
        r = _zipf_ids(rng, 50_000, 999)
        c = rng.integers(0, 256, 50_000)
        v = rng.integers(-3, 4, 50_000)
        a.add_sparse(r, c, v)
        b.add_sparse(r, c, v)
        assert np.array_equal(a.get(), b.get())
    a = KVTable(1 << 14, value_dim=2, slots_per_bucket=4, updater="ftrl",
                mesh=mesh, name="kv_s")
    b = KVTable(a.num_buckets * 4, value_dim=2, slots_per_bucket=4,
                updater="ftrl", device=flat_device, name="kv_f")
    pool = np.unique(rng.integers(1, 2 ** 40, 20_000, dtype=np.uint64))
    errs = []
    for step in range(4):
        keys = rng.choice(pool, 6000, replace=False)
        d = rng.standard_normal((6000, 2)).astype(np.float32)
        for t in (a, b):
            t.add(keys, d)
        for t in (a, b):
            try:
                t.wait()
                errs.append(None)
            except RuntimeError as e:
                errs.append(str(e).replace(t.name, "kv"))
        assert errs[-1] == errs[-2], step
    for x, y in zip(a.global_arrays()[:2], b.global_arrays()[:2]):
        assert torch.equal(_bits(x), _bits(y))
    q = rng.choice(pool, 5000)
    for x, y in zip(a.get(q), b.get(q)):
        assert np.array_equal(x, y)
    assert len(a) == len(b)
    assert [str(k.device) for k in a.key_shards] == \
        [str(torch.device(d)) for d in cuda_devices]


def test_sharded_tables_on_one_card_match_unsharded(cuda):
    _sharded_vs_unsharded(["cuda:0"] * 4, cuda)


def test_launch_on_a_second_card(cuda):
    """Kernels launch on their operands' card and its stream while another
    card is current; shards spread over two cards equal the unsharded
    tables on the CPU."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second card")
    torch.cuda.set_device(0)
    p = torch.arange(40, dtype=torch.float32).view(10, 4)
    ids = torch.tensor([3, 3, 9, 0], dtype=torch.int32)
    got = tk.gather_rows(p.to("cuda:1"), ids.to("cuda:1"))
    assert got.device == torch.device("cuda", 1)
    assert torch.equal(got.cpu(), tk.gather_rows_plain(p, ids))
    _sharded_vs_unsharded(["cuda:0", "cuda:1"], "cpu")


# -- the functional forms over a ShardedParam (the superstep's mesh path) -----


def _mesh_param(x, devices):
    """A global CPU tensor as a ShardedParam of equal row blocks, block s
    on devices[s]."""
    return tk.ShardedParam(b.to(d, copy=True)
                           for b, d in zip(x.chunk(len(devices)), devices))


def _mesh_host(param):
    return torch.cat([t.cpu() for t in param.shards])


@pytest.mark.parametrize("devices", [["cuda:0"] * 4, ["cuda:0"] * 2])
def test_mesh_forms_match_cpu_plain(cuda, devices):
    """Gather, row scatter-add (float32, int32) and COO add (int32 flat
    and tiled, float32) over S shards on the card, bit for bit against
    the plain versions on the CPU shards; one gather and one scatter-add
    launch per card."""
    rng = np.random.default_rng(len(devices))
    cpus = ["cpu"] * len(devices)
    rows = 10_004
    x = torch.from_numpy(rng.standard_normal((rows, 100)).astype(
        np.float32))
    for n in (4096, 24_576):
        ids = torch.from_numpy(_zipf_ids(rng, n, rows - 1))
        ids[:4] = torch.tensor([rows - 1, 2500, 2501, 0])  # shard edges
        tk.reset_launches()
        got = tk.gather_rows(_mesh_param(x, devices), ids.to(cuda))
        assert tk.LAUNCHES["gather_rows_mesh"] == len(set(devices))
        assert torch.equal(got.cpu(), x[ids.long()])
        d = torch.from_numpy(rng.standard_normal((n, 100)).astype(
            np.float32))
        param = _mesh_param(x, devices)
        tk.row_scatter_add(param, ids.to(cuda), d.to(cuda))
        want = tk.row_scatter_add(_mesh_param(x, cpus), ids, d)
        torch.cuda.synchronize()
        assert torch.equal(_mesh_host(param), _mesh_host(want))
        assert tk.LAUNCHES["row_scatter_add_mesh"] == len(set(devices))
        # the same lanes through the flat kernel on the whole table
        flat = tk.row_scatter_add(x.to(cuda), ids.to(cuda), d.to(cuda))
        assert torch.equal(flat.cpu(), _mesh_host(param))
    xi = torch.from_numpy(rng.integers(-9, 9, (300, 256)).astype(np.int32))
    di = torch.from_numpy(rng.integers(-3, 4, (5000, 256)).astype(np.int32))
    ids = torch.from_numpy(_zipf_ids(rng, 5000, 300))
    param = _mesh_param(xi, devices)
    tk.row_scatter_add(param, ids.to(cuda), di.to(cuda))
    assert torch.equal(_mesh_host(param),
                       tk.row_scatter_add_plain(xi.clone(), ids, di))
    for dtype, shape, n in ((torch.int32, (50_004, 1024), 512_000),
                            (torch.int32, (304, 8, 128), 20_000),
                            (torch.float32, (300, 2, 128), 20_000)):
        r = torch.from_numpy(np.clip(rng.zipf(1.1, n) - 1, 0,
                                     shape[0] - 1).astype(np.int32))
        c = torch.from_numpy(rng.integers(0, int(np.prod(shape[1:])), n)
                             .astype(np.int32))
        v = torch.from_numpy(rng.integers(-2, 3, n).astype(np.float32))
        p0 = torch.from_numpy(rng.integers(0, 5, shape)).to(dtype)
        param = _mesh_param(p0, devices)
        tk.coo_scatter_add(param, r.to(cuda), c.to(cuda), v.to(cuda))
        want = tk.coo_scatter_add(_mesh_param(p0, cpus), r, c, v)
        torch.cuda.synchronize()
        assert torch.equal(_mesh_host(param), _mesh_host(want)), (dtype,
                                                                  shape)


def test_mesh_gather_leaves_foreign_lanes_to_their_shard(cuda):
    """Out-of-range ids: zero rows, as the flat kernel gives them; every
    other lane comes from the shard that owns it."""
    x = torch.arange(80, dtype=torch.float32).view(20, 4) + 1.0
    ids = torch.tensor([19, -1, 0, 20, 7, 5, 5], dtype=torch.int32)
    got = tk.gather_rows(_mesh_param(x, ["cuda:0"] * 4), ids.to(cuda)).cpu()
    flat = tk.gather_rows(x.to(cuda), ids.to(cuda)).cpu()
    assert torch.equal(got, flat)
    assert got[1].abs().sum() == 0 and got[3].abs().sum() == 0


def test_mesh_word2vec_on_one_card_matches_one_shard(cuda, tmp_path):
    """Skip-gram NS and CBOW HS at a small width on a (1, 4) mesh of
    cuda:0: the tables equal the (1, 1) run's bit for bit, and each
    gather and each scatter-add launches once per card."""
    from multiverso_tpu_torch import core
    from multiverso_tpu_torch.apps.word_embedding import (W2VConfig,
                                                          WordEmbedding)
    from multiverso_tpu_torch.data import Corpus, synthetic_text
    path = str(tmp_path / "c.txt")
    synthetic_text(path, num_tokens=40_000, vocab_size=500, seed=3)
    for model, objective in (("skipgram", "ns"), ("cbow", "hs")):
        out = []
        for mesh in (core.Mesh([["cuda:0"]]), core.Mesh([["cuda:0"] * 4])):
            corpus = Corpus.from_file(path, min_count=1)
            app = WordEmbedding(corpus, W2VConfig(
                embedding_dim=100, model=model, objective=objective,
                batch_size=256, steps_per_call=4, seed=3), mesh=mesh)
            tk.reset_launches()
            app.train(total_steps=8)
            out.append((app.w_in.get(), app.w_out.get(), dict(tk.LAUNCHES)))
        for a, b in zip(out[0][:2], out[1][:2]):
            assert a.tobytes() == b.tobytes()
        one, four = out[0][2], out[1][2]
        assert four["gather_rows_mesh"] == one["row_gather"] > 0
        assert four["row_scatter_add_mesh"] == one["row_scatter_add"]
        assert four["row_gather"] == four["row_scatter_add"] == 0


# -- the per-card sharded row forms at the splits they make risky ------------


ROW_SPLITS = ["zipf", "empty_shard", "one_shard", "single", "edges"]


def _split_ids(case, rng, shards, rps):
    """Global ids in request order for one split: Zipf over the table, no
    lane on shard 1, every lane on shard 2, one lane, or runs on each
    shard's last row (beside its pads) and neighbouring shards that hold
    equal local ids (shard 0 ends and shard 1 starts on local rps - 1,
    shard 2 ends and shard 3 starts on local 0 ... )."""
    top = shards * rps
    if case == "zipf":
        ids = _zipf_ids(rng, 3000, top)
    elif case == "empty_shard":
        ids = rng.integers(0, top, 2000)
        ids = ids[ids // rps != 1]
    elif case == "one_shard":
        ids = rng.integers(2 * rps, 3 * rps, 1500)
    elif case == "single":
        ids = np.asarray([rps + 3])
    else:
        e = rps - 1
        ids = np.tile([3, e, e, rps + e, rps + e, 2 * rps, 2 * rps + e,
                       3 * rps, 3 * rps, 3 * rps + 5], 40)
    return rng.permutation(ids).astype(np.int32)


def _random_bits(rng, shape, dtype):
    """Every bit pattern of the type (NaNs and -0.0 included)."""
    width = torch.empty((), dtype=dtype).element_size()
    ints = rng.integers(-2 ** (8 * width - 1), 2 ** (8 * width - 1), shape,
                        dtype=np.int16 if width == 2 else np.int32)
    return torch.from_numpy(ints).view(dtype)


def _same_bits(a, b):
    width = a.element_size()
    kind = torch.int16 if width == 2 else torch.int32
    return torch.equal(a.cpu().contiguous().view(kind),
                       b.cpu().contiguous().view(kind))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32,
                                   torch.bfloat16, torch.int16])
@pytest.mark.parametrize("cols", [3, 100, 101, 1024])
def test_mesh_gather_matches_plain_at_every_split(cuda, cols, dtype):
    """mv_row_gather_mesh in both lane forms (global ids over a
    ShardedParam; the host-sliced (S, L) lanes with ``inv``) against the
    plain versions on the CPU, bit for bit, one launch per card: 4-byte
    rows and 2-byte rows (widths 3 and 101 take the narrow units)."""
    rng = np.random.default_rng(cols + dtype.itemsize)
    S, rps = 4, 250
    x = _random_bits(rng, (S * rps, cols), dtype)
    for case in ROW_SPLITS:
        ids = _split_ids(case, rng, S, rps)
        tk.reset_launches()
        got = tk.gather_rows(_mesh_param(x, ["cuda:0"] * S),
                             torch.from_numpy(ids).to(cuda))
        assert _same_bits(got, x[torch.from_numpy(ids).long()]), case
        order = np.argsort(ids // rps, kind="stable")
        (local,), valid, counts, sh, pos = _slice_lanes(ids[order], rps, S,
                                                        [], [])
        inv = np.zeros(len(ids), np.int32)
        inv[order] = sh * local.shape[1] + pos
        got = tk.gather_rows_sharded([b.contiguous().to(cuda)
                                      for b in x.chunk(S)],
                                     _on(local, cuda), _on(inv, cuda),
                                     counts=counts)
        want = tk.gather_rows_sharded_plain(list(x.chunk(S)),
                                            torch.from_numpy(local),
                                            torch.from_numpy(inv))
        assert _same_bits(got, want), case
        assert tk.LAUNCHES["gather_rows_mesh"] == 1
        assert tk.LAUNCHES["row_gather_sharded"] == 1
        assert tk.LAUNCHES["row_gather"] == 0


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("cols", [3, 100, 101, 1024])
def test_sliced_scatter_matches_plain_at_every_split(cuda, cols, dtype):
    """The sharded row scatter-add, one launch per card over each shard's
    real lanes (``valid`` 0 on a fifth of them), against its plain version
    on the CPU and against the flat masked kernel on the whole table with
    global ids, bit for bit."""
    rng = np.random.default_rng(3 * cols + (dtype == np.int32))
    S, rps = 4, 250
    x = (_mixed(rng, (S * rps, cols)) if dtype == np.float32
         else rng.integers(-9, 9, (S * rps, cols)).astype(dtype))
    for case in ROW_SPLITS:
        sids = np.sort(_split_ids(case, rng, S, rps))
        deltas = (_mixed(rng, (len(sids), cols)) if dtype == np.float32
                  else rng.integers(-3, 4, (len(sids), cols)).astype(dtype))
        keep = rng.random(len(sids)) > 0.2
        (local, sd, sv), valid, counts, _, _ = _slice_lanes(
            sids, rps, S, [deltas, keep], [0, False])
        shards = _on(x, cuda, S)
        before = dict(tk.LAUNCHES)
        tk.row_scatter_add_sharded(shards, _on(local, cuda), _on(sd, cuda),
                                   _on(sv, cuda), counts=counts)
        host = _on(x, "cpu", S)
        tk.row_scatter_add_sharded_plain(host, _on(local, "cpu"),
                                         _on(sd, "cpu"), _on(sv, "cpu"))
        flat = tk.row_scatter_add_masked(
            _on(x, cuda), _on(sids, cuda), _on(deltas, cuda),
            _on(keep, cuda))
        torch.cuda.synchronize()
        assert torch.equal(torch.cat([t.cpu() for t in shards]),
                           torch.cat(host)), case
        assert torch.equal(flat.cpu(), torch.cat(host)), case
        assert tk.LAUNCHES["row_scatter_add_sharded"] == \
            before["row_scatter_add_sharded"] + 1


def test_twenty_shards_on_one_card_launch_in_two_groups(cuda):
    """A (1, 20) param on one card: every per-card form launches twice (16
    shards, then 4) and still equals its plain version bit for bit."""
    rng = np.random.default_rng(20)
    S, rps, cols = 20, 50, 100
    x = torch.from_numpy(_mixed(rng, (S * rps, cols)))
    ids = _zipf_ids(rng, 5000, S * rps)
    d = _mixed(rng, (len(ids), cols))
    tk.reset_launches()
    got = tk.gather_rows(_mesh_param(x, ["cuda:0"] * S),
                         torch.from_numpy(ids).to(cuda))
    assert _same_bits(got, x[torch.from_numpy(ids).long()])
    param = _mesh_param(x, ["cuda:0"] * S)
    tk.row_scatter_add(param, torch.from_numpy(ids).to(cuda),
                       torch.from_numpy(d).to(cuda))
    want = tk.row_scatter_add_plain(x.clone(), torch.from_numpy(ids),
                                    torch.from_numpy(d))
    torch.cuda.synchronize()
    assert torch.equal(_mesh_host(param), want)
    order = np.argsort(ids // rps, kind="stable")
    (local,), _, counts, sh, pos = _slice_lanes(ids[order], rps, S, [], [])
    inv = np.zeros(len(ids), np.int32)
    inv[order] = sh * local.shape[1] + pos
    got = tk.gather_rows_sharded(_on(x.numpy(), cuda, S), _on(local, cuda),
                                 _on(inv, cuda), counts=counts)
    assert _same_bits(got, x[torch.from_numpy(ids).long()])
    sids = np.sort(ids)
    (local, sd), valid, counts, _, _ = _slice_lanes(sids, rps, S, [d], [0])
    shards = _on(x.numpy(), cuda, S)
    tk.row_scatter_add_sharded(shards, _on(local, cuda), _on(sd, cuda),
                               _on(valid, cuda), counts=counts)
    host = _on(x.numpy(), "cpu", S)
    tk.row_scatter_add_sharded_plain(host, _on(local, "cpu"),
                                     _on(sd, "cpu"), _on(valid, "cpu"))
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([t.cpu() for t in shards]),
                       torch.cat(host))
    for name in ("gather_rows_mesh", "row_scatter_add_mesh",
                 "row_gather_sharded", "row_scatter_add_sharded"):
        assert tk.LAUNCHES[name] == 2, name


def _device_ms(fn, iters=30):
    """Mean device ms of ``fn`` over calls queued behind a spin kernel."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def test_sliced_scatter_never_walks_the_pads(cuda):
    """30,000 Zipf lanes on shard 0 and 50 on each other shard: L is
    32,768, so shards 1-3 carry 32,718 pads each on one id, a run that a
    walk would take about 0.1 ms over (the one-id case adds at 3-4 ns a
    lane). The sharded call equals the flat masked kernel on the same
    real lanes, bit for bit, and takes at most 0.05 ms longer."""
    rng = np.random.default_rng(30)
    S, rps, cols = 4, 10_000, 100
    x = _mixed(rng, (S * rps, cols))
    sids = np.sort(np.concatenate(
        [_zipf_ids(rng, 30_000, rps)]
        + [s * rps + rng.integers(0, rps, 50).astype(np.int32)
           for s in range(1, S)]))
    d = _mixed(rng, (len(sids), cols))
    (local, sd), valid, counts, _, _ = _slice_lanes(sids, rps, S, [d], [0])
    assert local.shape[1] - counts[1:].max() > 30_000
    shards = _on(x, cuda, S)
    ops = [_on(a, cuda) for a in (local, sd, valid)]
    flat = _on(x, cuda)
    f_ops = [_on(a, cuda) for a in (sids, d, np.ones(len(sids), bool))]
    tk.row_scatter_add_sharded(shards, *ops, counts=counts)
    tk.row_scatter_add_masked(flat, *f_ops)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([t.cpu() for t in shards]), flat.cpu())
    sharded_ms = _device_ms(
        lambda: tk.row_scatter_add_sharded(shards, *ops, counts=counts))
    flat_ms = _device_ms(lambda: tk.row_scatter_add_masked(flat, *f_ops))
    assert sharded_ms < flat_ms + 0.05, (sharded_ms, flat_ms)


# -- the row scatter-add's long runs (a block per run) ------------------------


def _mixed(rng, shape):
    """float32 deltas of mixed magnitude (1e-3 to 1e7), so that any other
    summation order than the plain version's shows in the bits."""
    return (rng.standard_normal(shape)
            * 10.0 ** rng.integers(-3, 8, shape)).astype(np.float32)


def _scatter_on_card(cuda, x, ids, d, valid=None):
    """The kernel's table (ids in any order; ``valid`` takes the masked
    form over sorted ids) against the plain version's on the CPU."""
    if valid is None:
        got = tk.row_scatter_add(x.to(cuda), ids.to(cuda), d.to(cuda))
        want = tk.row_scatter_add_plain(x.clone(), ids, d)
    else:
        got = tk.row_scatter_add_masked(x.to(cuda), ids.to(cuda),
                                        d.to(cuda), valid.to(cuda))
        want = tk.row_scatter_add_masked_plain(x.clone(), ids, d, valid)
    torch.cuda.synchronize()
    return got.cpu(), want


def _run_ids(case, rng, rows):
    split = tk.SCATTER_SPLIT
    if case == "one_run_20000":
        return np.full(20_000, 7, np.int32)
    if case.startswith("split"):
        k = split + int(case[len("split"):])
        background = rng.integers(0, rows, 3000).astype(np.int32)
        return rng.permutation(np.concatenate(
            [np.full(k, 5, np.int32), np.full(k, rows - 1, np.int32),
             background]))
    if case == "zipf_24576":   # phase 2's ids (chip_smoke.zipf_ids)
        return np.clip(rng.zipf(1.2, 24_576) - 1, 0, rows - 2).astype(
            np.int32)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["one_run_20000", "split-1", "split+0",
                                  "split+1", "zipf_24576"])
@pytest.mark.parametrize("cols", [3, 100, 101, 1024])
def test_row_scatter_long_runs_match_plain(cuda, case, cols):
    """Runs on either side of the split, one run of 20,000 lanes and
    phase 2's Zipf ids, ids in any order (read through the sort's
    permutation), on the vector (100, 1024) and scalar (3, 101) paths:
    bit for bit the plain version's sorted-lane order."""
    rng = np.random.default_rng(cols)
    rows = 10_001 if cols <= 101 else 2_001
    ids = _run_ids(case, rng, rows)
    x = torch.from_numpy(_mixed(rng, (rows, cols)))
    d = torch.from_numpy(_mixed(rng, (len(ids), cols)))
    before = tk.LAUNCHES["row_scatter_add"]
    got, want = _scatter_on_card(cuda, x, torch.from_numpy(ids), d)
    assert torch.equal(_bits(got), _bits(want))
    assert tk.LAUNCHES["row_scatter_add"] == before + 1


@pytest.mark.parametrize("cols", [100, 101])
def test_row_scatter_masked_long_run_matches_plain(cuda, cols):
    """A long run with masked lanes inside it (and a wholly masked one):
    the masked lanes add nothing, the rest add in lane order."""
    rng = np.random.default_rng(3 + cols)
    rows = 500
    ids = np.sort(np.concatenate([
        np.full(9000, 17, np.int32), np.full(700, 400, np.int32),
        rng.integers(0, rows, 4000).astype(np.int32)]))
    valid = rng.random(len(ids)) < 0.7
    valid[ids == 400] = False
    x = torch.from_numpy(_mixed(rng, (rows, cols)))
    d = torch.from_numpy(_mixed(rng, (len(ids), cols)))
    got, want = _scatter_on_card(cuda, x, torch.from_numpy(ids), d,
                                 torch.from_numpy(valid))
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got[400]), _bits(x[400]))


@pytest.mark.parametrize("case", ["one_run_20000", "split+1", "zipf_24576"])
def test_row_scatter_int32_wide_rows(cuda, case):
    """int32 rows 1,024 wide: exact, and equal to the plain version."""
    rng = np.random.default_rng(11)
    rows = 2_001
    ids = _run_ids(case, rng, rows)
    x = torch.from_numpy(rng.integers(-50, 50, (rows, 1024)).astype(
        np.int32))
    d = torch.from_numpy(rng.integers(-9, 9, (len(ids), 1024)).astype(
        np.int32))
    got, want = _scatter_on_card(cuda, x, torch.from_numpy(ids), d)
    assert torch.equal(got, want)


@pytest.mark.parametrize("runs", [[(100, 6000)], [(100, 6000), (7600, 5000)]])
def test_mesh_scatter_long_runs_in_shards(cuda, runs):
    """Four shards of 2,501 rows on one card: a long run wholly inside one
    shard, or two long runs in two shards, in one launch per call; the
    tables equal the flat kernel's whole table and the plain version's,
    bit for bit."""
    rng = np.random.default_rng(len(runs))
    rows, cols = 10_004, 100
    ids = np.concatenate([np.full(k, r, np.int32) for r, k in runs]
                         + [rng.integers(0, rows, 2000).astype(np.int32)])
    ids = torch.from_numpy(rng.permutation(ids))
    x = torch.from_numpy(_mixed(rng, (rows, cols)))
    d = torch.from_numpy(_mixed(rng, (len(ids), cols)))
    param = _mesh_param(x, ["cuda:0"] * 4)
    before = dict(tk.LAUNCHES)
    tk.row_scatter_add(param, ids.to(cuda), d.to(cuda))
    assert tk.LAUNCHES["row_scatter_add_mesh"] == \
        before["row_scatter_add_mesh"] + 1
    flat, want = _scatter_on_card(cuda, x, ids, d)
    assert torch.equal(_bits(_mesh_host(param)), _bits(want))
    assert torch.equal(_bits(flat), _bits(want))


def test_mesh_coo_is_one_launch_per_card(cuda):
    """The mesh COO add (int32 tiled, float32 flat) over four shards of one
    card: one launch a call, equal to the flat kernel on the whole table
    bit for bit."""
    rng = np.random.default_rng(5)
    for dtype, shape in ((torch.int32, (50_004, 8, 128)),
                         (torch.float32, (1_000, 64))):
        n = 200_000
        r = torch.from_numpy(np.clip(rng.zipf(1.1, n) - 1, 0,
                                     shape[0] - 1).astype(np.int32))
        c = torch.from_numpy(rng.integers(0, int(np.prod(shape[1:])), n)
                             .astype(np.int32))
        v = torch.from_numpy(rng.integers(-2, 3, n).astype(np.float32))
        p0 = torch.from_numpy(rng.integers(0, 5, shape)).to(dtype)
        param = _mesh_param(p0, ["cuda:0"] * 4)
        before = tk.LAUNCHES["coo_scatter_add_mesh"]
        tk.coo_scatter_add(param, r.to(cuda), c.to(cuda), v.to(cuda))
        assert tk.LAUNCHES["coo_scatter_add_mesh"] == before + 1
        flat = tk.coo_scatter_add(p0.to(cuda), r.to(cuda), c.to(cuda),
                                  v.to(cuda))
        torch.cuda.synchronize()
        assert torch.equal(_mesh_host(param).view(shape), flat.cpu()), dtype


def test_scatter_workspace_left_zero_and_its_size_checked(cuda):
    """A call leaves the counter, the digit counts and the run scan's
    look-back words zero and zeroes the sort's before it reads them, so
    the next call on the stream, larger or smaller, finds a clean scratch; a workspace smaller than the plan's layout is
    refused, and nothing launches."""
    from multiverso_tpu_torch.ops import _build
    rng = np.random.default_rng(9)
    ids = torch.from_numpy(np.concatenate([
        np.full(5000, 3, np.int32), rng.integers(0, 400, 2000).astype(
            np.int32)]))
    x = torch.from_numpy(_mixed(rng, (400, 100)))
    for _ in range(2):  # the second call reuses the workspace
        d = torch.from_numpy(_mixed(rng, (len(ids), 100)))
        got, want = _scatter_on_card(cuda, x, ids, d)
        assert torch.equal(_bits(got), _bits(want))
    # a smaller call after them finds its scratch where they left it zero
    small_ids = ids[rng.permutation(len(ids))[:999]]
    got, want = _scatter_on_card(cuda, x, small_ids, d[:999])
    assert torch.equal(_bits(got), _bits(want))
    dev = torch.device("cuda", torch.cuda.current_device())
    ws = tk._WORKSPACES[(dev, torch.cuda.current_stream().cuda_stream)]
    n = len(ids)
    lay = tk.plan_layout(n)
    # the counter and digit counts, and each tile's run-scan word (the
    # last two of its row's first 2 * PLAN_MAX_BINS + 2 below the top)
    w = ws.view(torch.int32)
    assert not w[:lay["plan"]].any()
    rows = w[w.numel() - lay["status_words"]:].view(-1, tk.PLAN_STATUS_WORDS)
    run_words = 2 * tk.PLAN_MAX_BINS
    assert not rows[:, run_words:run_words + 2].any()
    p, i, dd = x.to(cuda), ids.to(cuda), d.to(cuda)
    small = torch.zeros(tk.scatter_workspace_size(n) - 1, dtype=torch.int64,
                        device=cuda)
    err = _build.load().mv_row_scatter_add(
        p.data_ptr(), 400, 100, 0, i.data_ptr(), 0, dd.data_ptr(), None,
        n, small.data_ptr(), small.numel(),
        torch.cuda.current_stream().cuda_stream)
    assert err != 0
    torch.cuda.synchronize()
    assert torch.equal(p.cpu(), x)
    assert not small.any()


# -- the row scatter's plan: the stable sort by row and its table of runs ------


def _plan_case(case, rng):
    """(int32 ids in request order, R) of one plan case: Zipf-1.2 at
    phase 2's sizes, one id, sorted, reversed, ids outside [0, R), R 1,
    2^20 and 2^30 + 5 (four sort passes), one lane, a count that is no
    multiple of 32, and the sparse-LR gradient's shape (three passes,
    many tiles)."""
    R = 10_001

    def zipf(n, rows=R, a=1.2):
        return np.clip(rng.zipf(a, n) - 1, 0, rows - 1).astype(np.int32)
    if case.startswith("zipf"):
        return zipf(int(case[4:])), R
    if case == "one":
        return np.full(24_576, 7, np.int32), R
    if case == "sorted":
        return np.sort(zipf(24_576)), R
    if case == "reversed":
        return np.sort(zipf(24_576))[::-1].copy(), R
    if case == "out_of_range":
        ids = zipf(5_000)
        bad = rng.random(5_000) < 0.2
        ids[bad] = rng.choice(np.array([-1, -5, R, R + 7, -2**31, 2**31 - 1],
                                       np.int32), int(bad.sum()))
        return ids, R
    if case == "r1":
        return rng.choice(np.array([-1, 0, 0, 0, 1], np.int32), 3_000), 1
    if case == "r2p20":
        return zipf(50_000, 1 << 20, 1.05), 1 << 20
    if case == "r2p30":
        return rng.integers(0, 1 << 30, 10_000).astype(np.int32), 2**30 + 5
    if case == "n1":
        return np.array([5], np.int32), R
    if case == "n1000":
        return zipf(1_000), R
    if case == "slr":
        return zipf(262_144, 159_007, 1.1), 159_007
    raise ValueError(case)


PLAN_CASES = ["zipf4096", "zipf24576", "one", "sorted", "reversed",
              "out_of_range", "r1", "r2p20", "r2p30", "n1", "n1000", "slr"]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_plan_kernel_equals_plain(cuda, case):
    """mv_row_scatter_plan against row_scatter_plan_plain (torch.sort
    stable, unique_consecutive, the long-run filter): the permutation,
    the runs and the long-run list element for element; one count."""
    rng = np.random.default_rng(PLAN_CASES.index(case))
    ids, R = _plan_case(case, rng)
    before = tk.LAUNCHES["row_scatter_plan"]
    got = tk.row_scatter_plan(torch.from_numpy(ids).to(cuda), R)
    want = tk.row_scatter_plan_plain(torch.from_numpy(ids), R)
    assert tk.LAUNCHES["row_scatter_plan"] == before + 1
    for name, g, w in zip(want._fields, got, want):
        assert torch.equal(g.cpu(), w), name


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("case", [c for c in PLAN_CASES if c != "r2p30"])
def test_row_scatter_forms_equal_plain_on_plan_cases(cuda, case, dtype):
    """The four row scatters on the plan's cases, bit for bit the plain
    version on the CPU over the lanes they keep: #2 (any order, planned),
    #9b (the same ids on four shards of one card, one plan), #3 (the ids
    sorted, a fifth of the lanes gated off) and #9's host-sliced form (the
    sorted lanes cut per shard). A lane outside the table adds nothing."""
    rng = np.random.default_rng(100 + PLAN_CASES.index(case))
    ids, R = _plan_case(case, rng)
    S = 4
    Rp = -(-R // S) * S        # the mesh's padded rows
    cols = 100 if R <= 10_001 else 8
    if dtype == np.float32:
        x = _mixed(rng, (Rp, cols))
        d = _mixed(rng, (len(ids), cols))
    else:
        x = rng.integers(-50, 50, (Rp, cols)).astype(dtype)
        d = rng.integers(-9, 9, (len(ids), cols)).astype(dtype)

    def plain(rows, lanes, deltas, valid=None):
        keep = (lanes >= 0) & (lanes < rows)
        if valid is not None:
            keep &= valid
        out = torch.from_numpy(x[:rows].copy())
        return tk.row_scatter_add_plain(out, torch.from_numpy(lanes[keep]),
                                        torch.from_numpy(deltas[keep]))

    def card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    before = dict(tk.LAUNCHES)
    flat = tk.row_scatter_add(card(x[:R]), card(ids), card(d))
    mesh = _mesh_param(torch.from_numpy(x), ["cuda:0"] * S)
    tk.row_scatter_add(mesh, card(ids), card(d))
    order = np.argsort(ids, kind="stable")
    sids, sd = ids[order], d[order]
    valid = rng.random(len(ids)) > 0.2
    masked = tk.row_scatter_add_masked(card(x[:R]), card(sids), card(sd),
                                       card(valid))
    inside = (sids >= 0) & (sids < Rp)
    (local, ld, lv), _, counts, _, _ = _slice_lanes(
        sids[inside], Rp // S, S, [sd[inside], valid[inside]], [0, False])
    shards = _on(x, cuda, S)
    tk.row_scatter_add_sharded(shards, _on(local, cuda), _on(ld, cuda),
                               _on(lv, cuda), counts=counts)
    torch.cuda.synchronize()
    assert torch.equal(_bits(flat), _bits(plain(R, ids, d)))
    assert torch.equal(_bits(_mesh_host(mesh)), _bits(plain(Rp, ids, d)))
    assert torch.equal(_bits(masked), _bits(plain(R, sids, sd, valid)))
    assert torch.equal(_bits(torch.cat([t.cpu() for t in shards])),
                       _bits(plain(Rp, sids, sd, valid)))
    grown = {k: tk.LAUNCHES[k] - before[k] for k in tk.LAUNCHES}
    assert grown["row_scatter_add"] == 1
    assert grown["row_scatter_plan"] == 2       # the flat form's, the mesh's
    assert grown["row_scatter_add_mesh"] == 1
    assert grown["row_scatter_add_masked"] == 2  # #3, and #9's one launch
    assert grown["row_scatter_add_sharded"] == 1


# -- the COO scatter-add: int32 lanes in any order, once per card -------------


def _coo_lanes(rng, shape, n, case):
    """(rows, cols, int32 vals) of one case, in request order: Zipf-1.1
    rows over the table, every lane on one element, or (``n`` 1) a single
    lane; a tenth of the values 0."""
    rows, cols = shape[0], int(np.prod(shape[1:]))
    if case == "one_element":
        r = np.full(n, rows // 2, np.int32)
        c = np.full(n, cols - 1, np.int32)
    else:
        r = np.clip(rng.zipf(1.1, n) - 1, 0, rows - 1).astype(np.int32)
        c = rng.integers(0, cols, n).astype(np.int32)
    v = rng.integers(-3, 4, n).astype(np.int32)
    v[rng.random(n) < 0.1] = 0
    return r, c, v


COO_CASES = [((300, 3), 20_000, "zipf"), ((300, 128), 20_000, "zipf"),
             ((300, 1, 128), 20_000, "zipf"), ((2_000, 1024), 200_000, "zipf"),
             ((2_000, 8, 128), 200_000, "zipf"), ((100, 4096), 50_000, "zipf"),
             ((1, 64), 5_000, "zipf"), ((10, 10), 1, "zipf"),
             ((10, 16), 100_000, "one_element"),
             ((50_001, 8, 128), 10_000_000, "zipf")]


@pytest.mark.parametrize("shape,n,case", COO_CASES)
def test_coo_int32_any_order_matches_plain(cuda, shape, n, case):
    """The int32 COO kernel on lanes in random order (the functional form,
    no sort) and in sorted order (the masked form, ``valid`` 0 on a fifth
    of them) against the plain version on the CPU, bit for bit; the last
    case is the LightLDA sweep-end rebuild's 10M Zipf-1.1 lanes into the
    tiled [50,001, 1024] word table."""
    rng = np.random.default_rng(n + len(shape))
    r, c, v = _coo_lanes(rng, shape, n, case)
    p = torch.from_numpy(rng.integers(-50, 50, shape).astype(np.int32))
    lanes = [torch.from_numpy(x) for x in (r, c, v)]
    got = tk.coo_scatter_add(p.to(cuda), *(x.to(cuda) for x in lanes))
    want = tk.coo_scatter_add_plain(p.clone(), *lanes)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    order = np.argsort(r, kind="stable")
    keep = (rng.random(n) < 0.8).astype(np.int32)
    sl = [torch.from_numpy(x[order]) for x in (r, c, v)]
    ok = torch.from_numpy(keep)
    got = tk.coo_scatter_add_masked(p.to(cuda), *(x.to(cuda) for x in sl),
                                    ok.to(cuda))
    want = tk.coo_scatter_add_masked_plain(p.clone(), *sl, ok)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def test_coo_int32_drops_lanes_out_of_range_and_wraps(cuda):
    """Rows and columns outside the table add nothing (the plain version,
    given only the lanes in range, is the yardstick); ``valid`` 0 gates a
    lane off; a sum past 2^31 wraps as numpy's int32 does."""
    rng = np.random.default_rng(31)
    R, C, n = 40, 100, 30_000
    r = rng.integers(-3, R + 3, n).astype(np.int32)
    c = rng.integers(-3, C + 3, n).astype(np.int32)
    v = rng.integers(-3, 4, n).astype(np.int32)
    inside = (r >= 0) & (r < R) & (c >= 0) & (c < C)
    p = torch.from_numpy(rng.integers(-9, 9, (R, C)).astype(np.int32))
    got = tk.coo_scatter_add(p.to(cuda), *(torch.from_numpy(x).to(cuda)
                                           for x in (r, c, v)))
    want = tk.coo_scatter_add_plain(p.clone(), *(torch.from_numpy(x[inside])
                                                 for x in (r, c, v)))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    # the masked form: valid 0 on every out-of-range lane and a third more
    keep = (inside & (rng.random(n) < 0.67)).astype(np.int32)
    order = np.argsort(r, kind="stable")
    sl = [torch.from_numpy(x[order]) for x in (r, c, v, keep)]
    got = tk.coo_scatter_add_masked(p.to(cuda), *(x.to(cuda) for x in sl))
    want = tk.coo_scatter_add_masked_plain(p.clone(), *sl)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    # wrap: 2^31 - 10 plus 3,000 lanes of +1 and 1,000 of 2^20
    big = np.concatenate([np.ones(3000, np.int32),
                          np.full(1000, 1 << 20, np.int32)])
    p = torch.full((4, 8), (1 << 31) - 10, dtype=torch.int32)
    rr = torch.full((len(big),), 2, dtype=torch.int32)
    cc = torch.full((len(big),), 5, dtype=torch.int32)
    got = tk.coo_scatter_add(p.to(cuda), rr.to(cuda), cc.to(cuda),
                             torch.from_numpy(rng.permutation(big)).to(cuda))
    torch.cuda.synchronize()
    wrapped = np.int64((1 << 31) - 10) + big.astype(np.int64).sum()
    assert int(got[2, 5]) == int(np.array(wrapped).astype(np.int32))
    assert int(got[2, 5]) == int(tk.coo_scatter_add_plain(
        p.clone(), rr, cc, torch.from_numpy(big))[2, 5])


def test_coo_float32_long_run_matches_plain(cuda):
    """float32 keeps its order contract: a run of 100,000 lanes on one row
    (the wrapper sorts, one thread walks the run) equals the plain version
    on the CPU bit for bit."""
    rng = np.random.default_rng(32)
    R, C, n = 50, 256, 100_000
    r = np.concatenate([np.full(n, 7, np.int32),
                        rng.integers(0, R, 5_000).astype(np.int32)])
    r = rng.permutation(r)
    c = rng.integers(0, C, len(r)).astype(np.int32)
    v = _mixed(rng, (len(r),))
    p = torch.from_numpy(_mixed(rng, (R, C)))
    lanes = [torch.from_numpy(x) for x in (r, c, v)]
    got = tk.coo_scatter_add(p.to(cuda), *(x.to(cuda) for x in lanes))
    want = tk.coo_scatter_add_plain(p.clone(), *lanes)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))


def test_coo_int32_launches_no_sort(cuda, monkeypatch):
    """An int32 table's lanes reach the kernel unsorted: the functional
    form and the mesh form call no ``torch.sort``; nor does a float32
    table's call, which sorts its lanes by element in its own plan kernel.
    The mesh form on 4 shards of one card, unsorted int32 lanes, equals
    the plain version bit for bit in one launch."""
    sorts = []
    real_sort = torch.sort
    monkeypatch.setattr(torch, "sort", lambda *a, **k: sorts.append(1)
                        or real_sort(*a, **k))
    rng = np.random.default_rng(33)
    shape, n = (4_000, 8, 128), 300_000
    r, c, v = _coo_lanes(rng, shape, n, "zipf")
    lanes = [torch.from_numpy(x) for x in (r, c, v)]
    on_card = [x.to(cuda) for x in lanes]
    p0 = torch.from_numpy(rng.integers(-5, 5, shape).astype(np.int32))
    got = tk.coo_scatter_add(p0.to(cuda), *on_card)
    param = _mesh_param(p0, ["cuda:0"] * 4)
    before = tk.LAUNCHES["coo_scatter_add_mesh"]
    tk.coo_scatter_add(param, *on_card)
    torch.cuda.synchronize()
    assert sorts == []
    assert tk.LAUNCHES["coo_scatter_add_mesh"] == before + 1
    want = tk.coo_scatter_add_plain(p0.clone(), *lanes)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(_mesh_host(param).view(shape), want)
    sorts.clear()  # the plain version sorts
    before = tk.LAUNCHES["coo_scatter_plan"]
    tk.coo_scatter_add(p0.float().to(cuda), on_card[0], on_card[1],
                       on_card[2].float())
    torch.cuda.synchronize()
    assert sorts == []
    assert tk.LAUNCHES["coo_scatter_plan"] == before + 1


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("S", [4, 20])
def test_coo_sharded_is_one_launch_per_card(cuda, S, dtype):
    """The host-sliced sharded COO add over S shards of one card, shard 1
    with no lane: one ``mv_coo_scatter_add_shards`` per group of 16
    shards (1 at S = 4, 2 at S = 20), the call's first also counted
    under the masked name; bit for bit the plain version over the full
    (S, L) layout on the CPU."""
    rng = np.random.default_rng(S + (dtype == np.int32))
    rps, cols = 300, 256
    x = (rng.integers(-9, 9, (S * rps, cols)) if dtype == np.int32
         else _mixed(rng, (S * rps, cols))).astype(dtype)
    gids = _zipf_ids(rng, 60_000, S * rps)
    gids = np.sort(gids[gids // rps != 1])
    c = rng.integers(0, cols, len(gids)).astype(np.int32)
    v = (rng.integers(-3, 4, len(gids)) if dtype == np.int32
         else _mixed(rng, (len(gids),))).astype(dtype)
    (lr, sc, sv), valid, counts, _, _ = _slice_lanes(
        gids, rps, S, [c, v], [np.int32(0), 0])
    valid &= rng.random(valid.shape) < 0.9
    assert counts[1] == 0
    shards = _on(x, cuda, S)
    before = dict(tk.LAUNCHES)
    tk.coo_scatter_add_sharded(shards, *(_on(a, cuda)
                                         for a in (lr, sc, sv, valid)),
                               counts=counts)
    host = _on(x, "cpu", S)
    tk.coo_scatter_add_sharded_plain(host, *(_on(a, "cpu")
                                             for a in (lr, sc, sv, valid)))
    torch.cuda.synchronize()
    assert torch.equal(_bits(torch.cat([t.cpu() for t in shards])),
                       _bits(torch.cat(host)))
    groups = -(-int((counts > 0).sum()) // tk.MESH_MAX_SHARDS)
    assert groups == (1 if S <= tk.MESH_MAX_SHARDS else 2)
    assert tk.LAUNCHES["coo_scatter_add_sharded"] == \
        before["coo_scatter_add_sharded"] + groups
    assert tk.LAUNCHES["coo_scatter_add_masked"] == \
        before["coo_scatter_add_masked"] + 1
    assert tk.LAUNCHES["coo_scatter_add"] == before["coo_scatter_add"]
    assert tk.LAUNCHES["coo_scatter_plan"] == before["coo_scatter_plan"] + (
        groups if dtype == np.float32 else 0)


# -- the float32 COO add: a plan by element, and its walk ---------------------


def _coo_f32_case(case, rng, R, C, n):
    """(rows, cols, float32 vals of mixed magnitude) in request order:
    Zipf-1.1 rows (phase 2's skew), every lane on one row, or every lane
    on one element; a twentieth of the rows and columns out of range in
    "out_of_range"."""
    if case == "one_row":
        r = np.full(n, R // 3, np.int32)
    elif case == "one_element":
        r = np.full(n, R - 1, np.int32)
    else:
        r = np.clip(rng.zipf(1.1, n) - 1, 0, R - 1).astype(np.int32)
    c = (np.full(n, C // 2, np.int32) if case == "one_element"
         else rng.integers(0, C, n).astype(np.int32))
    if case == "out_of_range":
        bad = rng.random(n) < 0.05
        r[bad] = rng.choice(np.array([-1, R, R + 9, -2**31], np.int32),
                            int(bad.sum()))
        bad = rng.random(n) < 0.05
        c[bad] = rng.choice(np.array([-1, C, 2**31 - 1], np.int32),
                            int(bad.sum()))
    return r, c, _mixed(rng, (n,))


COO_F32_CASES = ["zipf", "one_row", "one_element", "out_of_range"]


@pytest.mark.parametrize("shape,n", [((5_000, 1024), 200_000),
                                     ((300, 2, 128), 20_000),
                                     ((40, 100), 7_777)])
@pytest.mark.parametrize("case", COO_F32_CASES)
def test_coo_float32_forms_match_plain(cuda, case, shape, n):
    """Every float32 COO form bit for bit its plain version on the CPU:
    the flat form (lanes in any order), the masked form (row-sorted, a
    fifth gated off), the mesh form over 4 shards of one card (one plan,
    a walk a card) and the segment form (each shard's real lanes); each
    call plans once, and no ``torch.sort`` runs on the card."""
    rng = np.random.default_rng(COO_F32_CASES.index(case) + n)
    R, C = shape[0], int(np.prod(shape[1:]))
    r, c, v = _coo_f32_case(case, rng, R, C, n)
    x = torch.from_numpy(_mixed(rng, shape))
    lanes = [torch.from_numpy(a) for a in (r, c, v)]
    before = dict(tk.LAUNCHES)
    got = tk.coo_scatter_add(x.to(cuda), *(a.to(cuda) for a in lanes))
    want = tk.coo_scatter_add_plain(x.clone(), *lanes)
    assert torch.equal(_bits(got), _bits(want))
    order = np.argsort(r, kind="stable")
    ok = (rng.random(n) < 0.8).astype(np.int32)
    sl = [torch.from_numpy(a[order]) for a in (r, c, v)] + [
        torch.from_numpy(ok)]
    got = tk.coo_scatter_add_masked(x.to(cuda), *(a.to(cuda) for a in sl))
    want = tk.coo_scatter_add_masked_plain(x.clone(), *sl)
    assert torch.equal(_bits(got), _bits(want))
    S = 4
    Rp = -(-R // S) * S
    xp = torch.cat([x, torch.from_numpy(_mixed(rng, (Rp - R,) + shape[1:]))])
    mesh = _mesh_param(xp, ["cuda:0"] * S)
    tk.coo_scatter_add(mesh, *(a.to(cuda) for a in lanes))
    want = tk.coo_scatter_add_plain(xp.clone(), *lanes)
    assert torch.equal(_bits(_mesh_host(mesh)), _bits(want))
    inside = (r >= 0) & (r < Rp)
    srt = np.argsort(np.where(inside, r, 0), kind="stable")
    srt = srt[inside[srt]]
    (lr, sc, sv, sok), valid, counts, _, _ = _slice_lanes(
        r[srt], Rp // S, S, [c[srt], v[srt], ok[srt]],
        [np.int32(0), np.float32(0), np.int32(0)])
    valid &= sok.astype(bool)
    shards = _on(xp.numpy(), cuda, S)
    tk.coo_scatter_add_sharded(shards, *(_on(a, cuda)
                                         for a in (lr, sc, sv, valid)),
                               counts=counts)
    host = _on(xp.numpy(), "cpu", S)
    tk.coo_scatter_add_sharded_plain(host, *(_on(a, "cpu")
                                             for a in (lr, sc, sv, valid)))
    torch.cuda.synchronize()
    assert torch.equal(_bits(torch.cat([t.cpu() for t in shards])),
                       _bits(torch.cat(host)))
    grown = {k: tk.LAUNCHES[k] - before[k] for k in tk.LAUNCHES}
    # flat, masked, the mesh form's one plan, the segment form's one card
    assert grown["coo_scatter_plan"] == 4
    assert grown["coo_scatter_add_mesh"] == 1
    assert grown["coo_scatter_add_sharded"] == 1


PLAN_COO_CASES = ["zipf", "one_row", "one_element", "out_of_range",
                  "valid", "two_words", "n1"]


@pytest.mark.parametrize("case", PLAN_COO_CASES)
def test_coo_plan_kernel_equals_plain(cuda, case):
    """mv_coo_scatter_plan against coo_scatter_plan_plain (a stable sort
    of row * C + col, unique_consecutive): the permutation and the runs
    (row, column, first lane, count) element for element. "two_words":
    R * C past 2^31, keyed (column, row) in two words."""
    rng = np.random.default_rng(50 + PLAN_COO_CASES.index(case))
    R, C, n = 50_001, 1024, 512_000
    valid = None
    if case == "two_words":
        R, C, n = 3_000_000, 1_000, 300_000
    if case == "n1":
        n = 1
    r, c, _ = _coo_f32_case(case if case in COO_F32_CASES else "zipf", rng,
                            R, C, n)
    if case == "valid":
        valid = torch.from_numpy((rng.random(n) < 0.7).astype(np.int32))
    lanes = [torch.from_numpy(a) for a in (r, c)]
    before = tk.LAUNCHES["coo_scatter_plan"]
    got = tk.coo_scatter_plan(*(a.to(cuda) for a in lanes), R, C,
                              None if valid is None else valid.to(cuda))
    want = tk.coo_scatter_plan_plain(*lanes, R, C, valid)
    assert tk.LAUNCHES["coo_scatter_plan"] == before + 1
    for name, g, w in zip(want._fields, got, want):
        assert torch.equal(g.cpu(), w), name


def test_coo_float32_after_larger_and_smaller_calls(cuda):
    """The stream's COO workspace reused by calls of 300,000, then 999,
    then 300,000 lanes again, then the row scatter on its own workspace:
    every call bit for bit its plain version (no call meets a plan or a
    look-back word that an earlier one left), and the counter, the digit
    counts and the run scan's words are zero after each."""
    rng = np.random.default_rng(61)
    R, C = 2_000, 512
    x = torch.from_numpy(_mixed(rng, (R, C)))
    for n in (300_000, 999, 300_000, 12_345):
        r, c, v = _coo_f32_case("zipf", rng, R, C, n)
        lanes = [torch.from_numpy(a) for a in (r, c, v)]
        got = tk.coo_scatter_add(x.to(cuda), *(a.to(cuda) for a in lanes))
        want = tk.coo_scatter_add_plain(x.clone(), *lanes)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(want)), n
        ids = torch.from_numpy(_zipf_ids(rng, 4096, R))
        d = torch.from_numpy(_mixed(rng, (4096, C)))
        got, want = _scatter_on_card(cuda, x, ids, d)
        assert torch.equal(_bits(got), _bits(want)), n
        dev = torch.device("cuda", torch.cuda.current_device())
        ws = tk._WORKSPACES[(dev, torch.cuda.current_stream().cuda_stream,
                             "coo")]
        lay = tk.coo_plan_layout(n)
        w = ws.view(torch.int32)
        assert not w[:lay["plan"]].any()
        rows = w[w.numel() - lay["status_words"]:].view(
            -1, tk.PLAN_STATUS_WORDS)
        run_words = 2 * tk.PLAN_MAX_BINS
        assert not rows[:, run_words:run_words + 2].any()


def test_coo_float32_two_word_keys_match_plain(cuda):
    """A float32 table of 2,200,000 x 1,000 (R * C past 2^31: the plan keys
    (column, row) in two words): the touched elements equal the plain
    version's, run on the touched rows alone (the order within an element
    is the lanes' order whatever the rows' numbers), and a row no lane
    names stays 0."""
    rng = np.random.default_rng(62)
    R, C, n = 2_200_000, 1_000, 200_000
    r = np.clip(rng.zipf(1.1, n) * 37 % R, 0, R - 1).astype(np.int32)
    c = rng.integers(0, C, n).astype(np.int32)
    v = _mixed(rng, (n,))
    table = torch.zeros((R, C), dtype=torch.float32, device=cuda)
    tk.coo_scatter_add(table, *(torch.from_numpy(a).to(cuda)
                                for a in (r, c, v)))
    uniq, inv = np.unique(r, return_inverse=True)
    want = tk.coo_scatter_add_plain(
        torch.zeros((len(uniq), C)), torch.from_numpy(inv.astype(np.int32)),
        torch.from_numpy(c), torch.from_numpy(v))
    got = table[torch.from_numpy(uniq).long().to(cuda)].cpu()
    assert torch.equal(_bits(got), _bits(want))
    untouched = np.setdiff1d(np.arange(0, R, 997), uniq)[:50]
    assert not table[torch.from_numpy(untouched).long().to(cuda)].any()


# -- tables replicated over the data axis ---------------------------------------


def test_data_axis_word2vec_on_the_card_matches_one_replica(cuda, tmp_path):
    """Skip-gram NS and CBOW HS at a small width on (4, 1) and (2, 2)
    meshes, replica d on cuda:{d % cards}: the replicas end bit-identical,
    and each replica launches one gather and one scatter-add a table and
    step on its card (the flat kernels on S = 1, the mesh forms on S = 2).
    Against the (1, S) run on the whole batch, skip-gram NS ends bit for
    bit; CBOW HS within rtol 1e-5 / atol 1e-6 (the word2vec tolerance of
    the CPU tests): cuBLAS picks a ``bmm`` kernel by the batch's size, and
    its CBOW context mean and HS path products over 64 or 128 lanes round
    a lane an ulp apart from the same products over 256 (seen on an
    H100; at skip-gram NS's shapes they agree bit for bit)."""
    from multiverso_tpu_torch import core
    from multiverso_tpu_torch.apps.word_embedding import (W2VConfig,
                                                          WordEmbedding)
    from multiverso_tpu_torch.data import Corpus, synthetic_text
    path = str(tmp_path / "c.txt")
    synthetic_text(path, num_tokens=40_000, vocab_size=500, seed=3)
    n = torch.cuda.device_count()
    steps = 8
    for model, objective in (("skipgram", "ns"), ("cbow", "hs")):
        for dp, mp in ((4, 1), (2, 2)):
            out = []
            for rows in ([["cuda:0"] * mp],
                         [[f"cuda:{d % n}"] * mp for d in range(dp)]):
                corpus = Corpus.from_file(path, min_count=1)
                app = WordEmbedding(corpus, W2VConfig(
                    embedding_dim=100, model=model, objective=objective,
                    batch_size=256, steps_per_call=4, seed=3),
                    mesh=core.Mesh(rows))
                tk.reset_launches()
                app.train(total_steps=steps)
                for key in ("w_in", "w_out"):
                    table = getattr(app, key)
                    for shards in table.replicas[1:]:
                        assert [_same_bits(a, b) for a, b in zip(
                            shards, table.replicas[0])] == [True] * mp, key
                out.append((app.w_in.get(), app.w_out.get(),
                            dict(tk.LAUNCHES)))
            for key, a, b in zip(("w_in", "w_out"), out[0][:2], out[1][:2]):
                if model == "skipgram":
                    assert a.tobytes() == b.tobytes(), \
                        (model, dp, mp, key, np.abs(a - b).max())
                else:
                    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
            grown = out[1][2]
            gather, scatter = ("row_gather", "row_scatter_add") if mp == 1 \
                else ("gather_rows_mesh", "row_scatter_add_mesh")
            tables = 2
            assert grown[gather] == grown[scatter] == tables * dp * steps
            flat_or_mesh = {"row_gather", "row_scatter_add",
                            "gather_rows_mesh", "row_scatter_add_mesh"}
            assert all(grown[k] == 0 for k in flat_or_mesh
                       - {gather, scatter})


def test_native_data_library_builds_and_loads(cuda, tmp_path):
    """The native data library builds with g++ into build/torch_kernels/
    on the card's machine, and its multi-threaded fill keeps the chunk
    oracle there too."""
    from pathlib import Path

    from multiverso_tpu_torch.data import (CHUNK_SEED_STEP, Corpus, backend,
                                           load_native, synthetic_text)
    nat = load_native()
    assert Path(nat.path).parent == \
        Path(__file__).resolve().parents[1] / "build" / "torch_kernels"
    assert backend() is nat
    ids = np.random.default_rng(0).integers(0, 50, 9_001).astype(np.int32)
    got = nat.skipgram_pairs(ids, 3, None, seed=4, threads=3)
    parts = [nat.skipgram_pairs(ids[len(ids) * t // 3:
                                    len(ids) * (t + 1) // 3], 3, None,
                                seed=(4 + t * CHUNK_SEED_STEP) % 2**64)
             for t in range(3)]
    for i in (0, 1):
        np.testing.assert_array_equal(
            got[i], np.concatenate([p[i] for p in parts]))
    path = str(tmp_path / "c.txt")
    synthetic_text(path, num_tokens=5_000, vocab_size=100, seed=1)
    corpus = Corpus.from_file(path, min_count=1)
    src, tgt = next(iter(corpus.skipgram_batches(64, gen_threads=2)))
    assert src.shape == tgt.shape == (64,)


@pytest.mark.parametrize("updater", ["sgd", "adagrad", "ftrl"])
def test_dense_logreg_on_the_card_matches_the_cpu(cuda, updater):
    """Dense logistic regression at MNIST's width (784 x 10): one epoch of
    S-step calls, single steps and a short last minibatch on the card,
    on the CPU and on a (4, 1) mesh (replica d on cuda:{d % cards}), from
    the same weights. The card within the CPU tests' float32 tolerance
    (rtol 1e-5, atol 1e-6) of the CPU, the replicas bit-identical and
    within it of the one-replica run."""
    from multiverso_tpu_torch import core
    from multiverso_tpu_torch.apps.logreg import (LogisticRegression,
                                                  LogRegConfig,
                                                  synthetic_blobs)
    X, y = synthetic_blobs(1_000, 784, 10, seed=2)
    cfg = LogRegConfig(784, 10, minibatch_size=128, steps_per_call=4,
                       updater=updater, regular_lambda=0.01)
    n = torch.cuda.device_count()
    apps = [LogisticRegression(cfg, device="cuda", name="card"),
            LogisticRegression(cfg, device="cpu", name="cpu"),
            LogisticRegression(cfg, mesh=core.Mesh(
                [[f"cuda:{d % n}"] for d in range(4)]), name="dp")]
    losses = [app.train_epoch(X, y, shuffle_seed=0) for app in apps]
    w = [np.concatenate([a.ravel() for a in app.weights()]) for app in apps]
    np.testing.assert_allclose(w[0], w[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w[2], w[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(losses[2], losses[0], rtol=1e-5, atol=1e-6)
    replicas = apps[2].table.replicas
    assert all(_same_bits(r[0], replicas[0][0]) for r in replicas[1:])
    np.testing.assert_array_equal(apps[0].predict(X), apps[1].predict(X))


class _FreeRunningExchange:
    """Built in the test: ``tables.superstep._Exchange`` with its turns
    taken out. Every replica thread runs at once from its start, and an
    exchange waits only until every replica has posted to its round."""

    @staticmethod
    def make():
        import time
        from multiverso_tpu_torch.tables import superstep as ss

        class FreeRunning(ss._Exchange):
            def start(self, replica):
                pass

            def _hand_on(self, replica):
                self._wake_all()

            def finish(self, replica):
                with self._lock:
                    self._done[replica] = True
                    self._wake_all()

            def _wait(self, replica, posts=None, k=0):
                deadline = time.monotonic() + self.timeout
                while True:
                    if self.error is not None:
                        raise ss._Aborted()
                    if posts is None or all(p is not None for p in posts):
                        return
                    if any(p is None and self._done[r]
                           for r, p in enumerate(posts)):
                        self._fail(RuntimeError("a replica returned early"))
                    left = deadline - time.monotonic()
                    if left <= 0:
                        self._fail(TimeoutError("exchange timed out"))
                    self._conds[replica].wait(left)

        return FreeRunning


def test_free_running_replicas_stay_identical(cuda, tmp_path, monkeypatch):
    """Fault F2: word2vec's (4, 1) replicas with the superstep's turns
    taken out, so that the four replica threads queue their work at once.
    At phase 4's widths (batch 4,096, dim 100, vocab 10k, 5 negatives),
    the replicas must stay bit-identical after every one of 16 calls, and
    end equal to the run that takes turns. Without ``_SCATTER_LOCK`` a
    replica 1 differed after call 10 on an H100: two threads' row
    scatters on one stream interleaved their two kernels, and the first
    call's long-run kernel took both calls' long runs from the shared
    workspace."""
    from multiverso_tpu_torch import core
    from multiverso_tpu_torch.apps.word_embedding import (W2VConfig,
                                                          WordEmbedding)
    from multiverso_tpu_torch.data import Corpus, synthetic_text
    from multiverso_tpu_torch.tables import superstep as ss
    path = str(tmp_path / "c.txt")
    synthetic_text(path, num_tokens=300_000, vocab_size=10_000, seed=3)
    n = torch.cuda.device_count()
    mesh = core.Mesh([[f"cuda:{d % n}"] for d in range(4)])
    calls, steps = 16, 8

    def run(free):
        corpus = Corpus.from_file(path, min_count=1)
        app = WordEmbedding(corpus, W2VConfig(
            embedding_dim=100, batch_size=4096, steps_per_call=steps,
            learning_rate=0.01, seed=3), mesh=mesh)
        batches = iter(corpus.skipgram_batches(4096, window=5, seed=3,
                                               epochs=50))
        with monkeypatch.context() as m:
            if free:
                m.setattr(ss, "_Exchange", _FreeRunningExchange.make())
            for call in range(calls):
                src, tgt = zip(*(next(batches) for _ in range(steps)))
                app._dispatch(np.stack(src), np.stack(tgt), call, calls)
                if free:
                    for key in ("w_in", "w_out"):
                        table = getattr(app, key)
                        for d, shards in enumerate(table.replicas[1:], 1):
                            assert _same_bits(shards[0],
                                              table.replicas[0][0]), \
                                f"call {call}: {key} replica {d} differs"
        return app.w_in.get(), app.w_out.get()

    free, turns = run(True), run(False)
    for a, b in zip(free, turns):
        assert a.tobytes() == b.tobytes()


# -- telemetry on the card ----------------------------------------------------


def test_record_device_memory_reads_the_allocator(cuda):
    """The gauges of cuda:0 equal ``memory_allocated`` /
    ``max_memory_allocated`` (one allocator read, no allocation between),
    and ``bytes_limit`` the card's memory."""
    from multiverso_tpu_torch import telemetry
    keep = torch.ones(1 << 20, device=cuda)           # 4 MiB live
    torch.cuda.synchronize()
    out = telemetry.record_device_memory(prefix="t.card")
    assert out["cuda:0.bytes_in_use"] == torch.cuda.memory_allocated(0)
    assert out["cuda:0.peak_bytes_in_use"] \
        == torch.cuda.max_memory_allocated(0)
    assert out["cuda:0.bytes_limit"] \
        == torch.cuda.get_device_properties(0).total_memory
    assert out["live_bytes"] >= keep.numel() * 4 and out["live_buffers"] >= 1
    gauges = telemetry.snapshot()["gauges"]
    assert gauges["t.card.bytes_in_use{device=cuda:0}"] \
        == out["cuda:0.bytes_in_use"]
    assert gauges["t.card.live_buffers"] == out["live_buffers"]


def test_profile_window_traces_a_launched_kernel(cuda, tmp_path, monkeypatch):
    """``profile_window`` under ``MVTPU_PROFILE_DIR`` writes a Chrome trace
    that names the row gather's kernel and the span around it."""
    import json
    import os
    from multiverso_tpu_torch import telemetry
    monkeypatch.setenv("MVTPU_PROFILE_DIR", str(tmp_path))
    p = torch.randn(1000, 64, device=cuda)
    ids = torch.randint(0, 1000, (4096,), dtype=torch.int32, device=cuda)
    tk.gather_rows(p, ids)                            # build and warm
    torch.cuda.synchronize()
    with telemetry.profile_window("card") as out:
        with telemetry.span("card.gather"):
            tk.gather_rows(p, ids)
        torch.cuda.synchronize()
    (name,) = os.listdir(out)
    with open(os.path.join(out, name)) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    assert any("mv_row_gather" in n for n in names), sorted(set(names))[:40]
    assert "card.gather" in names and "profile.window" in names


def test_word2vec_telemetry_counts_its_calls(cuda, tmp_path):
    """A word2vec run on the card: one ``w2v.superstep`` span, one
    ``step`` record and one ``app.step.seconds`` observation a call,
    ``profile.calls`` of the superstep a call (not a step), no ``table.*``
    counter moved by the supersteps, and the kernels' launches as the
    steps require."""
    from multiverso_tpu_torch import telemetry
    from multiverso_tpu_torch.apps.word_embedding import (W2VConfig,
                                                          WordEmbedding)
    from multiverso_tpu_torch.data import Corpus, synthetic_text
    from multiverso_tpu_torch.telemetry import trace
    path = str(tmp_path / "c.txt")
    synthetic_text(path, num_tokens=40_000, vocab_size=500, seed=3)
    # reset before the app: its wrappers cache their counters
    telemetry.registry().reset()
    app = WordEmbedding(Corpus.from_file(path, min_count=1), W2VConfig(
        embedding_dim=100, batch_size=256, steps_per_call=4, seed=3),
        device="cuda")
    sink = str(tmp_path / "trace.jsonl")
    trace.set_trace_file(sink)
    tk.reset_launches()
    try:
        app.train(total_steps=12)
    finally:
        trace.set_trace_file(None)
    snap = telemetry.snapshot()
    records = trace.read_trace(sink)
    assert [r["name"] for r in records if r["kind"] == "span"] \
        == ["w2v.superstep"] * 3
    assert [r["step"] for r in records if r["kind"] == "step"] == [0, 1, 2]
    assert snap["histograms"]["app.step.seconds{app=w2v}"]["count"] == 3
    assert snap["counters"]["profile.calls{fn=superstep.w2v_superstep}"] \
        == 3
    assert not any(k.startswith("table.") for k in snap["counters"])
    assert snap["counters"]["w2v.pairs"] == 12 * 256
    assert tk.LAUNCHES["row_gather"] == tk.LAUNCHES["row_scatter_add"] \
        == 2 * 12


def test_summarize_on_the_card_matches_the_cpu(cuda):
    """The stat reduction of a card tensor (and of a ShardedParam of its
    row blocks) against the same reduction on the CPU: counts and abs_max
    exact, l2 within 1e-5 (another float32 sum order); its copy to the
    host is read through the Summary's event."""
    from multiverso_tpu_torch.ops import stat_kernels as sk
    from multiverso_tpu_torch.ops.table_kernels import ShardedParam
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(4001, 33)).astype(np.float32))
    flat = x.view(-1)
    flat[[2, 9, 40, 77]] = torch.tensor([float("nan"), float("inf"), 0.0,
                                         float("-inf")])
    cases = [(x.to(cuda), x),
             (ShardedParam(list(x[:4000].to(cuda).chunk(4))), x[:4000]),
             (x.to(cuda, torch.bfloat16), x.to(torch.bfloat16))]
    for operand, on_cpu in cases:
        s = sk.summarize(operand)
        assert s.event is not None and s.host.is_pinned()
        got, want = sk.unpack(s), sk.unpack(sk.summarize(on_cpu))
        for k in ("absmax", "nan_count", "inf_count", "zero_frac", "count"):
            assert got[k] == want[k], k
        assert got["l2"] == pytest.approx(want["l2"], rel=1e-5)
        assert got["nan_count"] == 1 and got["inf_count"] == 2


def test_export_holds_the_values_before_an_in_place_add(cuda, tmp_path):
    """A generation saved and, at once, a row scatter-add that writes the
    table in place: the generation holds the pre-add values (the copy
    into pinned memory is queued first on the card's stream)."""
    from multiverso_tpu_torch.ft.checkpoint import RunCheckpointManager
    from multiverso_tpu_torch.tables.base import (CHECKPOINT_MAGIC,
                                                  loadz_stream)
    t = MatrixTable(100_001, 64, device="cuda", name="ex_card")
    t.add_rows(np.arange(0, 100_001, 7), np.ones((14_286, 64), np.float32))
    pre = t.get()
    mgr = RunCheckpointManager(str(tmp_path), tables=[t])
    mgr.save(1)
    for _ in range(20):
        t.add_rows(np.arange(0, 100_001, 3),
                   np.full((33_334, 64), 2.0, np.float32))
    mgr.close()
    _, data = loadz_stream(str(tmp_path / "gen-0000000001" /
                               "table-ex_card.npz"),
                           CHECKPOINT_MAGIC)
    assert data["param"][:100_001].tobytes() == pre.tobytes()
    assert not np.array_equal(t.get(), pre)


# -- the client pipeline on the card ---------------------------------------------


@pytest.mark.parametrize("width", [1, 2])
def test_presum_through_row_scatter_at_narrow_widths(cuda, width):
    """The coalescer's duplicate-key pre-sum: the row scatter-add kernel
    at widths 1 and 2 (a COO group, the sparse-LR classes), with runs of
    a key longer than 32 lanes (the long-run kernel), against its plain
    version on the CPU, bit for bit; one launch a pre-sum."""
    from multiverso_tpu_torch.client import coalesce
    rng = np.random.default_rng(width)
    n_unique = 40_000
    inv = np.concatenate([rng.integers(0, n_unique, 120_000),
                          np.full(300, 7), np.full(70, n_unique - 1),
                          np.full(33, 11)]).astype(np.int64)
    rng.shuffle(inv)
    d = (rng.standard_normal((len(inv), width))
         * 10.0 ** rng.integers(-3, 4, (len(inv), 1))).astype(np.float32)
    before = tk.LAUNCHES["row_scatter_add"]
    got = coalesce.presum(torch.zeros(n_unique, width, device=cuda),
                          torch.from_numpy(inv).to(cuda),
                          torch.from_numpy(d).to(cuda))
    want = tk.row_scatter_add_plain(torch.zeros(n_unique, width),
                                    torch.from_numpy(inv),
                                    torch.from_numpy(d))
    assert torch.equal(got.cpu(), want)
    assert tk.LAUNCHES["row_scatter_add"] == before + 1
    np_want = np.zeros((n_unique, width), np.float32)
    np.add.at(np_want, inv, d)
    assert np.array_equal(want.numpy(), np_want)


def test_coalesced_card_deltas_equal_host_deltas(cuda):
    """A KVTable on the card fed the same K batches through a coalescer as
    card tensors (pre-sum on the card) and as host arrays (np.add.at):
    keys, values and state bit for bit."""
    from multiverso_tpu_torch import client
    from multiverso_tpu_torch.tables import KVTable
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(8):
        keys = rng.choice(np.arange(1, 5000, dtype=np.uint64), 1500,
                          replace=False)
        batches.append((keys, rng.standard_normal((1500, 2)).astype(
            np.float32)))
    out = []
    for form in ("host", "card"):
        t = KVTable(1 << 16, value_dim=2, slots_per_bucket=16,
                    updater="ftrl", device=cuda, name=f"co_{form}")
        buf = client.CoalescingBuffer(t, max_deltas=4)
        for keys, d in batches:
            buf.add_kv(keys, torch.from_numpy(d).to(cuda)
                       if form == "card" else d)
        assert buf.flush_generation == 2
        out.append((t.keys.cpu(), t.values.cpu(),
                    {k: v.cpu() for k, v in t.state.items()}))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    for k in out[0][2]:
        assert torch.equal(out[0][2][k], out[1][2][k])


def test_cached_view_arrays_survive_later_adds_and_reuse_staging(cuda):
    """A view's refreshed array is unchanged after later in-place adds and
    refreshes, and every refresh reuses the one pinned staging buffer
    (the same data pointer)."""
    from multiverso_tpu_torch import client
    rng = np.random.default_rng(4)
    t = MatrixTable(5000, 64, device=cuda, name="view_card")
    view = client.CachedView(t, max_staleness=0)
    try:
        served, ptrs = [], set()
        for i in range(6):
            ids = rng.integers(0, 5000, 4096).astype(np.int32)
            t.add_rows(ids, rng.standard_normal((4096, 64)).astype(
                np.float32))
            assert view._staging is not None and view._staging.is_pinned()
            ptrs.add(view._staging.data_ptr())
            got = view.get()
            assert view.generation == t.generation
            assert np.array_equal(got, t.get())
            served.append((got, got.copy()))
        for got, snap in served:
            assert np.array_equal(got, snap)
        assert len(ptrs) == 1 and view.staging_allocs == 1
    finally:
        view.close()


def test_stage_kv_adds_equal_direct_adds(cuda):
    """The staging writer's worker-thread prep (host lanes copied to the
    card, a card delta permuted there) on the card: the table equals
    direct adds bit for bit, for host and card deltas."""
    from multiverso_tpu_torch import client
    from multiverso_tpu_torch.tables import KVTable
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(12):
        keys = rng.choice(np.arange(1, 1 << 20, dtype=np.uint64), 20_000,
                          replace=False)
        batches.append((keys, rng.standard_normal((20_000, 2)).astype(
            np.float32)))
    for form in ("host", "card"):
        bs = [(k, torch.from_numpy(d).to(cuda) if form == "card" else d)
              for k, d in batches]
        a = KVTable(1 << 22, value_dim=2, slots_per_bucket=16,
                    updater="adagrad", device=cuda, name="st_direct")
        for k, d in bs:
            a.add(k, d)
        b = KVTable(1 << 22, value_dim=2, slots_per_bucket=16,
                    updater="adagrad", device=cuda, name="st_staged")
        client.stage_kv_adds(b, bs, depth=2).wait()
        a.wait()
        assert torch.equal(a.keys.cpu(), b.keys.cpu())
        assert torch.equal(a.values.cpu(), b.values.cpu())
        for k in a.state:
            assert torch.equal(a.state[k].cpu(), b.state[k].cpu())


def _tbits(t):
    """A tensor's bit patterns on the host (2- or 4-byte elements)."""
    kind = torch.int16 if t.element_size() == 2 else torch.int32
    return t.cpu().contiguous().view(kind)


def _tiered_pair(cuda, tmp_path, name, **kw):
    """The same small tiered table on the card and on the CPU, each its own
    spill directory."""
    from multiverso_tpu_torch.storage import TieredKVTable
    kw = dict(dict(value_dim=3, updater="adagrad", slots_per_bucket=8,
                   device_buckets=16, host_buckets=8), **kw)
    return [TieredKVTable(2048, device=d, name=f"{name}{i}",
                          spill_dir=str(tmp_path / f"tiers{i}"), **kw)
            for i, d in enumerate((cuda, "cpu"))]


def _same_tiered(gpu, host):
    assert torch.equal(gpu.keys.cpu(), host.keys)
    assert torch.equal(_tbits(gpu.values), _tbits(host.values))
    for k in host.state:
        assert torch.equal(_tbits(gpu.state[k]), _tbits(host.state[k]))
    for name in ("tier", "slot_of", "bucket_at"):
        assert np.array_equal(getattr(gpu.tiers, name),
                              getattr(host.tiers, name))


def test_tiered_chunked_get_on_the_card_matches_cpu(cuda, tmp_path):
    """A Get wider than the device tier (chunked: one lookup launch a
    chunk) on the card: the CPU table's values and found, bit for bit, in
    the caller's order; the host arena pinned on the card only."""
    gpu, host = _tiered_pair(cuda, tmp_path, "tg", device_buckets=4,
                             host_buckets=2)
    assert gpu.tiers.host.pinned and not host.tiers.host.pinned
    rng = np.random.default_rng(40)
    keys = rng.choice(2 ** 40, 200, replace=False).astype(np.uint64)
    d = rng.standard_normal((200, 3)).astype(np.float32)
    for t in (gpu, host):
        t.add(keys, d, sync=True)
    q = np.concatenate([keys[::-1], np.arange(1, 40, dtype=np.uint64)])
    chunks = len(gpu._chunk_spans(np.sort(gpu._buckets_of(q))))
    assert chunks > 1
    before = tk.LAUNCHES["kv_lookup"]
    vg, fg = gpu.get_tensor(q)
    assert tk.LAUNCHES["kv_lookup"] - before == chunks
    vh, fh = host.get_tensor(q)
    assert torch.equal(fg.cpu(), fh)
    assert torch.equal(_tbits(vg), _tbits(vh))
    _same_tiered(gpu, host)


def test_tiered_add_through_disk_on_the_card_matches_cpu(cuda, tmp_path):
    """Adds that demote buckets to the host arena and the spill file and
    fill them back (disk fills above 0): the card's table, every tier's
    records and every Get equal the CPU table's bit for bit; one probe and
    one commit a chunk."""
    from multiverso_tpu_torch.telemetry import metrics as telemetry
    gpu, host = _tiered_pair(cuda, tmp_path, "ta")
    rng = np.random.default_rng(41)
    pool = rng.choice(2 ** 40, 500, replace=False).astype(np.uint64)
    fills = lambda t: telemetry.counter("storage.fills", tier="disk",
                                        table=t.name).value
    for step in range(6):
        keys = rng.choice(pool, 150, replace=False)
        d = rng.standard_normal((150, 3)).astype(np.float32)
        chunks = len(gpu._chunk_spans(np.sort(gpu._buckets_of(keys))))
        before = dict(tk.LAUNCHES)
        for t in (gpu, host):
            t.add(keys, d, sync=True)
        for name in ("kv_probe_update", "kv_commit"):
            assert tk.LAUNCHES[name] - before[name] == chunks
        _same_tiered(gpu, host)
    assert fills(gpu) == fills(host) > 0
    for b in gpu.tiers.disk.buckets():
        a, h = gpu.tiers.disk.peek(b), host.tiers.disk.peek(b)
        assert gpu.spec.pack(a) == host.spec.pack(h)
    for b in gpu.tiers.host.buckets():
        assert gpu.spec.pack(gpu.tiers.host.peek(b)) == \
            host.spec.pack(host.tiers.host.peek(b))
    vg, fg = gpu.get(pool)
    vh, fh = host.get(pool)
    assert np.array_equal(fg, fh) and vg.tobytes() == vh.tobytes()


def test_tiered_store_load_on_the_card_matches_cpu(cuda, tmp_path):
    """store -> load on the card: the file is the CPU table's, byte for
    byte, and the restored card table (every tier populated) equals the
    CPU table restored from the same file."""
    gpu, host = _tiered_pair(cuda, tmp_path, "ts", dtype="bfloat16",
                             updater="ftrl")
    rng = np.random.default_rng(42)
    keys = rng.choice(2 ** 40, 400, replace=False).astype(np.uint64)
    for _ in range(2):
        d = rng.standard_normal((400, 3)).astype(np.float32)
        for t in (gpu, host):
            t.add(keys, d, sync=True)
    paths = [str(tmp_path / f"{t.name}.ckpt") for t in (gpu, host)]
    for t, p in zip((gpu, host), paths):
        t.store(p)
    mg, pg = gpu.export_checkpoint_async()()
    mh, ph = host.export_checkpoint_async()()
    assert sorted(pg) == sorted(ph)
    for k in pg:
        assert pg[k].tobytes() == ph[k].tobytes(), k
    rg, rh = _tiered_pair(cuda, tmp_path / "r", "tr", dtype="bfloat16",
                          updater="ftrl")
    rg.load(paths[0])
    rh.load(paths[0])
    c = rg.tiers.counts()
    assert c["device"] > 0 and c["host"] > 0 and c["disk"] > 0
    _same_tiered(rg, rh)
    vg, fg = rg.get_tensor(keys)
    vh, fh = host.get_tensor(keys)
    assert torch.equal(fg.cpu(), fh) and torch.equal(_tbits(vg),
                                                     _tbits(vh))


# -- the wire server on the card ----------------------------------------------

def _served(device, tmp_path, tag):
    """One stream of frames through a TableServer on ``device`` (fuse 8),
    from the port's WireClient: KV adds and Gets on an ftrl table, a
    pipelined burst that fuses into groups on a default table, staleness
    reads answered off the replica, and a tiered table spread over all
    three tiers. Returns every reply's arrays and the fused-group count."""
    import os
    from multiverso_tpu_torch.client import transport
    from multiverso_tpu_torch.ft import chaos
    from multiverso_tpu_torch.server.table_server import TableServer
    from multiverso_tpu_torch.tables import reset_tables
    from multiverso_tpu_torch.telemetry import metrics
    env = {"MVTPU_TIER_DIR": str(tmp_path / f"tiers-{tag}"),
           "MVTPU_TIER_DEVICE_BUCKETS": "8", "MVTPU_TIER_HOST_BUCKETS": "8"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    name = f"cw-{tag}"
    s = TableServer(f"unix:{tmp_path}/{tag}.sock", name=name,
                    device=device, fuse=8)
    addr = s.start()
    rng = np.random.default_rng(50)
    out = []
    try:
        with transport.connect(addr, client="w", quant=None) as c:
            kv = c.create_kv("c_kv", 1 << 15, value_dim=2, updater="ftrl")
            pool = np.unique(rng.integers(1, 2 ** 40, 3000, dtype=np.uint64))
            for _ in range(4):
                keys = rng.choice(pool, 700, replace=False)
                kv.add(keys, rng.standard_normal((700, 2)).astype(
                    np.float32), sync=True)
                out += list(kv.get(np.append(keys, [7, 8]).astype(
                    np.uint64)))
            fused = c.create_kv("c_fused", 1 << 15, value_dim=2)
            chaos.install_chaos("server.dequeue:latency:ms=200,times=1")
            try:
                for j in range(16):
                    fused.add(pool[j * 50:j * 50 + 400],
                              np.full((400, 2), float(j % 3 + 1),
                                      np.float32))
                c.drain()
            finally:
                chaos.uninstall_chaos()
            out += list(fused.get(pool[:1200]))
            hits = metrics.counter("server.replica.hits", server=name)
            h0 = hits.value
            replica = None
            for _ in range(200):
                header, arrays = c.call("kv_get", {"table": kv.table_id,
                                                   "staleness": 0},
                                        [pool[:500]])
                if header.get("replica"):
                    replica = [np.array(a) for a in arrays]
                    break
                time.sleep(0.02)
            assert replica is not None and hits.value > h0
            out += replica
            tiered = c.create_kv("c_tiered", 1 << 15, value_dim=2,
                                 updater="adagrad", tiered=True)
            for i in range(3):
                keys = rng.choice(pool, 900, replace=False)
                tiered.add(keys, rng.standard_normal((900, 2)).astype(
                    np.float32), sync=True)
            out += list(tiered.get(pool))
        groups = metrics.counter("server.fuse.groups", server=name).value
    finally:
        s.stop()
        reset_tables()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out, groups


def test_wire_server_on_the_card_matches_cpu(cuda, tmp_path):
    """A TableServer on cuda:0 answers the same frames as the same server
    on the CPU, bit for bit: KV adds and Gets (the probe + commit and the
    lookup kernels), a fused KV group, a staleness read off the replica
    and a tiered_kv table."""
    from multiverso_tpu_torch.server.table_server import TableServer
    assert TableServer.__init__.__kwdefaults__["device"] == "cuda:0"
    before = dict(tk.LAUNCHES)
    gpu, g_groups = _served("cuda:0", tmp_path, "gpu")
    grown = {k: tk.LAUNCHES[k] - before[k]
             for k in ("kv_lookup", "kv_probe_update", "kv_commit")}
    host, h_groups = _served("cpu", tmp_path, "cpu")
    assert g_groups >= 1 and h_groups >= 1
    assert len(gpu) == len(host)
    for a, b in zip(gpu, host):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert min(grown.values()) > 0, grown


# -- a replicated pair on the card --------------------------------------------

def _replicated_pair(device, tmp_path, tag):
    """A 1-rank primary (fuse 8) streaming to its follower, both on
    ``device``, behind the port's router: an unfused ftrl KV stream
    (each add acked before the next) and a pipelined default-updater
    stream that fuses into groups. Returns the primary's and the
    follower's answers and the fused-group count."""
    from multiverso_tpu_torch.client import router
    from multiverso_tpu_torch.ft import chaos
    from multiverso_tpu_torch.server import partition
    from multiverso_tpu_torch.server.table_server import TableServer
    from multiverso_tpu_torch.tables import reset_tables
    from multiverso_tpu_torch.telemetry import metrics
    pmap = partition.PartitionMap(1, replicas=2)
    fol = TableServer(f"unix:{tmp_path}/{tag}-f.sock", name=f"rf-{tag}",
                      partition=partition.PartitionMember(pmap, 0),
                      follower=True, replica_idx=1, device=device)
    fol_addr = fol.start()
    pri = TableServer(f"unix:{tmp_path}/{tag}-p.sock", name=f"rp-{tag}",
                      partition=partition.PartitionMember(pmap, 0),
                      replicate_to=[fol_addr], device=device, fuse=8)
    pri_addr = pri.start()
    rng = np.random.default_rng(51)
    pool = np.unique(rng.integers(1, 2 ** 40, 3000, dtype=np.uint64))
    out = []
    try:
        fc = router.connect_fleet([pri_addr], replicas=2,
                                  replica_addrs=[[fol_addr]], quant=None,
                                  read_replica=1, client="w")
        kv = fc.create_kv("r_kv", 1 << 15, value_dim=2, updater="ftrl")
        for _ in range(4):
            keys = rng.choice(pool, 700, replace=False)
            kv.add(keys, rng.standard_normal((700, 2)).astype(np.float32),
                   sync=True)
        fused = fc.create_kv("r_fused", 1 << 15, value_dim=2)
        chaos.install_chaos("server.dequeue:latency:ms=200,times=1")
        try:
            for j in range(16):
                fused.add(pool[j * 50:j * 50 + 400],
                          np.full((400, 2), float(j % 3 + 1), np.float32))
            fc.drain()
        finally:
            chaos.uninstall_chaos()
        for t in (kv, fused):
            prim = t.get_shard(0).get(pool)
            foll = t.get(pool, staleness=0)
            for a, b in zip(prim, foll):
                assert a.tobytes() == b.tobytes()
            out += list(prim)
        assert pri._tables[fused.table_id].generation == \
            fol._tables[fused.table_id].generation
        groups = metrics.counter("server.fuse.groups",
                                 server=f"rp-{tag}").value
        fc.close()
    finally:
        pri.stop()
        fol.stop()
        reset_tables()
    return out, groups


def test_replicated_pair_on_the_card_matches_cpu(cuda, tmp_path):
    """A primary + follower pair on cuda:0 takes a fused and an unfused
    KV stream; its follower equals its primary, and both equal the same
    pair on the CPU, bit for bit. The follower applies each forwarded
    frame through the KV probe + commit kernels itself."""
    before = dict(tk.LAUNCHES)
    gpu, g_groups = _replicated_pair("cuda:0", tmp_path, "gpu")
    grown = {k: tk.LAUNCHES[k] - before[k]
             for k in ("kv_lookup", "kv_probe_update", "kv_commit")}
    host, h_groups = _replicated_pair("cpu", tmp_path, "cpu")
    assert g_groups >= 1 and h_groups >= 1
    assert len(gpu) == len(host)
    for a, b in zip(gpu, host):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    # the primary's and the follower's adds: 4 ftrl + the fused default
    # groups and singles, each applied on both
    assert grown["kv_probe_update"] >= 2 * (4 + g_groups), grown
    assert grown["kv_lookup"] > 0, grown


@pytest.mark.parametrize("shards", [1, 4])
def test_matrix_handler_rows_on_the_card_match_plain(cuda, shards):
    """The binding's MatrixTableHandler on cuda:0: its row get / add run
    the sharded row kernels (one launch of each per call on one card) and
    equal the same handler on CPU shards (the plain versions) exactly: the
    deltas are multiples of 1/16, so every sum is exact in any order."""
    from multiverso_tpu_torch import core
    from multiverso_tpu_torch.bindings import MatrixTableHandler
    from multiverso_tpu_torch.tables import reset_tables
    rng = np.random.default_rng(shards)
    rows, cols = 10_001, 100
    tables = {}
    for where in ("cuda:0", "cpu"):
        core.set_mesh(core.Mesh([[where] * shards]))
        tables[where] = MatrixTableHandler(rows, cols, name="rows")
    try:
        tk.reset_launches()
        for _ in range(4):
            ids = _zipf_ids(rng, 4096, rows)
            d = rng.integers(-16, 17, (4096, cols)).astype(np.float32) / 16
            for t in tables.values():
                t.add(d, row_ids=ids)
            q = _zipf_ids(rng, 4096, rows)
            got, want = (t.get(row_ids=q) for t in tables.values())
            assert np.array_equal(got, want)
        assert tk.LAUNCHES["row_gather_sharded"] == 4
        assert tk.LAUNCHES["row_scatter_add_sharded"] == 4
        assert np.array_equal(tables["cuda:0"].get(), tables["cpu"].get())
    finally:
        reset_tables()
        core.shutdown()


def test_pipeline_and_ring_on_the_card_match_the_cpu(cuda):
    """pipeline_apply (8 stages on cuda:0) and ring / Ulysses attention on
    an (8, 1) mesh of cuda:0 against the same calls on CPU meshes: forward
    within 1e-5 and the pipeline's gradients within 1e-4 (cuBLAS and the
    CPU sum in other orders; TF32 off)."""
    from multiverso_tpu_torch import core
    from multiverso_tpu_torch.parallel import (ring_attention,
                                               ulysses_attention)
    from multiverso_tpu_torch.parallel.pipeline import (pipeline_apply,
                                                        sequential_oracle)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.5, (8, 16, 16)).astype(np.float32)
    b = rng.normal(0, 0.1, (8, 16)).astype(np.float32)
    x = rng.normal(size=(32, 16)).astype(np.float32)

    def fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    outs = {}
    for where in ("cuda:0", "cpu"):
        mesh = core.Mesh([[where] * 8])
        p = {"w": torch.tensor(w, device=where, requires_grad=True),
             "b": torch.tensor(b, device=where, requires_grad=True)}
        y = pipeline_apply(p, torch.tensor(x, device=where), fn, mesh=mesh)
        grads = torch.autograd.grad((y ** 2).sum(), [p["w"], p["b"]])
        outs[where] = [t.detach().cpu().numpy() for t in (y, *grads)]
        oracle = sequential_oracle(p, torch.tensor(x, device=where), fn)
        np.testing.assert_allclose(outs[where][0],
                                   oracle.detach().cpu().numpy(),
                                   rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(outs["cuda:0"][0], outs["cpu"][0], rtol=1e-5,
                               atol=1e-5)
    for g, h in zip(outs["cuda:0"][1:], outs["cpu"][1:]):
        np.testing.assert_allclose(g, h, rtol=1e-4, atol=1e-4)
    q, k, v = (rng.normal(0, 1, (2, 64, 8, 16)).astype(np.float32)
               for _ in range(3))
    for fn_attn in (ring_attention, ulysses_attention):
        for causal in (False, True):
            got, want = (fn_attn(
                *(torch.tensor(a, device=where) for a in (q, k, v)),
                mesh=core.Mesh([[where]] * 8), causal=causal).cpu().numpy()
                for where in ("cuda:0", "cpu"))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _or_into(partial):
    """A merge that ORs ``partial`` (another process's outputs) in."""
    def merge(outs):
        for out, part in zip(outs, partial):
            bits = {4: torch.int32, 1: torch.uint8}[out.element_size()]
            out.view(bits).bitwise_or_(part.to(out.device).view(bits))
    return merge


def test_held_shard_reads_merge_to_the_whole_on_the_card(cuda):
    """A model axis across processes: each half of a two-shard table read
    by the kernels over the shard held here (the other None) gives zero
    bits elsewhere; the OR of the halves equals the whole table's read
    bit for bit, -0.0 and a NaN payload included. The mesh gather, the
    host-sliced gather and the KV lookup."""
    rng = np.random.default_rng(27)
    x = torch.from_numpy(rng.standard_normal((200, 16)).astype(np.float32))
    x[3, 0], x[150, 2] = -0.0, float("nan")
    halves = [x[:100].clone().to(cuda), x[100:].clone().to(cuda)]
    ids = torch.from_numpy(_zipf_ids(rng, 999, 200)).to(cuda)
    other = tk.gather_rows_mesh(tk.ShardedParam(
        [None, halves[1]], merge=lambda outs: None), ids)
    got = tk.gather_rows_mesh(tk.ShardedParam(
        [halves[0], None], merge=_or_into((other,))), ids)
    assert torch.equal(got.cpu().view(torch.int32),
                       x[ids.cpu().long()].view(torch.int32))
    # the host-sliced gather: lanes sorted by shard, local ids
    sid = ids.cpu().numpy()
    order = np.argsort(sid // 100, kind="stable")
    local = (sid[order] % 100).astype(np.int32)
    counts = np.bincount(sid[order] // 100, minlength=2)
    lanes = int(counts.max())
    lid = np.full((2, lanes), 99, np.int32)
    inv = np.zeros(len(sid), np.int32)
    at = 0
    for s in range(2):
        lid[s, :counts[s]] = local[at:at + counts[s]]
        inv[order[at:at + counts[s]]] = s * lanes + np.arange(counts[s])
        at += counts[s]
    lid_t, inv_t = torch.from_numpy(lid).to(cuda), torch.from_numpy(inv)
    part = tk.gather_rows_sharded([None, halves[1]], lid_t, inv_t.to(cuda),
                                  counts=counts, merge=lambda outs: None)
    got = tk.gather_rows_sharded([halves[0], None], lid_t, inv_t.to(cuda),
                                 counts=counts, merge=_or_into((part,)))
    assert torch.equal(got.cpu().view(torch.int32),
                       x[ids.cpu().long()].view(torch.int32))
    # the KV lookup: two shards of 8 buckets x 4 slots, values D 3
    keys = [torch.full((8, 4, 2), -1, dtype=torch.int32) for _ in range(2)]
    vals = [torch.from_numpy(rng.standard_normal((8, 4, 3)).astype(
        np.float32)) for _ in range(2)]
    keys[0][2, 1] = torch.tensor([0, 5])
    keys[1][6, 3] = torch.tensor([1, 9])
    query = torch.tensor([[[0, 5], [0, 6]], [[1, 9], [0, 5]]],
                         dtype=torch.int32)
    buckets = torch.tensor([[2, 7], [6, 6]], dtype=torch.int32)
    inv = torch.tensor([3, 0, 2, 1], dtype=torch.int32)
    whole = tk.kv_lookup_sharded(keys, vals, query, buckets, inv, 0.25)
    on = [[t.to(cuda) for t in keys], [t.to(cuda) for t in vals]]
    q, b, i = query.to(cuda), buckets.to(cuda), inv.to(cuda)
    part = tk.kv_lookup_sharded([None, on[0][1]], [None, on[1][1]], q, b, i,
                                0.25, merge=lambda outs: None)
    got = tk.kv_lookup_sharded([on[0][0], None], [on[1][0], None], q, b, i,
                               0.25, merge=_or_into(part))
    for a, w in zip(got, whole):
        assert torch.equal(a.cpu(), w)


def test_gated_kv_probe_update_on_the_card_matches_plain(cuda):
    """The sharded probe + commit over the shard held here with a gate
    (every process's count) and the written cells: a closed gate writes
    nothing and lists no cell, an open one writes the cells the plain
    version writes, bit for bit."""
    from multiverso_tpu_torch.updaters import AddOption

    def table(dev):
        keys = [torch.full((8, 4, 2), -1, dtype=torch.int32, device=dev),
                None]
        vals = [torch.zeros(8, 4, 2, device=dev), None]
        return keys, vals, [{"h": torch.zeros(8, 4, 2, device=dev)}, None]

    lanes = dict(
        buckets=torch.tensor([[1, 1, 5], [0, 0, 0]], dtype=torch.int32),
        query=torch.tensor([[[0, 3], [0, 4], [2, 8]], [[0, 0]] * 3],
                           dtype=torch.int32),
        deltas=torch.ones(2, 3, 2),
        valid=torch.tensor([[True, True, True], [False] * 3]))
    opt = AddOption(learning_rate=0.5, lam=1e-8)
    out = {}
    for dev in ("cpu", cuda):
        for extra in (7, 0):
            k, v, st = table(dev)
            cells = []
            n = tk.kv_probe_update_sharded(
                k, v, st, *(x.to(dev) for x in lanes.values()), opt,
                "adagrad", counts=[3, 0], gate=lambda c: c + extra,
                cells=cells)[3]
            assert int(n) == extra
            if extra:
                assert cells == [] and (k[0] == -1).all().item()
            else:
                (bw, sw), = cells
                out[str(dev)] = (k[0].cpu(), v[0].cpu(), st[0]["h"].cpu(),
                                 sorted(zip(bw.tolist(), sw.tolist())))
    a, b = out["cpu"], out[str(torch.device(cuda))]
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)
    assert a[3] == b[3]
