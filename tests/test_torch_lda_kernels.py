"""The port's Gibbs sampler functions against the JAX package's Pallas
kernels (``gibbs_sample_tiled``, ``gibbs_sample_docblock``,
``gibbs_sample_docblock_build`` with ``interpret=True``), on the same
numpy inputs as ``tests/test_ops.py``.

Tolerance (the tie rule): the two packages take the float32 chunk and
lane sums of the two-level draw in different orders (the reference as
triangular matmuls, the port in the CUDA kernel's warp order), so a draw
may differ where a threshold ties a CDF boundary. At least 99.9% of real
lanes must agree, and every lane that differs must be a tie: in float64
the threshold lies within 1e-5 relative of every CDF boundary between the
two draws (``lda_sampler.explained_by_ties``). Given each side's own
draws, ``nk_delta`` and the blocked doc counts are exact, and build mode
equals read mode bit for bit on real lanes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.ops import lda_sampler as jls
from multiverso_tpu_torch.ops import lda_sampler as ls

ALPHA, BETA = 0.1, 0.01


def _inputs(b, c, seed=0):
    """test_ops.py's inputs at batch ``b`` and C chunks."""
    rng = np.random.default_rng(seed)
    A = rng.integers(0, 6, (b, c, 128)).astype(np.int32)
    W = rng.integers(0, 60, (b, c, 128)).astype(np.int32)
    nk = rng.integers(500, 5000, (c, 128)).astype(np.int32)
    sinv = (1.0 / (nk + 50 * BETA)).astype(np.float32)
    zi = rng.integers(0, c * 128, b).astype(np.int32)
    msk = np.ones(b, np.int32)
    msk[-3:] = 0  # padded lanes
    u1 = rng.random(b).astype(np.float32)
    u2 = rng.random(b).astype(np.float32)
    return A, W, sinv, zi, msk, u1, u2


def _blocked(nb, maxd, tb, c, seed):
    """test_ops.py's doc-blocked inputs, with block counts that are the
    counts of each block's own (zi, drel) (a consistent sampler state)."""
    rng = np.random.default_rng(seed)
    b = nb * tb
    W = rng.integers(0, 60, (b, c, 128)).astype(np.int32)
    nk = rng.integers(500, 5000, (c, 128)).astype(np.int32)
    sinv = (1.0 / (nk + 50 * BETA)).astype(np.float32)
    zi = rng.integers(0, c * 128, b).astype(np.int32)
    drel = rng.integers(0, maxd, b).astype(np.int32)
    msk = np.ones(b, np.int32)
    msk[-2:] = 0
    u1 = rng.random(b).astype(np.float32)
    u2 = rng.random(b).astype(np.float32)
    ndk = np.zeros((nb * maxd, c * 128), np.int32)
    rows = np.repeat(np.arange(nb), tb) * maxd + drel
    np.add.at(ndk, (rows[msk > 0], zi[msk > 0]), 1)
    return ndk.reshape(nb, maxd, c, 128), W, sinv, zi, drel, msk, u1, u2


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _nkd(zi, znew, msk, c):
    real = msk > 0
    want = np.zeros(c * 128, np.int64)
    np.add.at(want, znew[real], 1)
    np.add.at(want, zi[real], -1)
    return want.reshape(c, 128)


def _tie_rule(A, W, sinv, zi, msk, u1, u2, got, want):
    real = msk > 0
    agree = float(np.mean(got[real] == want[real]))
    assert agree >= 0.999, f"only {agree:.4f} agreement"
    assert ls.explained_by_ties(A, W, sinv, zi, msk, u1, u2, got, want,
                                alpha=ALPHA, beta=BETA).all()
    np.testing.assert_array_equal(got[~real], zi[~real])
    np.testing.assert_array_equal(want[~real], zi[~real])


@pytest.mark.parametrize("a_dtype,w_dtype", [("int32", "int32"),
                                             ("int16", "bfloat16")])
@pytest.mark.parametrize("b,c", [(1024, 2), (2048, 1)])
def test_tiled_matches_pallas(a_dtype, w_dtype, b, c):
    A, W, sinv, zi, msk, u1, u2 = _inputs(b, c, seed=b + c)
    A = A.astype(a_dtype)
    Wj = jnp.asarray(W, w_dtype)
    jz, jn = jls.gibbs_sample_tiled(A, Wj, sinv, zi, msk, u1, u2,
                                    alpha=ALPHA, beta=BETA, interpret=True)
    Wt = torch.from_numpy(W).to(getattr(torch, w_dtype))
    tz, tn = ls.gibbs_sample_tiled(*_t(A), Wt, *_t(sinv, zi, msk, u1, u2),
                                   alpha=ALPHA, beta=BETA)
    jz, tz = np.asarray(jz), tz.numpy()
    _tie_rule(A, W, sinv, zi, msk, u1, u2, tz, jz)
    np.testing.assert_array_equal(tn.numpy(), _nkd(zi, tz, msk, c))
    np.testing.assert_array_equal(np.asarray(jn), _nkd(zi, jz, msk, c))
    assert tn.dtype == torch.int32 and tz.dtype == np.int32


@pytest.mark.parametrize("n_dtype", ["int16", "int32"])
def test_docblock_matches_pallas(n_dtype):
    nb, maxd, tb, c = 6, 8, 256, 1
    ndk, W, sinv, zi, drel, msk, u1, u2 = _blocked(nb, maxd, tb, c, 5)
    ndk = ndk.astype(n_dtype)
    jout, jz, jn = jls.gibbs_sample_docblock(
        ndk, W, sinv, zi, drel, msk, u1, u2, alpha=ALPHA, beta=BETA, tb=tb,
        interpret=True)
    t_ndk = torch.from_numpy(ndk.copy())
    tout, tz, tn = ls.gibbs_sample_docblock(
        t_ndk, *_t(W, sinv, zi, drel, msk, u1, u2), alpha=ALPHA, beta=BETA,
        tb=tb)
    assert tout is t_ndk                          # updated in place
    jz, tz = np.asarray(jz), tz.numpy()
    rows = np.repeat(np.arange(nb), tb) * maxd + drel
    A = ndk.reshape(nb * maxd, -1)[rows].reshape(-1, c, 128)
    _tie_rule(A, W, sinv, zi, msk, u1, u2, tz, jz)
    for out, z, nkd in ((tout.numpy(), tz, tn.numpy()),
                        (np.asarray(jout), jz, np.asarray(jn))):
        want = ndk.reshape(nb * maxd, -1).astype(np.int64)
        real = msk > 0
        np.add.at(want, (rows[real], zi[real]), -1)
        np.add.at(want, (rows[real], z[real]), 1)
        np.testing.assert_array_equal(out.reshape(nb * maxd, -1), want)
        assert out.dtype == np.dtype(n_dtype)
        np.testing.assert_array_equal(nkd, _nkd(zi, z, msk, c))


def test_build_mode_matches_pallas_and_read_mode():
    nb, maxd, tb, c = 4, 8, 256, 2
    ndk, W, sinv, zi, drel, msk, u1, u2 = _blocked(nb, maxd, tb, c, 9)
    Wb = torch.from_numpy(W).to(torch.bfloat16)
    vec = _t(sinv, zi, drel, msk, u1, u2)
    bz, bn = ls.gibbs_sample_docblock_build(Wb, *vec, alpha=ALPHA,
                                            beta=BETA, tb=tb, maxd=maxd)
    _, rz, rn = ls.gibbs_sample_docblock(
        torch.from_numpy(ndk.astype(np.int16)), Wb, *vec, alpha=ALPHA,
        beta=BETA, tb=tb)
    real = msk > 0
    np.testing.assert_array_equal(bz.numpy()[real], rz.numpy()[real])
    np.testing.assert_array_equal(bn.numpy(), rn.numpy())
    jz, jn = jls.gibbs_sample_docblock_build(
        jnp.asarray(W, jnp.bfloat16), sinv, zi, drel, msk, u1, u2,
        alpha=ALPHA, beta=BETA, tb=tb, maxd=maxd, interpret=True)
    jz = np.asarray(jz)
    rows = np.repeat(np.arange(nb), tb) * maxd + drel
    A = ndk.reshape(nb * maxd, -1)[rows].reshape(-1, c, 128)
    _tie_rule(A, W, sinv, zi, msk, u1, u2, bz.numpy(), jz)
    np.testing.assert_array_equal(np.asarray(jn), _nkd(zi, jz, msk, c))


def test_samples_follow_posterior():
    """One token repeated with fresh uniforms: the empirical topic
    distribution matches the collapsed posterior (test_ops.py's check)."""
    rng = np.random.default_rng(2)
    b, c = 4096, 2
    A1 = rng.integers(0, 6, (1, c, 128)).astype(np.int32)
    W1 = rng.integers(0, 60, (1, c, 128)).astype(np.int32)
    nk = rng.integers(500, 5000, (c, 128)).astype(np.int32)
    sinv = (1.0 / (nk + 50 * BETA)).astype(np.float32)
    zi = np.zeros(b, np.int32)
    msk = np.ones(b, np.int32)
    u1, u2 = rng.random(b).astype(np.float32), rng.random(b).astype(
        np.float32)
    znew, _ = ls.gibbs_sample_tiled(
        *_t(np.repeat(A1, b, 0), np.repeat(W1, b, 0), sinv, zi, msk, u1, u2),
        alpha=ALPHA, beta=BETA)
    counts = np.bincount(znew.numpy(), minlength=c * 128) / b
    own = (np.arange(c * 128) == 0)
    p = np.maximum((A1.reshape(-1) - own + ALPHA)
                   * (W1.reshape(-1) - own + BETA), 0) * sinv.reshape(-1)
    p /= p.sum()
    assert 0.5 * np.abs(counts - p).sum() < 0.12


def test_tie_checker_flags_real_disagreements():
    A, W, sinv, zi, msk, u1, u2 = _inputs(64, 2, seed=3)
    z, _ = ls.gibbs_sample_tiled(*_t(A, W, sinv, zi, msk, u1, u2),
                                 alpha=ALPHA, beta=BETA)
    z = z.numpy()
    assert ls.explained_by_ties(A, W, sinv, zi, msk, u1, u2, z, z,
                                alpha=ALPHA, beta=BETA).all()
    wrong = z.copy()
    wrong[:10] = (wrong[:10] + 37) % 256
    ok = ls.explained_by_ties(A, W, sinv, zi, msk, u1, u2, wrong, z,
                              alpha=ALPHA, beta=BETA)
    assert not ok[:10].any() and ok[10:].all()


def test_shape_errors_match_the_reference():
    A, W, sinv, zi, msk, u1, u2 = _t(*_inputs(64, 1))
    with pytest.raises(ValueError, match="last dim must be 128"):
        ls.gibbs_sample_tiled(A.view(64, 2, 64), W, sinv, zi, msk, u1, u2,
                              alpha=ALPHA, beta=BETA)
    with pytest.raises(ValueError, match="not divisible by tb"):
        ls.gibbs_sample_docblock_build(W, sinv, zi, zi, msk, u1, u2,
                                       alpha=ALPHA, beta=BETA, tb=48,
                                       maxd=4)
    with pytest.raises(ValueError, match=r"token count 64 != blocks 3"):
        ls.gibbs_sample_docblock(torch.zeros(3, 4, 1, 128,
                                             dtype=torch.int16),
                                 W, sinv, zi, zi, msk, u1, u2, alpha=ALPHA,
                                 beta=BETA, tb=16)


def test_plain_versions_run_only_on_cpu_tensors():
    """CPU tensors take the plain version (no launch is counted); tensors
    on any other device go to the kernel path, which raises for a device
    it has no kernel for instead of falling back."""
    ls.reset_launches()
    args = _t(*_inputs(64, 1))
    ls.gibbs_sample_tiled(*args, alpha=ALPHA, beta=BETA)
    assert all(v == 0 for v in ls.LAUNCHES.values())
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no sampler kernel"):
        ls.gibbs_sample_tiled(*meta, alpha=ALPHA, beta=BETA)
    with pytest.raises(ValueError, match="no sampler kernel"):
        ls.gibbs_sample_docblock_build(meta[1], *meta[2:5], *meta[4:7],
                                       alpha=ALPHA, beta=BETA, tb=16, maxd=4)
    assert all(v == 0 for v in ls.LAUNCHES.values())
