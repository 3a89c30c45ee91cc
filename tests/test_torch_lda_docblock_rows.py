"""The doc-blocked samplers reading word rows from a mirror (``words=``)
against the JAX package's Pallas kernels (``gibbs_sample_docblock``,
``gibbs_sample_docblock_build`` with ``interpret=True``) on the rows
``jnp.take(mirror, words, axis=0)`` gives, from the same seeded numpy
inputs; and the checks of the ``words=`` operands.

Tolerance (the tie rule of ``tests/test_torch_lda_kernels.py``): at least
99.9% of real lanes agree, and every lane that differs is a float32 CDF
tie (``lda_sampler.explained_by_ties``). Given each side's own draws,
``nk_delta`` and the blocked doc counts are exact. The inputs include
padded tokens on the mirror's scratch row and real tokens whose ``drel``
lies outside ``[0, MAXD)``: the reference's one-hot ``E @ ndk`` gives
them a zero doc row and no doc-count move, and so does the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.ops import lda_sampler as jls
from multiverso_tpu_torch.ops import lda_sampler as ls

ALPHA, BETA = 0.1, 0.01
V = 300                                    # mirror rows; row V is scratch


def _case(nb, maxd, tb, c, seed, w_dtype="int32"):
    """Blocked doc counts of the in-block real tokens' own (zi, drel), a
    [V + 1, C, 128] mirror, Zipf word ids (pads on the scratch row) and a
    few real tokens with drel outside [0, maxd)."""
    rng = np.random.default_rng(seed)
    b = nb * tb
    mirror = rng.integers(0, 60, (V + 1, c, 128)).astype(np.int32)
    words = np.clip(rng.zipf(1.1, b) - 1, 0, V - 1).astype(np.int32)
    nk = rng.integers(500, 5000, (c, 128)).astype(np.int32)
    sinv = (1.0 / (nk + 50 * BETA)).astype(np.float32)
    zi = rng.integers(0, c * 128, b).astype(np.int32)
    drel = rng.integers(0, maxd, b).astype(np.int32)
    msk = np.ones(b, np.int32)
    msk[tb - 30:tb] = 0                    # block 0 ends in pads
    drel[tb:tb + 4] = [-1, maxd, maxd + 3, -5]
    words[msk == 0] = V
    u1 = rng.random(b).astype(np.float32)
    u2 = rng.random(b).astype(np.float32)
    rows = np.repeat(np.arange(nb), tb) * maxd + drel
    inb = (msk > 0) & (drel >= 0) & (drel < maxd)
    ndk = np.zeros((nb * maxd, c * 128), np.int32)
    np.add.at(ndk, (rows[inb], zi[inb]), 1)
    return (ndk.reshape(nb, maxd, c, 128), mirror, words,
            (sinv, zi, drel, msk, u1, u2))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _mirror(mirror, w_dtype):
    return torch.from_numpy(mirror).to(getattr(torch, w_dtype))


def _doc_rows(ndk, drel, tb):
    """Each token's block-start doc row; zero where drel is outside."""
    nb, maxd = ndk.shape[:2]
    flat = ndk.reshape(nb * maxd, -1)
    inb = (drel >= 0) & (drel < maxd)
    rows = np.repeat(np.arange(nb), tb) * maxd + np.where(inb, drel, 0)
    return np.where(inb[:, None], flat[rows], 0).reshape(len(drel), -1, 128)


def _nkd(zi, znew, msk, c):
    real = msk > 0
    want = np.zeros(c * 128, np.int64)
    np.add.at(want, znew[real], 1)
    np.add.at(want, zi[real], -1)
    return want.reshape(c, 128)


def _moved(ndk, zi, znew, drel, msk, tb):
    nb, maxd = ndk.shape[:2]
    want = ndk.reshape(nb * maxd, -1).astype(np.int64)
    moves = (msk > 0) & (drel >= 0) & (drel < maxd)
    rows = np.repeat(np.arange(nb), tb) * maxd + drel
    np.add.at(want, (rows[moves], zi[moves]), -1)
    np.add.at(want, (rows[moves], znew[moves]), 1)
    return want


def _tie_rule(A, W, vec, got, want):
    sinv, zi, _, msk, u1, u2 = vec
    real = msk > 0
    agree = float(np.mean(got[real] == want[real]))
    assert agree >= 0.999, f"only {agree:.4f} agreement"
    assert ls.explained_by_ties(A, W, sinv, zi, msk, u1, u2, got, want,
                                alpha=ALPHA, beta=BETA).all()
    np.testing.assert_array_equal(got[~real], zi[~real])
    np.testing.assert_array_equal(want[~real], zi[~real])


@pytest.mark.parametrize("n_dtype,w_dtype", [("int16", "bfloat16"),
                                             ("int32", "int32"),
                                             ("int16", "int32")])
@pytest.mark.parametrize("maxd,c", [(8, 1), (1, 2)])
def test_words_read_mode_matches_pallas(n_dtype, w_dtype, maxd, c):
    nb, tb = 4, 256
    ndk, mirror, words, vec = _case(nb, maxd, tb, c, seed=maxd + 7 * c)
    ndk = ndk.astype(n_dtype)
    mj = jnp.asarray(mirror, w_dtype)
    jout, jz, jn = jls.gibbs_sample_docblock(
        ndk, jnp.take(mj, jnp.asarray(words), axis=0), *vec, alpha=ALPHA,
        beta=BETA, tb=tb, interpret=True)
    t_ndk = torch.from_numpy(ndk.copy())
    tout, tz, tn = ls.gibbs_sample_docblock(
        t_ndk, _mirror(mirror, w_dtype), *_t(*vec), alpha=ALPHA, beta=BETA,
        tb=tb, words=torch.from_numpy(words))
    assert tout is t_ndk
    jz, tz = np.asarray(jz), tz.numpy()
    W = np.asarray(jnp.take(mj, jnp.asarray(words), axis=0), np.float32)
    _tie_rule(_doc_rows(ndk, vec[2], tb), W, vec, tz, jz)
    zi, drel, msk = vec[1], vec[2], vec[3]
    for out, z, nkd in ((tout.numpy(), tz, tn.numpy()),
                        (np.asarray(jout), jz, np.asarray(jn))):
        np.testing.assert_array_equal(out.reshape(nb * maxd, -1),
                                      _moved(ndk, zi, z, drel, msk, tb))
        assert out.dtype == np.dtype(n_dtype)
        np.testing.assert_array_equal(nkd, _nkd(zi, z, msk, c))


@pytest.mark.parametrize("w_dtype", ["bfloat16", "int32"])
@pytest.mark.parametrize("maxd,c", [(8, 1), (1, 2)])
def test_words_build_mode_matches_pallas_and_read_mode(w_dtype, maxd, c):
    nb, tb = 4, 256
    ndk, mirror, words, vec = _case(nb, maxd, tb, c, seed=3 + maxd + c)
    mt, wt, vt = _mirror(mirror, w_dtype), torch.from_numpy(words), _t(*vec)
    bz, bn = ls.gibbs_sample_docblock_build(mt, *vt, alpha=ALPHA, beta=BETA,
                                            tb=tb, maxd=maxd, words=wt)
    _, rz, rn = ls.gibbs_sample_docblock(
        torch.from_numpy(ndk.astype(np.int16)), mt, *vt, alpha=ALPHA,
        beta=BETA, tb=tb, words=wt)
    real = vec[3] > 0
    np.testing.assert_array_equal(bz.numpy()[real], rz.numpy()[real])
    np.testing.assert_array_equal(bn.numpy(), rn.numpy())
    mj = jnp.asarray(mirror, w_dtype)
    Wj = jnp.take(mj, jnp.asarray(words), axis=0)
    jz, jn = jls.gibbs_sample_docblock_build(
        Wj, *vec, alpha=ALPHA, beta=BETA, tb=tb, maxd=maxd, interpret=True)
    jz = np.asarray(jz)
    _tie_rule(_doc_rows(ndk, vec[2], tb), np.asarray(Wj, np.float32), vec,
              bz.numpy(), jz)
    np.testing.assert_array_equal(np.asarray(jn), _nkd(vec[1], jz, vec[3],
                                                       c))
    np.testing.assert_array_equal(bn.numpy(), _nkd(vec[1], bz.numpy(),
                                                   vec[3], c))


def test_words_form_equals_the_gathered_rows():
    """The plain ``words=`` form is the plain version on ``W[words]``, bit
    for bit, in both modes; a [V, K] mirror reads as [V, C, 128]."""
    nb, maxd, tb, c = 3, 4, 128, 2
    ndk, mirror, words, vec = _case(nb, maxd, tb, c, seed=5)
    mt, wt, vt = _mirror(mirror, "bfloat16"), torch.from_numpy(words), \
        _t(*vec)
    W3 = mt[wt.long()]
    kw = dict(alpha=ALPHA, beta=BETA, tb=tb)
    a, b = torch.from_numpy(ndk.copy()), torch.from_numpy(ndk.copy())
    _, za, na = ls.gibbs_sample_docblock(a, W3, *vt, **kw)
    _, zb, nb_ = ls.gibbs_sample_docblock(b, mt.view(V + 1, -1), *vt,
                                          words=wt, **kw)
    assert torch.equal(za, zb) and torch.equal(na, nb_) and torch.equal(a, b)
    ga = ls.gibbs_sample_docblock_build(W3, *vt, maxd=maxd, **kw)
    gb = ls.gibbs_sample_docblock_build(mt, *vt, maxd=maxd, words=wt, **kw)
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))


def _operands():
    ndk, mirror, words, vec = _case(2, 4, 64, 1, seed=9)
    return (torch.from_numpy(ndk.copy()), _mirror(mirror, "bfloat16"),
            torch.from_numpy(words), _t(*vec))


def test_words_out_of_range_raise_in_the_plain_version():
    ndk, mt, wt, vt = _operands()
    kw = dict(alpha=ALPHA, beta=BETA, tb=64)
    for bad in (-1, V + 1):
        w = wt.clone()
        w[5] = bad
        with pytest.raises(IndexError):
            ls.gibbs_sample_docblock(ndk, mt, *vt, words=w, **kw)
        with pytest.raises(IndexError):
            ls.gibbs_sample_docblock_build(mt, *vt, words=w, maxd=4, **kw)


def test_words_operand_errors():
    ndk, mt, wt, vt = _operands()
    kw = dict(alpha=ALPHA, beta=BETA, tb=64)
    with pytest.raises(TypeError, match="words must be int32 or int64"):
        ls.gibbs_sample_docblock(ndk, mt, *vt, words=wt.float(), **kw)
    with pytest.raises(TypeError, match="the mirror must be one of"):
        ls.gibbs_sample_docblock(ndk, mt.float(), *vt, words=wt, **kw)
    with pytest.raises(TypeError, match="the mirror must be one of"):
        ls.gibbs_sample_docblock_build(mt.to(torch.int16), *vt, words=wt,
                                       maxd=4, **kw)
    with pytest.raises(ValueError, match=r"a row must hold C \* 128 = 128"):
        ls.gibbs_sample_docblock(ndk, mt.view(-1, 64), *vt, words=wt, **kw)
    with pytest.raises(ValueError, match=r"a row must hold C \* 128 = 128"):
        ls.gibbs_sample_docblock_build(torch.zeros(V + 1, 2, 128,
                                                   dtype=torch.bfloat16),
                                       *vt, words=wt, maxd=4, **kw)
    with pytest.raises(ValueError, match=r"words shape \(64,\) != \(128,\)"):
        ls.gibbs_sample_docblock(ndk, mt, *vt, words=wt[:64], **kw)


def test_words_launch_on_other_devices_or_raise():
    """Off the CPU the ``words=`` form goes to the kernel path, which
    raises for a device it has no kernel for; nothing is counted."""
    ls.reset_launches()
    ndk, mt, wt, vt = (x.to("meta") if isinstance(x, torch.Tensor)
                       else [y.to("meta") for y in x] for x in _operands())
    kw = dict(alpha=ALPHA, beta=BETA, tb=64)
    with pytest.raises(ValueError, match="no sampler kernel"):
        ls.gibbs_sample_docblock(ndk, mt, *vt, words=wt, **kw)
    with pytest.raises(ValueError, match="no sampler kernel"):
        ls.gibbs_sample_docblock_build(mt, *vt, words=wt, maxd=4, **kw)
    assert all(v == 0 for v in ls.LAUNCHES.values())
    assert ls.docblock_shared_bytes(512, 16, 8) == 88_064
