"""The port's sequence and pipeline parallelism
(``multiverso_tpu_torch/parallel/{ring_attention,pipeline}.py``) against
the JAX package's on the same inputs, made from a seed with numpy.

The cases of ``tests/test_parallel.py`` (``TestRingAttention``,
``TestRingAttentionGradients``, ``TestUlyssesAttention``, ``TestPipeline``)
on the port's CPU meshes of the same shape ((8, 1), and 4x2 for the mixed
mesh), each also run through the reference function on ``mesh_dp8`` /
``mesh8``.

Tolerances are those of ``tests/test_parallel.py``: attention within
rtol = atol = 2e-4 of a float64 dense attention and of the reference;
gradients of the ring against dense autograd (and against the reference's
ring) with cosine above 0.9999 and the norm ratio within 1%; the pipeline
forward within rtol = atol = 2e-5 of the sequential oracle and of the
reference, its gradients within rtol = atol = 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.parallel import pipeline as jpipe
from multiverso_tpu.parallel import ring_attention as jring_attention
from multiverso_tpu.parallel import ulysses_attention as julysses_attention
from multiverso_tpu_torch import core as tcore
from multiverso_tpu_torch.parallel import ring_attention, ulysses_attention
from multiverso_tpu_torch.parallel.pipeline import (pipeline_apply,
                                                    sequential_oracle)

ATTN_TOL = 2e-4
FWD_TOL, GRAD_TOL = 2e-5, 5e-4


@pytest.fixture
def tmesh_dp8():
    return tcore.Mesh([["cpu"]] * 8)


@pytest.fixture
def tmesh8():
    return tcore.Mesh([["cpu"] * 2] * 4)


def dense_attention(q, k, v, causal=False):
    scale = 1.0 / np.sqrt(q.shape[-1])
    s = np.einsum("bqhd,bkhd->bhqk", q, k, dtype=np.float64) * scale
    if causal:
        qi = np.arange(s.shape[2])[:, None]
        ki = np.arange(s.shape[3])[None, :]
        s = np.where(qi >= ki, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v, dtype=np.float64)


def _qkv(b=2, s=64, h=4, d=16, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda: rng.normal(0, 1, (b, s, h, d)).astype(np.float32)
    return mk(), mk(), mk()


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, *wants, tol):
    for want in wants:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=tol, atol=tol)


class TestRingAttention:
    @pytest.mark.parametrize("causal", [False, True])
    def test_matches_dense(self, mesh_dp8, tmesh_dp8, causal):
        q, k, v = _qkv()
        out = ring_attention(*_t(q, k, v), mesh=tmesh_dp8, causal=causal)
        assert out.dtype == torch.float32 and out.shape == q.shape
        ref = jring_attention(*_j(q, k, v), mesh=mesh_dp8, causal=causal)
        _close(out.numpy(), dense_attention(q, k, v, causal=causal), ref,
               tol=ATTN_TOL)

    def test_seq_divisibility_checked(self, mesh_dp8, tmesh_dp8):
        q, k, v = _qkv(s=30)  # 30 % 8 != 0
        with pytest.raises(ValueError, match="not divisible"):
            ring_attention(*_t(q, k, v), mesh=tmesh_dp8)
        with pytest.raises(ValueError, match="not divisible"):
            jring_attention(*_j(q, k, v), mesh=mesh_dp8)

    def test_mixed_axes_mesh(self, mesh8, tmesh8):
        # the sequence ring over the data axis of a 4x2 mesh
        q, k, v = _qkv(s=32, h=2)
        out = ring_attention(*_t(q, k, v), mesh=tmesh8, axis="data",
                             causal=True)
        ref = jring_attention(*_j(q, k, v), mesh=mesh8, axis="data",
                              causal=True)
        _close(out.numpy(), dense_attention(q, k, v, causal=True), ref,
               tol=ATTN_TOL)

    def test_ring_over_the_model_axis(self, mesh8, tmesh8):
        # the model axis of the 4x2 mesh: a ring of 2
        q, k, v = _qkv(s=32, h=2, seed=3)
        out = ring_attention(*_t(q, k, v), mesh=tmesh8, axis="model")
        ref = jring_attention(*_j(q, k, v), mesh=mesh8, axis="model")
        _close(out.numpy(), dense_attention(q, k, v), ref, tol=ATTN_TOL)


def _cos_ratio(g, w):
    g, w = np.asarray(g, np.float64).ravel(), np.asarray(w,
                                                        np.float64).ravel()
    cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w) + 1e-12)
    return cos, np.linalg.norm(g) / (np.linalg.norm(w) + 1e-12)


class TestRingAttentionGradients:
    def test_differentiable_matches_dense_grad(self, mesh_dp8, tmesh_dp8):
        # grads THROUGH the ring, against autograd of dense attention, and
        # against the reference's ring
        q, k, v = _qkv(b=1, s=32, h=2, d=8, seed=5)
        qt, kt, vt = (x.requires_grad_(True) for x in _t(q, k, v))
        out = ring_attention(qt, kt, vt, mesh=tmesh_dp8, causal=True)
        got = torch.autograd.grad((out.float() ** 2).sum(), (qt, kt, vt))

        qd, kd, vd = (x.requires_grad_(True) for x in _t(q, k, v))
        scale = 1.0 / np.sqrt(q.shape[-1])
        s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale
        qi = torch.arange(s.shape[2])[:, None]
        ki = torch.arange(s.shape[3])[None, :]
        s = torch.where(qi >= ki, s, -1e30)
        dense = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1),
                             vd)
        want = torch.autograd.grad((dense ** 2).sum(), (qd, kd, vd))

        def ring_loss(q, k, v):
            o = jring_attention(q, k, v, mesh=mesh_dp8, causal=True)
            return (o.astype(jnp.float32) ** 2).sum()

        ref = jax.grad(ring_loss, argnums=(0, 1, 2))(*_j(q, k, v))
        for g, w, r in zip(got, want, ref):
            for other in (w.numpy(), np.asarray(r)):
                cos, ratio = _cos_ratio(g.numpy(), other)
                assert cos > 0.9999, cos
                assert 0.99 < ratio < 1.01, ratio


class TestUlyssesAttention:
    @pytest.mark.parametrize("causal", [False, True])
    def test_matches_dense(self, mesh_dp8, tmesh_dp8, causal):
        q, k, v = _qkv(h=8)  # heads must divide the axis too
        out = ulysses_attention(*_t(q, k, v), mesh=tmesh_dp8, causal=causal)
        assert out.dtype == torch.float32 and out.shape == q.shape
        ref = julysses_attention(*_j(q, k, v), mesh=mesh_dp8,
                                 causal=causal)
        _close(out.numpy(), dense_attention(q, k, v, causal=causal), ref,
               tol=ATTN_TOL)

    def test_head_divisibility_checked(self, mesh_dp8, tmesh_dp8):
        q, k, v = _qkv(h=4)  # 4 heads % 8 devices != 0
        with pytest.raises(ValueError, match="divide"):
            ulysses_attention(*_t(q, k, v), mesh=tmesh_dp8)
        with pytest.raises(ValueError, match="divide"):
            julysses_attention(*_j(q, k, v), mesh=mesh_dp8)


class TestPipeline:
    """The GPipe schedule vs the sequential oracle and the reference's
    schedule, forward and grads."""

    @staticmethod
    def _stages(n, d, seed):
        rng = np.random.default_rng(seed)
        return {"w": rng.normal(0, 0.5, (n, d, d)).astype(np.float32),
                "b": rng.normal(0, 0.1, (n, d)).astype(np.float32)}

    @staticmethod
    def _fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    @staticmethod
    def _jfn(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    def _forward(self, jmesh, tmesh, n, d, batch, seed, **kw):
        params = self._stages(n, d, seed)
        x = np.random.default_rng(seed + 1).normal(
            size=(batch, d)).astype(np.float32)
        tp = {k: torch.tensor(v) for k, v in params.items()}
        got = pipeline_apply(tp, torch.tensor(x), self._fn, mesh=tmesh, **kw)
        assert got.shape == x.shape
        want = sequential_oracle(tp, torch.tensor(x), self._fn)
        ref = jpipe.pipeline_apply(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
            self._jfn, mesh=jmesh, **kw)
        _close(got.numpy(), want.numpy(), ref, tol=FWD_TOL)

    def test_forward_matches_sequential(self, mesh_dp8, tmesh_dp8):
        self._forward(mesh_dp8, tmesh_dp8, 8, 16, 32, 0, axis="data")

    def test_more_microbatches_lower_bubble_same_result(self, mesh_dp8,
                                                        tmesh_dp8):
        self._forward(mesh_dp8, tmesh_dp8, 8, 8, 48, 2, axis="data",
                      microbatches=16)

    def test_two_stage_model_axis(self, mesh8, tmesh8):
        # the pipeline over the MODEL axis of the 4x2 mesh (S = 2 stages)
        self._forward(mesh8, tmesh8, 2, 12, 8, 4)

    def test_grads_match_sequential(self, mesh_dp8, tmesh_dp8):
        params = self._stages(8, 8, seed=6)
        x = np.random.default_rng(7).normal(size=(16, 8)).astype(np.float32)

        def grads(fn):
            tp = {k: torch.tensor(v, requires_grad=True)
                  for k, v in params.items()}
            loss = (fn(tp, torch.tensor(x)) ** 2).sum()
            return dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))

        got = grads(lambda p, x: pipeline_apply(p, x, self._fn,
                                                mesh=tmesh_dp8, axis="data"))
        want = grads(lambda p, x: sequential_oracle(p, x, self._fn))
        ref = jax.grad(lambda p: (jpipe.pipeline_apply(
            p, jnp.asarray(x), self._jfn, mesh=mesh_dp8,
            axis="data") ** 2).sum())(
                {k: jnp.asarray(v) for k, v in params.items()})
        for k in params:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=GRAD_TOL, atol=GRAD_TOL)
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       rtol=GRAD_TOL, atol=GRAD_TOL)

    def test_shape_validation(self, tmesh_dp8):
        params = {k: torch.tensor(v)
                  for k, v in self._stages(4, 8, seed=8).items()}  # 4 != 8
        with pytest.raises(ValueError, match="leading axis"):
            pipeline_apply(params, torch.zeros(16, 8), self._fn,
                           mesh=tmesh_dp8, axis="data")
        params8 = {k: torch.tensor(v)
                   for k, v in self._stages(8, 8, seed=8).items()}
        with pytest.raises(ValueError, match="not divisible"):
            pipeline_apply(params8, torch.zeros(10, 8), self._fn,
                           mesh=tmesh_dp8, axis="data", microbatches=4)

    def test_axis_devices_carry_the_stages(self):
        # stage s runs on device s of the axis: the model axis is replica
        # 0's shard devices, the data axis each data row's first device
        m = tcore.Mesh([["cpu", "meta"], ["meta", "meta"]])
        assert [d.type for d in m.axis_devices("model")] == ["cpu", "meta"]
        assert [d.type for d in m.axis_devices("data")] == ["cpu", "meta"]
        with pytest.raises(ValueError, match="axis"):
            m.axis_devices("seq")
