"""utils/quantization in the port against the JAX package's.

The seven cases of ``tests/test_quantization.py`` run on the port's torch
quantizers (round-trip bounds, unbiasedness, error feedback, the 1-bit
packing). The numpy twins and ``ResidualStore`` the port carries are
held against the reference's (``multiverso_tpu/server/wire.py``) bit for
bit, and the torch quantizers against the JAX ones on the same numpy
input.

Tolerances: signs, packed signs, ``q`` and a dequantize of the same
(``q``, scales) exact. The 1-bit scales and residual within rtol 1e-6,
atol 1e-6: each scale is a float32 sum of up to ``block`` magnitudes,
which torch and XLA may add in different orders (a few ulps of the sum),
and the residual carries that difference. The bounds of the reference's
cases are unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.server import wire as jwire
from multiverso_tpu.utils import quantization as jq
from multiverso_tpu_torch.utils import quantization as tq
from multiverso_tpu_torch.utils.quantization import (OneBitQuantizer,
                                                     RoundingQuantizer)

RTOL, ATOL = 1e-6, 1e-6


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def test_onebit_roundtrip_shape():
    q = OneBitQuantizer(block=64)
    x = _t(np.random.default_rng(0).normal(0, 1, (37, 13)))
    sign, ps, ns, resid = q.quantize(x)
    deq = q.dequantize(sign, ps, ns, x.shape)
    assert deq.shape == x.shape
    # error feedback: residual == x - dequantized
    np.testing.assert_allclose(resid.numpy(), (x - deq).numpy(), atol=1e-5)


def test_onebit_error_feedback_converges():
    """Accumulated 1-bit quantized deltas track the true sum (the
    1-bit-SGD guarantee: error feedback keeps the bias bounded)."""
    q = OneBitQuantizer(block=128)
    rng = np.random.default_rng(1)
    true_sum = np.zeros((256,), np.float32)
    quant_sum = np.zeros((256,), np.float32)
    resid = torch.zeros(256)
    for i in range(200):
        delta = rng.normal(0, 1, 256).astype(np.float32)
        true_sum += delta
        sign, ps, ns, resid = q.quantize(_t(delta), resid)
        quant_sum += q.dequantize(sign, ps, ns, (256,)).numpy()
    # the residual bounds the gap between the streams
    gap = np.abs(true_sum - quant_sum)
    assert gap.max() <= resid.abs().max().item() + 1e-4


def test_onebit_preserves_sign_and_scale():
    q = OneBitQuantizer(block=8)
    x = torch.tensor([1.0, 1.0, 1.0, 1.0, -2.0, -2.0, -2.0, -2.0])
    sign, ps, ns, _ = q.quantize(x)
    deq = q.dequantize(sign, ps, ns, (8,)).numpy()
    np.testing.assert_allclose(deq[:4], 1.0, atol=1e-6)
    np.testing.assert_allclose(deq[4:], -2.0, atol=1e-6)


def test_rounding_unbiased():
    q = RoundingQuantizer(bits=8, block=256)
    x = _t(np.random.default_rng(2).normal(0, 1, 256))
    acc = np.zeros(256)
    n = 300
    for i in range(n):
        qq, scale = q.quantize(x, torch.Generator().manual_seed(i))
        acc += q.dequantize(qq, scale, (256,)).numpy()
    # mean of stochastic roundings converges to x
    np.testing.assert_allclose(acc / n, x.numpy(), atol=0.01)


def test_rounding_error_bound():
    q = RoundingQuantizer(bits=16, block=128)
    x = _t(np.random.default_rng(3).normal(0, 5, 1000))
    qq, scale = q.quantize(x, torch.Generator().manual_seed(0))
    deq = q.dequantize(qq, scale, (1000,)).numpy()
    # per-element error bounded by one grid cell of its block
    step = np.repeat(scale.numpy(), 128)[:1000]
    assert np.all(np.abs(deq - x.numpy()) <= step + 1e-6)


def test_rounding_int8_range():
    q = RoundingQuantizer(bits=8, block=64)
    x = _t(np.random.default_rng(4).normal(0, 100, 64))
    qq, _ = q.quantize(x, torch.Generator().manual_seed(0))
    assert qq.dtype == torch.int8
    assert int(qq.abs().max()) <= 127


def test_onebit_sign_packing_roundtrip():
    q = OneBitQuantizer(block=64)
    rng = np.random.default_rng(5)
    delta = _t(rng.normal(0, 1, (130,)))
    sign, ps, ns, _ = q.quantize(delta)
    packed = q.pack_signs(sign)
    assert packed.dtype == torch.uint8
    assert packed.shape == (sign.shape[0], sign.shape[1] // 8)  # true 1-bit
    assert torch.equal(q.unpack_signs(packed), sign)


# -- the port against the JAX package ------------------------------------------


@pytest.mark.parametrize("shape,block,resid", [
    ((37, 13), 64, False), ((37, 13), 64, True), ((1000,), 512, True),
    ((10_001, 10), 512, False), ((8,), 8, False)])
def test_onebit_matches_reference(shape, block, resid):
    """The torch quantizer against the JAX one on the same input: signs
    and packed signs exact, scales and residual within the stated
    tolerance; the numpy twin's packed signs exact too."""
    rng = np.random.default_rng(sum(shape) + block)
    x = rng.normal(0, 1, shape).astype(np.float32)
    r = rng.normal(0, 0.1, shape).astype(np.float32) if resid else None
    t, j = OneBitQuantizer(block=block), jq.OneBitQuantizer(block=block)
    ts, tp, tn, tr = t.quantize(_t(x), None if r is None else _t(r))
    js, jp, jn, jr = j.quantize(jnp.asarray(x),
                                None if r is None else jnp.asarray(r))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts.dtype == torch.int8 and tp.dtype == tn.dtype == torch.float32
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=RTOL,
                               atol=ATOL)
    packed = t.pack_signs(ts)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(j.pack_signs(js)))
    np.testing.assert_array_equal(
        packed.numpy(), tq.one_bit_quantize_np(x, r, block=block)[0])
    assert torch.equal(t.unpack_signs(packed), ts)


@pytest.mark.parametrize("bits", [8, 16])
def test_rounding_dequantize_matches_reference(bits):
    """The torch dequantize of the JAX quantizer's own (q, scales) equals
    the JAX dequantize bit for bit; the torch quantizer's q lies within
    one step of the JAX one's (the draws differ)."""
    rng = np.random.default_rng(bits)
    x = rng.normal(0, 3, (300, 7)).astype(np.float32)
    t = RoundingQuantizer(bits=bits, block=128)
    j = jq.RoundingQuantizer(bits=bits, block=128)
    jqq, jscale = j.quantize(jnp.asarray(x), jax.random.PRNGKey(0))
    want = np.asarray(j.dequantize(jqq, jscale, x.shape))
    got = t.dequantize(torch.from_numpy(np.array(jqq)),
                       torch.from_numpy(np.array(jscale)), x.shape)
    assert got.numpy().tobytes() == want.tobytes()
    tqq, tscale = t.quantize(_t(x), torch.Generator().manual_seed(0))
    assert tqq.dtype == (torch.int8 if bits == 8 else torch.int16)
    np.testing.assert_allclose(tscale.numpy(), np.asarray(jscale),
                               rtol=RTOL, atol=0)
    assert np.abs(tqq.numpy().astype(np.int32)
                  - np.asarray(jqq).astype(np.int32)).max() <= 1


@pytest.mark.parametrize("shape,block", [((37, 13), 64), ((1000,), 512),
                                         ((4, 6), 8)])
def test_numpy_twins_match_reference(shape, block):
    """one_bit_* and rounding_* numpy twins: the reference's outputs bit
    for bit, for the same input, residual and numpy generator."""
    rng = np.random.default_rng(block)
    x = rng.normal(0, 1, shape).astype(np.float32)
    r = rng.normal(0, 0.1, shape).astype(np.float32)
    for resid in (None, r):
        got = tq.one_bit_quantize_np(x, resid, block=block)
        want = jwire.one_bit_quantize_np(x, resid, block=block)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        deq = tq.one_bit_dequantize_np(*got[:3], shape, block=block)
        assert deq.tobytes() == jwire.one_bit_dequantize_np(
            *want[:3], shape, block=block).tobytes()
    for bits in (8, 16):
        got = tq.rounding_quantize_np(x, np.random.default_rng(1), bits,
                                      block)
        want = jwire.rounding_quantize_np(x, np.random.default_rng(1),
                                          bits, block)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert tq.rounding_dequantize_np(*got, shape).tobytes() == \
            jwire.rounding_dequantize_np(*want, shape).tobytes()


def test_residual_store_matches_reference():
    """ResidualStore keys residuals by (table, kind, shape, block) in
    both packages: the same takes, puts and lengths."""
    t, j = tq.ResidualStore(), jwire.ResidualStore()
    ops = [("put", 1, "dense", (4, 3), 512, np.ones((4, 3), np.float32)),
           ("put", 2, "dense", (4, 3), 512, np.zeros((4, 3), np.float32)),
           ("take", 1, "dense", (4, 3), 256, None),
           ("take", 1, "rows", (4, 3), 512, None),
           ("take", 1, "dense", (4, 3), 512, None),
           ("take", 1, "dense", (4, 3), 512, None),
           ("put", 3, "kv", [5], 64, np.full(5, 2.0, np.float32))]
    for op, *args in ops:
        if op == "put":
            t.put(*args)
            j.put(*args)
        else:
            a, b = t.take(*args[:4]), j.take(*args[:4])
            assert (a is None) == (b is None)
            if a is not None:
                assert a.tobytes() == b.tobytes()
        assert len(t) == len(j)
    t.clear()
    j.clear()
    assert len(t) == len(j) == 0
    assert sorted(tq.__all__) == sorted(jq.__all__)
