"""The per-card sharded row forms against the JAX package, at the splits
that launching once per card makes risky.

``gather_rows_sharded`` and ``gather_rows_mesh`` launch one
``mv_row_gather_mesh`` per card over every shard it holds, and
``row_scatter_add_sharded`` launches the masked row scatter once per card
over each shard's real lanes. On the CPU the wrappers run their plain
versions; here those are held, bit for bit, against

- ``build_row_gather_sharded`` and ``build_row_scatter_add_sharded``
  (``interpret=True``, as ``tests/test_table_kernels.py`` runs them) on a
  (1, 4) mesh of the JAX package's virtual CPU devices, on the (4, L) lane
  slices;
- the in-trace ``_sharded_gather_rows`` (masked partial rows per shard,
  psum'd), jitted on a param split over ``model`` with
  ``MVTPU_KERNELS=xla`` as ``tests/test_torch_mesh_superstep.py`` runs
  the reference, its Pallas gather in interpret mode;

at these splits: an empty shard, every lane on one shard, one lane, real
lanes on a shard's last row beside its pads, neighbouring shards that
hold equal local ids, and ``valid`` 0 on real lanes (the scatter); rows
of float32 and int32 and of 2-byte bfloat16 and int16 (the gather).

Tolerances: none; gathers copy bits and each scatter row takes its valid
deltas in lane order in both packages (deltas of mixed magnitude, so that
another order would show). ``tests/test_torch_cuda.py`` holds the CUDA
kernels against these plain versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from multiverso_tpu import core as jcore
from multiverso_tpu.ops import table_kernels as jtk
from multiverso_tpu.tables import hashing as jhash
from multiverso_tpu_torch.ops import table_kernels as tk

S, RPS, COLS = 4, 6, 5
SPLITS = ["zipf", "empty_shard", "one_shard", "single", "last_row",
          "equal_local"]
GATHER_DTYPES = [(torch.float32, jnp.float32), (torch.int32, jnp.int32),
                 (torch.bfloat16, jnp.bfloat16), (torch.int16, jnp.int16)]


@pytest.fixture()
def mesh14(devices, monkeypatch):
    monkeypatch.setenv("MVTPU_KERNELS", "xla")
    m = jcore.init(devices=devices[:S], data_parallel=1, model_parallel=S)
    yield m
    jcore.shutdown()


def _split_ids(split, rng):
    """Global ids (request order) over S shards of RPS rows."""
    e = RPS - 1
    if split == "zipf":
        ids = np.clip(rng.zipf(1.3, 60) - 1, 0, S * RPS - 1)
    elif split == "empty_shard":
        ids = rng.integers(0, S * RPS, 40)
        ids = ids[ids // RPS != 1]
    elif split == "one_shard":
        ids = rng.integers(2 * RPS, 3 * RPS, 30)
    elif split == "single":
        ids = np.asarray([RPS + 2])
    elif split == "last_row":
        # shard 0: a run on its last row, then its pads (shard 1 is longer)
        ids = np.asarray([0, e, e] + [RPS + 1] * 9 + [2 * RPS + e])
    else:
        # shard 0 ends and shard 1 starts on local 4; shard 2 ends and
        # shard 3 starts on local 0
        ids = np.asarray([1, 4, 4, RPS + 4, RPS + 4, RPS + 5, 2 * RPS,
                          3 * RPS, 3 * RPS])
    return rng.permutation(ids).astype(np.int32)


def _slices(gids, arrays, pads):
    """Shard-sorted global ids -> (local, *arrays) lane slices, valid, the
    shard ids and positions (the reference's own slicing)."""
    shard_ids = gids // RPS
    local = (gids - shard_ids * RPS).astype(np.int32)
    sliced, valid, pos = jhash.shard_lane_slices(
        shard_ids, S, [local, *arrays], [np.int32(RPS - 1), *pads])
    return sliced, valid, shard_ids, pos


def _put(mesh, x, sharded=True):
    x = np.asarray(x)
    spec = P("model", *([None] * (x.ndim - 1))) if sharded else P()
    return jax.device_put(x, NamedSharding(mesh, spec))


def _table(rng, t_dtype, j_dtype):
    """A (S * RPS, COLS) table as the port's tensor and the reference's
    array of the same bits: finite floats (the in-trace reference's psum
    adds zero rows, which would quiet a NaN), integers over their range."""
    shape = (S * RPS, COLS)
    if t_dtype.is_floating_point:
        host = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(t_dtype)
    else:
        info = torch.iinfo(t_dtype)
        host = torch.from_numpy(rng.integers(info.min, info.max, shape)
                                ).to(t_dtype)
    ref = jax.lax.bitcast_convert_type(jnp.asarray(_bits(host)), j_dtype)
    return host, ref


def _bits(t: torch.Tensor) -> np.ndarray:
    kind = torch.int16 if t.element_size() == 2 else torch.int32
    return t.contiguous().view(kind).numpy()


def _same_bits(got: torch.Tensor, want) -> None:
    w = np.asarray(want)
    np.testing.assert_array_equal(
        _bits(got), w.view(np.int16 if w.dtype.itemsize == 2 else np.int32))


@pytest.mark.parametrize("t_dtype,j_dtype", GATHER_DTYPES)
@pytest.mark.parametrize("split", SPLITS)
def test_gather_sharded_plain_matches_reference(mesh14, split, t_dtype,
                                                j_dtype):
    rng = np.random.default_rng(SPLITS.index(split))
    host, ref = _table(rng, t_dtype, j_dtype)
    ids = _split_ids(split, rng)
    order = np.argsort(ids // RPS, kind="stable")
    (local,), valid, shard_ids, pos = _slices(ids[order], [], [])
    inv = np.zeros(len(ids), np.int32)
    inv[order] = shard_ids * local.shape[1] + pos
    fn = jtk.build_row_gather_sharded(num_cols=COLS, tiles=0,
                                      interpret=True, mesh=mesh14,
                                      axis="model", lead=S * RPS)
    want = fn(_put(mesh14, ref), _put(mesh14, local),
              _put(mesh14, inv, sharded=False))
    got = tk.gather_rows_sharded(list(host.chunk(S)),
                                 torch.from_numpy(local),
                                 torch.from_numpy(inv), counts=valid.sum(1))
    _same_bits(got, want)
    _same_bits(got, np.asarray(ref)[ids])


@pytest.mark.parametrize("t_dtype,j_dtype", GATHER_DTYPES)
@pytest.mark.parametrize("split", SPLITS)
def test_gather_mesh_plain_matches_in_trace_reference(mesh14, split,
                                                      t_dtype, j_dtype):
    rng = np.random.default_rng(10 + SPLITS.index(split))
    host, ref = _table(rng, t_dtype, j_dtype)
    ids = _split_ids(split, rng)
    want = jax.jit(lambda p, i: jtk._sharded_gather_rows(
        p, i, mesh14, "model"))(_put(mesh14, ref), jnp.asarray(ids))
    param = tk.ShardedParam(b.clone() for b in host.chunk(S))
    got = tk.gather_rows(param, torch.from_numpy(ids))
    _same_bits(got, want)
    _same_bits(torch.cat(param.shards), ref)            # untouched


def _mixed(rng, shape):
    return (rng.standard_normal(shape)
            * 10.0 ** rng.integers(-3, 8, shape)).astype(np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("split", SPLITS)
def test_scatter_sharded_plain_matches_reference(mesh14, split, dtype):
    """Sorted lanes, a quarter of the real lanes gated off by ``valid``."""
    rng = np.random.default_rng(20 + SPLITS.index(split))
    if dtype == np.float32:
        param = _mixed(rng, (S * RPS, COLS))
    else:
        param = rng.integers(-50, 50, (S * RPS, COLS)).astype(np.int32)
    sids = np.sort(_split_ids(split, rng))
    n = len(sids)
    deltas = (_mixed(rng, (n, COLS)) if dtype == np.float32
              else rng.integers(-9, 9, (n, COLS)).astype(np.int32))
    keep = rng.random(n) > 0.25
    (local, sd, sk), valid, _, _ = _slices(sids, [deltas, keep], [0, False])
    fn = jtk.build_row_scatter_add_sharded(num_cols=COLS, tiles=0,
                                           interpret=True, mesh=mesh14,
                                           axis="model", lead=S * RPS)
    want = np.asarray(fn(_put(mesh14, param), _put(mesh14, local),
                         _put(mesh14, sd), _put(mesh14, sk)))
    shards = [torch.from_numpy(b.copy()) for b in np.split(param, S)]
    tk.row_scatter_add_sharded(shards, torch.from_numpy(local),
                               torch.from_numpy(sd), torch.from_numpy(sk),
                               counts=valid.sum(1))
    got = torch.cat(shards).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    _check_split(split, local, valid.sum(1))


def _check_split(split, local, counts):
    """The sorted lane slices show the split they are named for."""
    lanes = local.shape[1]
    if split == "empty_shard":
        assert counts[1] == 0 and counts.sum() > 0
    elif split == "one_shard":
        assert counts.tolist() == [0, 0, counts[2], 0]
    elif split == "single":
        assert counts.sum() == 1
    elif split == "last_row":    # a real run on row RPS - 1, then pads
        assert local[0, counts[0] - 1] == local[0, counts[0] - 2] == RPS - 1
        assert counts[0] < lanes
    elif split == "equal_local":
        assert local[0, counts[0] - 1] == local[1, 0]
        assert local[2, counts[2] - 1] == local[3, 0]
