"""The port's binding-compat API (``multiverso_tpu_torch/bindings``)
against the JAX package's (``multiverso_tpu/bindings``).

Every test of ``tests/test_bindings.py`` on the port, on a CPU (8, 1)
mesh, then parity: the same add sequences, made from a seed with numpy,
through the handlers, ``mv_shared`` and ``ParamManager`` of both packages
on (1, 1) and (8, 1) CPU meshes. The matrix handler's row get / add reach
the sharded row gather and row scatter-add kernels (``tk.LAUNCHES``, with
a fake card standing in for CUDA).

Tolerances: bit for bit where the reference is exact (the default
updater's adds, row adds without duplicate ids, the delta syncs); rtol
1e-6 (atol 1e-7, for values that cancel to near zero, as
``tests/test_torch_kv_once_per_card.py`` has it) where a sum's order may
differ (duplicate row ids) or an updater's elementwise expression may round
a few ulps apart (two frameworks; XLA contracts a*b + c into an FMA);
under 1-bit compression the merged parameters within rtol 1e-5, atol 1e-6
of the reference's at each of 30 syncs of deltas drawn at 0.1, a gradient
step's size. The blocks' scales are float32 means whose sum order differs,
so the difference grows by about an ulp of a scale a sync: about 2e-7
after 30 syncs here, and past 1e-6 at unit deltas.
"""

import jax
import numpy as np
import pytest
import torch

import multiverso_tpu.bindings as jmultiverso
import multiverso_tpu_torch.bindings as multiverso
from multiverso_tpu import core as jcore
from multiverso_tpu.bindings import jax_ext
from multiverso_tpu.tables import reset_tables as jreset_tables
from multiverso_tpu.updaters import AddOption as JAddOption
from multiverso_tpu_torch import core as tcore
from multiverso_tpu_torch.bindings import torch_ext
from multiverso_tpu_torch.ops import table_kernels as tk
from multiverso_tpu_torch.tables import reset_tables
from multiverso_tpu_torch.updaters import AddOption

RTOL, ATOL = 1e-6, 1e-7
Q_RTOL, Q_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _clean():
    yield
    torch_ext.reset_shared_vars()
    reset_tables()
    tcore.shutdown()


@pytest.fixture
def tmesh_dp8():
    """The port's runtime mesh: 8 CPU replicas (the reference's
    ``mesh_dp8`` shape)."""
    return tcore.init(devices=["cpu"] * 8, data_parallel=8, model_parallel=1)


class TestApi:
    def test_init_and_topology(self, tmesh_dp8):
        multiverso.init(sync=True)
        assert multiverso.workers_num() == 8
        assert multiverso.worker_id() == 0
        assert multiverso.server_id() == 0
        assert multiverso.is_master_worker()
        multiverso.barrier()

    def test_init_records_sync_and_keeps_the_mesh(self, tmesh_dp8):
        from multiverso_tpu_torch.utils import configure
        multiverso.init(sync=False)
        assert configure.get_flag("sync") is False
        assert tcore.mesh() is tmesh_dp8
        multiverso.init()
        assert configure.get_flag("sync") is True

    def test_shutdown_forgets_the_mesh(self, tmesh_dp8):
        multiverso.shutdown()
        assert not tcore.is_initialized()


class TestArrayTableHandler:
    def test_roundtrip(self, tmesh_dp8):
        tbl = multiverso.ArrayTableHandler(100)
        tbl.add(np.arange(100))
        tbl.add(np.arange(100), sync=True)
        np.testing.assert_allclose(tbl.get(), 2 * np.arange(100), rtol=1e-6)

    def test_init_value(self, tmesh_dp8):
        tbl = multiverso.ArrayTableHandler(10, init_value=1.5)
        np.testing.assert_allclose(tbl.get(), 1.5 * np.ones(10))


class TestMatrixTableHandler:
    def test_whole_matrix(self, tmesh_dp8):
        tbl = multiverso.MatrixTableHandler(6, 4)
        data = np.random.default_rng(1).standard_normal((6, 4))
        tbl.add(data, sync=True)
        np.testing.assert_allclose(tbl.get(), data, rtol=1e-6)

    def test_by_rows(self, tmesh_dp8):
        tbl = multiverso.MatrixTableHandler(10, 3)
        tbl.add(np.ones((2, 3)), row_ids=[2, 7], sync=True)
        got = tbl.get(row_ids=[2, 7, 0])
        np.testing.assert_allclose(got[0], np.ones(3))
        np.testing.assert_allclose(got[1], np.ones(3))
        np.testing.assert_allclose(got[2], np.zeros(3))


class TestMVShared:
    def test_delta_sync_merges_additively(self, tmesh_dp8):
        var = torch_ext.mv_shared(np.zeros(4))
        v = var.get_value()
        var.set_value(v + 1.0)
        var.sync()
        np.testing.assert_allclose(var.get_value(), np.ones(4))
        # the second local update ships only the difference
        var.set_value(var.get_value() + 2.0)
        var.sync()
        np.testing.assert_allclose(var.get_value(), 3 * np.ones(4))

    def test_sync_all(self, tmesh_dp8):
        a = torch_ext.mv_shared(np.zeros(2))
        b = torch_ext.mv_shared(np.ones(3))
        a.set_value(np.ones(2))
        b.set_value(2 * np.ones(3))
        torch_ext.sync_all_mv_shared_vars()
        np.testing.assert_allclose(a.get_value(), np.ones(2))
        np.testing.assert_allclose(b.get_value(), 2 * np.ones(3))

    def test_initial_value_published(self, tmesh_dp8):
        var = torch_ext.mv_shared(np.asarray([1.0, 2.0]))
        np.testing.assert_allclose(var.get_value(), [1.0, 2.0])

    def test_shape_mismatch(self, tmesh_dp8):
        var = torch_ext.mv_shared(np.zeros(4))
        with pytest.raises(ValueError, match="shape"):
            var.set_value(np.zeros(5))


class TestParamManager:
    def test_pytree_sync(self, tmesh_dp8):
        params = {"w": np.zeros((2, 3), np.float32),
                  "b": np.zeros(3, np.float32)}
        pm = torch_ext.ParamManager(params)
        params["w"] += 1.0
        params["b"] += 2.0
        merged = pm.sync_all_param(params)
        np.testing.assert_allclose(merged["w"], np.ones((2, 3)))
        np.testing.assert_allclose(merged["b"], 2 * np.ones(3))
        # a second sync with no change is a no-op
        merged2 = pm.sync_all_param(merged)
        np.testing.assert_allclose(merged2["w"], merged["w"])

    def test_structure_change_rejected(self, tmesh_dp8):
        pm = torch_ext.ParamManager({"w": np.zeros(2)})
        with pytest.raises(ValueError, match="structure"):
            pm.sync_all_param({"w": np.zeros(2), "extra": np.zeros(1)})
        with pytest.raises(ValueError, match="structure"):
            pm.sync_all_param({"w": np.zeros(3)})

    def test_tensors_lists_and_modules(self, tmesh_dp8):
        # what a torch user holds: tensors come back as tensors on their
        # device, tuples as tuples, a module gets the merged values
        # written into its parameters (named_parameters order)
        torch.manual_seed(0)
        net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
        pm = torch_ext.ParamManager(net, name="pm_module")
        with torch.no_grad():
            for p in net.parameters():
                p.add_(0.5)
        want = [p.detach().clone() for p in net.parameters()]
        assert pm.sync_all_param(net) is net
        for p, w in zip(net.parameters(), want):
            assert torch.equal(p.detach(), w)
        tree = {"a": [torch.ones(2), np.zeros(3, np.float32)],
                "b": (torch.zeros(1),)}
        pm2 = torch_ext.ParamManager(tree, name="pm_tree")
        merged = pm2.sync_all_param({"a": [torch.full((2,), 3.0),
                                           np.ones(3, np.float32)],
                                     "b": (torch.ones(1),)})
        assert isinstance(merged["a"][0], torch.Tensor)
        assert isinstance(merged["a"][1], np.ndarray)
        assert isinstance(merged["b"], tuple)
        np.testing.assert_array_equal(merged["a"][0].numpy(), [3.0, 3.0])
        np.testing.assert_array_equal(merged["a"][1], np.ones(3))
        np.testing.assert_array_equal(merged["b"][0].numpy(), [1.0])


class TestCompressedSync:
    def test_error_feedback_bounds_accumulated_error(self, tmesh_dp8):
        # pushing the same fresh delta g for T syncs accumulates ~T*g: the
        # quantization error stays O(1), carried in the residual
        rng = np.random.default_rng(0)
        g = rng.normal(0, 1, 1024).astype(np.float32)
        pm = torch_ext.ParamManager({"w": np.zeros(1024, np.float32)},
                                    name="pm_1bit", compress="1bit",
                                    compress_block=128)
        cur = pm.sync_all_param({"w": np.zeros(1024, np.float32)})
        rels = {}
        for t in range(1, 31):
            cur = pm.sync_all_param({"w": cur["w"] + g})
            got = np.asarray(cur["w"])
            rels[t] = np.abs(got - t * g).mean() / (t * np.abs(g).mean())
        assert rels[30] < 0.1, rels[30]
        assert rels[30] < rels[5] / 2, (rels[5], rels[30])
        assert np.abs(pm._residual).sum() > 0

    def test_compressed_mlp_still_learns(self, tmesh_dp8):
        from multiverso_tpu_torch.examples import mlp_cifar
        X, y = mlp_cifar.synthetic_cifar(3000, seed=4)
        pm = torch_ext.ParamManager(mlp_cifar.init_mlp((64,), seed=4),
                                    name="pm_mlp_1bit", compress="1bit")
        params, loss = mlp_cifar.train(
            X, y, hidden=(64,), epochs=4, batch_size=256, lr=0.05,
            sync_every=4, seed=4, manager=pm)
        acc = mlp_cifar.accuracy(params, X, y)
        assert np.isfinite(loss)
        # 10 classes: chance 0.1
        assert acc > 0.45, acc

    def test_unknown_compressor_rejected(self, tmesh_dp8):
        with pytest.raises(ValueError, match="compress"):
            torch_ext.ParamManager({"w": np.zeros(4)}, compress="2bit")


# -- parity with the JAX package ---------------------------------------------


@pytest.fixture(params=[(1, 1), (8, 1)], ids=["1x1", "8x1"])
def both(request, devices):
    """Both packages' runtime meshes of one shape, on CPU devices."""
    dp, mp = request.param
    jcore.init(devices=devices[:dp * mp], data_parallel=dp,
               model_parallel=mp)
    tcore.init(devices=["cpu"] * (dp * mp), data_parallel=dp,
               model_parallel=mp)
    yield request.param
    jax_ext.reset_shared_vars()
    jreset_tables()
    jcore.shutdown()


def _same(got, want, exact: bool):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("updater,opt", [
    ("default", {}), ("sgd", dict(learning_rate=0.1)),
    ("adagrad", dict(learning_rate=0.1, lam=1e-6))])
def test_array_handler_matches_reference(both, updater, opt):
    rng = np.random.default_rng(11)
    init = 0.25
    mine = multiverso.ArrayTableHandler(1000, init_value=init,
                                        updater=updater, name="a")
    ref = jmultiverso.ArrayTableHandler(1000, init_value=init,
                                        updater=updater, name="a")
    for i in range(6):
        d = rng.normal(0, 1, 1000).astype(np.float32)
        mine.add(d, sync=i % 2 == 0,
                 option=AddOption(**opt) if opt else None)
        ref.add(d, sync=i % 2 == 0,
                option=JAddOption(**opt) if opt else None)
        _same(mine.get(), ref.get(), exact=updater == "default")
    assert mine.size == ref.size == 1000


def test_matrix_handler_matches_reference(both):
    rng = np.random.default_rng(12)
    rows, cols = 37, 5
    mine = multiverso.MatrixTableHandler(rows, cols, init_value=-1.0)
    ref = jmultiverso.MatrixTableHandler(rows, cols, init_value=-1.0)
    assert (mine.num_rows, mine.num_cols) == (ref.num_rows, ref.num_cols)
    whole = rng.normal(0, 1, (rows, cols)).astype(np.float32)
    mine.add(whole, sync=True)
    ref.add(whole, sync=True)
    _same(mine.get(), ref.get(), exact=True)
    for _ in range(4):
        # unique row ids: bit for bit
        ids = rng.permutation(rows)[:11].astype(np.int32)
        d = rng.normal(0, 1, (11, cols)).astype(np.float32)
        mine.add(d, row_ids=ids, sync=True)
        ref.add(d, row_ids=ids, sync=True)
        _same(mine.get(), ref.get(), exact=True)
        q = rng.integers(0, rows, 19).astype(np.int32)
        _same(mine.get(row_ids=q), ref.get(row_ids=q), exact=True)
    for _ in range(4):
        # duplicate row ids accumulate; the sum order may differ
        ids = rng.integers(0, 6, 40).astype(np.int32)
        d = rng.normal(0, 1, (40, cols)).astype(np.float32)
        mine.add(d, row_ids=ids)
        ref.add(d, row_ids=ids, sync=True)
        _same(mine.get(), ref.get(), exact=False)
        q = rng.integers(0, rows, 19).astype(np.int32)
        _same(mine.get(row_ids=q), ref.get(row_ids=q), exact=False)


def test_mv_shared_matches_reference(both):
    rng = np.random.default_rng(13)
    v0 = rng.normal(0, 1, (3, 4)).astype(np.float32)
    mine, ref = torch_ext.mv_shared(v0), jax_ext.mv_shared(v0)
    _same(mine.get_value(), ref.get_value(), exact=True)
    for _ in range(5):
        step = rng.normal(0, 0.1, (3, 4)).astype(np.float32)
        mine.set_value(mine.get_value() + step)
        ref.set_value(ref.get_value() + step)
        mine.sync()
        ref.sync()
        _same(mine.get_value(), ref.get_value(), exact=True)
    other_m, other_r = torch_ext.mv_shared(v0[0]), jax_ext.mv_shared(v0[0])
    other_m.set_value(v0[0] * 3)
    other_r.set_value(v0[0] * 3)
    torch_ext.sync_all_mv_shared_vars()
    jax_ext.sync_all_mv_shared_vars()
    _same(other_m.get_value(), other_r.get_value(), exact=True)


def _tree(rng):
    return {"w": rng.normal(0, 1, (6, 5)).astype(np.float32),
            "b": rng.normal(0, 1, 5).astype(np.float32),
            "layers": [rng.normal(0, 1, (3, 3)).astype(np.float32),
                       rng.normal(0, 1, 7).astype(np.float32)]}


def test_param_manager_matches_reference(both):
    rng = np.random.default_rng(14)
    p0 = _tree(rng)
    mine = torch_ext.ParamManager(p0, name="pm")
    ref = jax_ext.ParamManager(p0, name="pm")
    # the flat table: the leaves in the same order
    _same(mine._table.get(), ref._table.get(), exact=True)
    cur_m, cur_r = p0, p0
    for _ in range(5):
        step = jax.tree.map(
            lambda a: rng.normal(0, 0.1, a.shape).astype(np.float32), p0)
        cur_m = mine.sync_all_param(jax.tree.map(np.add, cur_m, step))
        cur_r = ref.sync_all_param(jax.tree.map(np.add, cur_r, step))
        for a, b in zip(jax.tree.leaves(cur_m), jax.tree.leaves(cur_r)):
            _same(a, b, exact=True)


def test_one_bit_sync_matches_reference(both):
    rng = np.random.default_rng(15)
    # deltas at a gradient step's size (module doc)
    g = rng.normal(0, 0.1, 1000).astype(np.float32)
    start = {"w": np.zeros(1000, np.float32)}
    mine = torch_ext.ParamManager(start, name="q", compress="1bit",
                                  compress_block=128)
    ref = jax_ext.ParamManager(start, name="q", compress="1bit",
                               compress_block=128)
    cur_m, cur_r = start, start
    for _ in range(30):
        noise = rng.normal(0, 0.05, 1000).astype(np.float32)
        cur_m = mine.sync_all_param({"w": np.asarray(cur_m["w"]) + g + noise})
        cur_r = ref.sync_all_param({"w": np.asarray(cur_r["w"]) + g + noise})
        np.testing.assert_allclose(cur_m["w"], np.asarray(cur_r["w"]),
                                   rtol=Q_RTOL, atol=Q_ATOL)
    np.testing.assert_allclose(mine._residual, np.asarray(ref._residual),
                               rtol=Q_RTOL, atol=Q_ATOL)


# -- the row path's kernels -------------------------------------------------


def test_matrix_handler_rows_reach_the_row_kernels(monkeypatch):
    """get(row_ids) / add(data, row_ids) run the sharded row gather and
    row scatter-add, once per card a call: the kernels' CUDA branches on
    CPU shards with ``_launch`` counting in place of a card."""
    def launch(name, fn, *args, device, tag=None, **kw):
        with tk._LOCK:
            tk.LAUNCHES[name] += 1
            if tag is not None:
                tk.LAUNCHES[tag] += 1

    tcore.init(devices=["cpu"] * 4, data_parallel=1, model_parallel=4)
    tbl = multiverso.MatrixTableHandler(101, 8)
    monkeypatch.setattr(tk, "_shard_kind", lambda shards: "cuda")
    monkeypatch.setattr(tk, "_launch", launch)
    tk.reset_launches()
    rng = np.random.default_rng(3)
    for _ in range(3):
        ids = rng.integers(0, 101, 50)
        tbl.add(np.ones((50, 8)), row_ids=ids)
        tbl.get(row_ids=ids)
    got = {k: v for k, v in tk.LAUNCHES.items() if v}
    assert got == {"row_gather_sharded": 3, "row_scatter_add_sharded": 3,
                   "row_scatter_add_masked": 3}, got
