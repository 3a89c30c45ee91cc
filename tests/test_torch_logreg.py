"""The port's dense logistic regression against ``multiverso_tpu.apps.logreg``.

Both apps start from the same weights (the same seed) and train on the
same data with the same shuffles; the port runs on the CPU, the JAX
package on its virtual CPU devices. Datasets leave a partial group and a
short last minibatch, so both the S-step calls and the single steps run.

Tolerances (float32):

- Weights and each epoch's loss against the reference: rtol 1e-5, atol
  1e-6 after 3 epochs. The gradient is written out in the port and taken
  by autodiff in the reference, and the products sum in another order.
- Replicas of a data axis: bit for bit. The gradient and the loss are
  summed over the replicas before the updater runs.
- A (D, S) run against the port's one-replica run on a dataset that
  needs no padding: rtol 1e-5, atol 1e-6 (the data term sums over the
  replicas' partial products).
- ``shard_update`` against the same mesh without it: bit for bit (the
  updaters are elementwise).
"""

import numpy as np
import pytest
import torch

from multiverso_tpu import core as jcore
from multiverso_tpu.apps import logreg as jlr
from multiverso_tpu.tables import base as jbase
from multiverso_tpu_torch import core as tcore
from multiverso_tpu_torch.apps import logreg as tlr
from multiverso_tpu_torch.tables import base as tbase
from multiverso_tpu_torch.utils import configure

RTOL, ATOL = 1e-5, 1e-6
DIM, CLASSES, EPOCHS = 12, 4, 3
# 10 full minibatches of 32 (two calls of 4, then 2 single steps) and a
# short last one of 27
N, MB, SPC = 347, 32, 4


@pytest.fixture(autouse=True)
def _clean():
    yield
    jcore.shutdown()
    tcore.shutdown()
    jbase.reset_tables()
    tbase.reset_tables()
    configure.reset_flags()


def _tmesh(shape):
    dp, mp = shape
    return tcore._build_mesh(["cpu"] * (dp * mp), dp, mp)


def _jmesh(devices, shape):
    dp, mp = shape
    return jcore.init(devices=devices[:dp * mp], data_parallel=dp,
                      model_parallel=mp)


def _cfg(**kw):
    base = dict(input_dim=DIM, num_classes=CLASSES, minibatch_size=MB,
                steps_per_call=SPC, learning_rate=0.2, seed=3)
    base.update(kw)
    return base


def _data(n=N, classes=CLASSES, seed=1):
    return tlr.synthetic_blobs(n, DIM, classes, seed=seed)


def _weights(app):
    return np.concatenate([a.ravel() for a in app.weights()])


def _bits(t):
    return t.detach().cpu().contiguous().numpy().tobytes()


def _replicas_identical(table):
    ref = [_bits(x) for x in table.replicas[0]]
    for d, shards in enumerate(table.replicas):
        assert [_bits(x) for x in shards] == ref, f"replica {d}"
        for key in table.replica_states[0][0]:
            if not table.shard_update:
                assert [_bits(s[key]) for s in table.replica_states[d]] \
                    == [_bits(s[key]) for s in table.replica_states[0]]


def _train_both(devices, shape, X, y, epochs=EPOCHS, **kw):
    japp = jlr.LogisticRegression(jlr.LogRegConfig(**_cfg(**kw)),
                                  mesh=_jmesh(devices, shape))
    tapp = tlr.LogisticRegression(tlr.LogRegConfig(**_cfg(**kw)),
                                  mesh=_tmesh(shape))
    np.testing.assert_array_equal(_weights(tapp), _weights(japp))
    losses = []
    for e in range(epochs):
        losses.append((tapp.train_epoch(X, y, shuffle_seed=e),
                       japp.train_epoch(X, y, shuffle_seed=e)))
    return japp, tapp, losses


def _assert_close(tapp, japp, losses):
    np.testing.assert_allclose(_weights(tapp), _weights(japp),
                               rtol=RTOL, atol=ATOL)
    for t, j in losses:
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


# -- one replica -------------------------------------------------------------


@pytest.mark.parametrize("objective", ["softmax", "sigmoid"])
@pytest.mark.parametrize("updater", ["sgd", "adagrad", "ftrl"])
@pytest.mark.parametrize("lam", [0.0, 0.01])
def test_matches_reference(devices, objective, updater, lam):
    classes = 2 if objective == "sigmoid" else CLASSES
    X, y = _data(classes=classes)
    kw = dict(num_classes=classes, objective=objective, updater=updater,
              regular_lambda=lam)
    if updater == "ftrl":
        kw.update(ftrl_l1=0.001, ftrl_l2=0.01, ftrl_beta=1.0,
                  learning_rate=0.5)
    japp, tapp, losses = _train_both(devices, (1, 1), X, y, **kw)
    _assert_close(tapp, japp, losses)
    assert losses[-1][0] < losses[0][0]
    # the step counter: 2 S-step calls + 3 single steps an epoch
    assert tapp.table.default_option.step == 5 * EPOCHS
    assert tapp.table.default_option.step == japp.table.default_option.step


@pytest.mark.parametrize("spc", [1, 3, 16])
def test_grouping_matches_reference(devices, spc):
    """Calls of 1, 3 (a partial group left) and 16 (no full group) steps."""
    X, y = _data()
    japp, tapp, losses = _train_both(devices, (1, 1), X, y, epochs=2,
                                     steps_per_call=spc, updater="adagrad")
    _assert_close(tapp, japp, losses)


def test_train_and_predict_match_reference(devices):
    X, y = _data()
    kw = _cfg(epochs=2)
    japp = jlr.LogisticRegression(jlr.LogRegConfig(**kw),
                                  mesh=_jmesh(devices, (1, 1)))
    tapp = tlr.LogisticRegression(tlr.LogRegConfig(**kw), device="cpu")
    lj, lt = japp.train(X, y), tapp.train(X, y)
    np.testing.assert_allclose(lt, lj, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tapp.predict(X), japp.predict(X))
    assert tapp.accuracy(X, y) == japp.accuracy(X, y) > 0.9
    assert tapp.run_state() == japp.run_state() == {"epoch_done": 2}


def test_restore_run_state_resumes_at_the_cursor(devices):
    """A restored cursor of 2 runs only epoch 2 (shuffle seed seed + 2)."""
    X, y = _data()
    kw = _cfg(epochs=3)
    japp = jlr.LogisticRegression(jlr.LogRegConfig(**kw),
                                  mesh=_jmesh(devices, (1, 1)))
    tapp = tlr.LogisticRegression(tlr.LogRegConfig(**kw), device="cpu")
    for app in (japp, tapp):
        app.restore_run_state({"epoch_done": 2})
    lj, lt = japp.train(X, y), tapp.train(X, y)
    np.testing.assert_allclose(lt, lj, rtol=RTOL, atol=ATOL)
    assert tapp.table.default_option.step == 5
    assert tapp.run_state() == {"epoch_done": 3}
    # a second train() runs every epoch again
    tapp.train(X, y)
    assert tapp.table.default_option.step == 5 + 15


def test_store_load_across_packages(devices, tmp_path):
    X, y = _data()
    tapp = tlr.LogisticRegression(tlr.LogRegConfig(**_cfg()), device="cpu")
    tapp.train_epoch(X, y, shuffle_seed=0)
    tapp.store(str(tmp_path / "t.npz"))
    japp = jlr.LogisticRegression(jlr.LogRegConfig(**_cfg()),
                                  mesh=_jmesh(devices, (1, 1)))
    japp.load(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(_weights(japp), _weights(tapp))
    japp.store(str(tmp_path / "j.npz"))
    back = tlr.LogisticRegression(tlr.LogRegConfig(**_cfg(seed=9)),
                                  device="cpu", name="back")
    back.load(str(tmp_path / "j.npz"))
    np.testing.assert_array_equal(_weights(back), _weights(tapp))
    np.testing.assert_array_equal(back.predict(X), tapp.predict(X))


def test_sigmoid_needs_two_classes():
    with pytest.raises(ValueError, match="num_classes == 2"):
        tlr.LogRegConfig(input_dim=3, num_classes=3, objective="sigmoid")


# -- data axes -----------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (2, 2)])
@pytest.mark.parametrize("shard_update", [False, True])
@pytest.mark.parametrize("updater", ["sgd", "adagrad"])
def test_data_axis_matches_reference(devices, shape, shard_update, updater):
    """N leaves a short minibatch of 27, padded to a multiple of D as the
    reference pads it (its mean reweighted)."""
    X, y = _data()
    japp, tapp, losses = _train_both(devices, shape, X, y, epochs=2,
                                     updater=updater,
                                     shard_update=shard_update)
    assert tapp.table.n_replicas == shape[0]
    assert tapp.table.shard_update == shard_update
    _replicas_identical(tapp.table)
    _assert_close(tapp, japp, losses)


@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (2, 2)])
@pytest.mark.parametrize("updater", ["sgd", "adagrad", "ftrl"])
def test_data_axis_equals_one_replica(shape, updater):
    """No padding (N and every minibatch divide by 4): a (D, S) run equals
    the one-replica run within tolerance, and shard_update equals the
    same mesh without it bit for bit."""
    X, y = _data(n=32 * 11 + 8)
    kw = _cfg(updater=updater, regular_lambda=0.01)
    one = tlr.LogisticRegression(tlr.LogRegConfig(**kw), device="cpu",
                                 name="one")
    runs = [tlr.LogisticRegression(
        tlr.LogRegConfig(**kw, shard_update=su), mesh=_tmesh(shape),
        name=f"mesh{int(su)}") for su in (False, True)]
    for e in range(2):
        l1 = one.train_epoch(X, y, shuffle_seed=e)
        lm = [app.train_epoch(X, y, shuffle_seed=e) for app in runs]
        np.testing.assert_allclose(lm[0], l1, rtol=RTOL, atol=ATOL)
        assert lm[0] == lm[1]
    for app in runs:
        _replicas_identical(app.table)
        np.testing.assert_allclose(_weights(app), _weights(one), rtol=RTOL,
                                   atol=ATOL)
    assert _weights(runs[0]).tobytes() == _weights(runs[1]).tobytes()
    for key in runs[0].table.shard_states[0]:
        np.testing.assert_array_equal(
            runs[1].table._state_leaf(key).numpy(),
            runs[0].table._state_leaf(key).numpy())


def test_replica_helpers_off_a_data_axis():
    from multiverso_tpu_torch.tables.superstep import (replica_cat,
                                                       replica_index)
    x = torch.arange(3.0)
    assert replica_cat(x) is x and replica_index() == 0


# -- libsvm ----------------------------------------------------------------------


@pytest.mark.parametrize("text,dim", [
    ("1 0:1.5 3:2.0\n-1 1:0.5\n1 2:1.0\n", 4),     # 0-based
    ("1 1:1.5 4:2.0\n-1 2:0.5\n", 4),              # 1-based (index == dim)
    ("0 1:1\n2 2:1\n1 3:1\n\n", 5),                 # ambiguous: 1-based
    ("3 0:1\n1 2:0.25\n", 3),                       # multiclass, 0-based
])
def test_read_libsvm_matches_reference(tmp_path, text, dim):
    p = tmp_path / "d.libsvm"
    p.write_text(text)
    for one_based in (None, False, True):
        try:
            want = jlr.read_libsvm(str(p), dim, one_based=one_based)
        except ValueError as e:
            with pytest.raises(ValueError, match="out of range"):
                tlr.read_libsvm(str(p), dim, one_based=one_based)
            assert "out of range" in str(e)
            continue
        got = tlr.read_libsvm(str(p), dim, one_based=one_based)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert tlr.detect_libsvm_base([str(p)], dim) == \
        jlr.detect_libsvm_base([str(p)], dim)


def test_libsvm_both_markers_raise(tmp_path):
    a, b = tmp_path / "a.libsvm", tmp_path / "b.libsvm"
    a.write_text("1 0:1\n")
    b.write_text("1 4:1\n")
    p = tmp_path / "both.libsvm"
    p.write_text("1 0:1 4:1\n")
    for mod in (tlr, jlr):
        with pytest.raises(ValueError, match="cannot autodetect"):
            mod.read_libsvm(str(p), 4)
        with pytest.raises(ValueError, match="cannot autodetect"):
            mod.detect_libsvm_base([str(a), str(b)], 4)
    assert tlr.detect_libsvm_base([str(a)], 4) is False
    assert tlr.detect_libsvm_base([str(b)], 4) is True


def test_synthetic_blobs_match_reference():
    for a, b in zip(tlr.synthetic_blobs(50, 7, 3, seed=4),
                    jlr.synthetic_blobs(50, 7, 3, seed=4)):
        np.testing.assert_array_equal(a, b)


# -- the CLI -------------------------------------------------------------------


def _write_libsvm(path, X, y):
    with open(path, "w") as f:
        for row, label in zip(X, y):
            f.write(f"{label} " + " ".join(
                f"{j + 1}:{v:.6g}" for j, v in enumerate(row) if v) + "\n")


@pytest.mark.parametrize("dp", [1, 2])
def test_main_on_a_libsvm_file(devices, tmp_path, capsys, dp):
    X, y = _data(n=200)
    train = tmp_path / "train.libsvm"
    _write_libsvm(train, X, y)
    out = tmp_path / "model.npz"
    tlr.main([f"-train_file={train}", f"-test_file={train}",
              f"-input_dimension={DIM}", f"-output_dimension={CLASSES}",
              "-minibatch_size=32", "-train_epoch=2", "-learning_rate=0.2",
              "-device=cpu", f"-data_parallel={dp}",
              f"-output_model_file={out}"])
    # the same run through the reference's app on a mesh of that shape
    Xr, yr = jlr.read_libsvm(str(train), DIM)
    japp = jlr.LogisticRegression(jlr.LogRegConfig(
        input_dim=DIM, num_classes=CLASSES, minibatch_size=32, epochs=2,
        learning_rate=0.2), mesh=_jmesh(devices, (dp, 1)))
    japp.train(Xr, yr)
    back = tlr.LogisticRegression(tlr.LogRegConfig(DIM, CLASSES),
                                  device="cpu", name="back")
    back.load(str(out))
    np.testing.assert_allclose(_weights(back), _weights(japp), rtol=RTOL,
                               atol=ATOL)


def test_main_help(capsys):
    tlr.main(["-help"])
    text = capsys.readouterr().out
    assert "Not ported" in text and "-run_dir" in text


def test_main_rejects_unknown_flags():
    with pytest.raises(SystemExit, match="unknown arguments"):
        tlr.main(["-device=cpu", "stray"])
