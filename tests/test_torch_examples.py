"""The port's examples (``multiverso_tpu_torch/examples``) against the
JAX package's (``examples/``), on CPU meshes.

The learning tests of ``tests/test_examples.py`` at its sizes and bars on
the port's CPU (8, 1) mesh, then parity from the same weights (the
reference's, carried across by ``multiverso_tpu_torch.convert``) and the
same batches, made from a seed with numpy:

- the data and initial weights: bit for bit (the same numpy draws; the
  ResNet's conv weights HWIO -> OIHW);
- one MLP ``train_step``: the parameters and the loss within rtol 1e-5,
  atol 1e-6;
- ResNet tiny's logits and one momentum step (parameters, velocity,
  loss) on (1, 1) and (8, 1) meshes: rtol 1e-4, atol 1e-5 (convolutions
  and GroupNorm reduce in another order than XLA's);
- one ``pipeline_mlp`` step on an 8-stage mesh against the reference's
  ``pipeline_apply`` in one jitted step (not its ``PipelineMLPTrainer``):
  rtol 1e-4, atol 1e-5.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from examples import mlp_cifar as jmlp
from examples import pipeline_mlp as jpipe_mlp
from examples import resnet_imagenet as jresnet
from multiverso_tpu import core as jcore
from multiverso_tpu.bindings import jax_ext
from multiverso_tpu.parallel.pipeline import pipeline_apply as jpipeline
from multiverso_tpu.tables import reset_tables as jreset_tables
from multiverso_tpu_torch import convert
from multiverso_tpu_torch import core as tcore
from multiverso_tpu_torch.bindings import torch_ext
from multiverso_tpu_torch.examples import mlp_cifar, pipeline_mlp
from multiverso_tpu_torch.examples import resnet_imagenet
from multiverso_tpu_torch.tables import reset_tables

MLP_RTOL, MLP_ATOL = 1e-5, 1e-6
NET_RTOL, NET_ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _clean():
    yield
    torch_ext.reset_shared_vars()
    reset_tables()
    tcore.shutdown()


@pytest.fixture
def tmesh_dp8():
    return tcore.init(devices=["cpu"] * 8, data_parallel=8, model_parallel=1)


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


# -- the learning tests of tests/test_examples.py ----------------------------


def test_mlp_compat_learns(tmesh_dp8):
    X, y = mlp_cifar.synthetic_cifar(4096, seed=1)
    params, loss = mlp_cifar.train(X, y, hidden=(64,), epochs=5,
                                   batch_size=256, lr=0.1, seed=1)
    assert np.isfinite(loss)
    assert mlp_cifar.accuracy(params, X, y) > 0.8


def test_mlp_sync_merges_deltas(tmesh_dp8):
    """Two workers syncing through one manager merge additively."""
    pm = torch_ext.ParamManager({"w": torch.zeros(4)}, name="merge_test")
    merged_a = pm.sync_all_param({"w": torch.tensor([1.0, 0.0, 0.0, 0.0])})
    np.testing.assert_allclose(merged_a["w"].numpy(), [1, 0, 0, 0],
                               atol=1e-6)
    b = {"w": merged_a["w"] + torch.tensor([0.0, 2.0, 0.0, 0.0])}
    merged_b = pm.sync_all_param(b)
    np.testing.assert_allclose(merged_b["w"].numpy(), [1, 2, 0, 0],
                               atol=1e-6)


def test_resnet_tiny_learns(tmesh_dp8):
    X, y = resnet_imagenet.synthetic_imagenet(2048, size=16, seed=2)
    trainer = resnet_imagenet.ResNetTrainer(
        "tiny", learning_rate=0.05, mesh=tmesh_dp8, seed=2)
    losses = trainer.fit(X, y, steps=70, batch_size=256, seed=2)
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert trainer.accuracy(X, y) > 0.5      # 10 classes: chance 0.1


def test_resnet_through_binding_learns(tmesh_dp8):
    # BASELINE config #5 through the compat surface: a local momentum
    # step + a ParamManager delta sync every 2 minibatches
    X, y = resnet_imagenet.synthetic_imagenet(2048, size=16, seed=3)
    trainer = resnet_imagenet.BindingResNetTrainer(
        "tiny", learning_rate=0.05, sync_every=2, mesh=tmesh_dp8, seed=3)
    losses = trainer.fit(X, y, steps=60, batch_size=256, seed=3)
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert trainer.accuracy(X, y) > 0.5
    # the sync really went through the handler's table
    assert trainer.pm._table._table.generation >= 60 // 2
    # and every replica holds the merged values
    for rep in trainer.replicas[1:]:
        for k, v in rep.items():
            assert torch.equal(v, trainer.params[k])


def test_resnet_archs_build():
    p18 = resnet_imagenet.init_resnet("resnet18")
    p50 = resnet_imagenet.init_resnet("resnet50")
    assert p18["head_w"].shape == (512, 10)
    assert p50["head_w"].shape == (2048, 10)
    assert len(p50) == 153
    assert sum(v.size for v in p50.values()) == 23_513_162


def test_pipeline_mlp_learns(tmesh_dp8):
    """Training through the GPipe schedule: the loss must drop."""
    x, y = pipeline_mlp.synthetic_regression(1024, 16, seed=1)
    trainer = pipeline_mlp.PipelineMLPTrainer(
        width=16, in_dim=16, learning_rate=0.02, mesh=tmesh_dp8,
        axis="data", seed=1)
    assert trainer.stages == 8
    losses = trainer.fit(x, y, steps=30, batch_size=128, seed=1)
    assert np.all(np.isfinite(losses))
    assert losses[-5:].mean() < 0.6 * losses[:5].mean()


def test_batch_must_divide_over_the_data_axis(tmesh_dp8):
    trainer = resnet_imagenet.ResNetTrainer("tiny", mesh=tmesh_dp8)
    X, y = resnet_imagenet.synthetic_imagenet(12, size=8)
    with pytest.raises(ValueError, match="divide"):
        trainer.train_step(X, y)


# -- parity with the JAX package ---------------------------------------------


def test_mlp_train_step_matches_reference(mesh_dp8):
    X, y = jmlp.synthetic_cifar(512, seed=5)
    X2, y2 = mlp_cifar.synthetic_cifar(512, seed=5)
    np.testing.assert_array_equal(X, X2)
    np.testing.assert_array_equal(y, y2)
    ref = jmlp.init_mlp((32, 16), seed=5)
    mine = mlp_cifar.init_mlp((32, 16), seed=5, device="cpu")
    for k in ref:
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(ref[k]))
    # the carry function installs the reference's arrays
    carried = convert.load_mlp(
        {k: torch.zeros_like(v) for k, v in mine.items()},
        jax.tree.map(np.asarray, ref))
    for k in ref:
        assert torch.equal(carried[k], mine[k])
    idx = np.arange(64)
    got, loss = mlp_cifar.train_step(carried, torch.tensor(X[idx]),
                                     torch.tensor(y[idx]), 0.05)
    want, jloss = jmlp.train_step(ref, jcore.place(X[idx]),
                                  jcore.place(y[idx]), 0.05)
    for k in want:
        _close(got[k].numpy(), want[k], MLP_RTOL, MLP_ATOL, k)
    _close(loss.numpy(), jloss, MLP_RTOL, MLP_ATOL, "loss")


def test_carry_functions_reject_unknown_weights():
    mine = mlp_cifar.init_mlp((8,), seed=0, device="cpu")
    ref = {k: v.numpy() for k, v in mine.items()}
    with pytest.raises(ValueError, match="keys"):
        convert.load_mlp(mine, {**ref, "w9": ref["w0"]})
    with pytest.raises(ValueError, match="shape"):
        convert.load_mlp(mine, {**ref, "w0": ref["w0"].T})
    tm = tcore.Mesh([["cpu"]])
    trainer = resnet_imagenet.ResNetTrainer("tiny", mesh=tm)
    host = jresnet.init_resnet("tiny")
    with pytest.raises(ValueError, match="keys"):
        convert.load_resnet(trainer, {k: v for k, v in host.items()
                                      if k != "head_b"})
    with pytest.raises(ValueError, match="shape"):
        convert.load_resnet(trainer, {**host, "stem": host["stem"][:, :, :2]})
    pipe = pipeline_mlp.PipelineMLPTrainer(width=4, in_dim=3, mesh=tm)
    with pytest.raises(ValueError, match="keys"):
        convert.load_pipeline_mlp(pipe, {"embed": np.zeros((3, 4)),
                                         "trunk": {"w": np.zeros((1, 4, 4))},
                                         "head": np.zeros((4, 1))})


@pytest.fixture(params=[1, 8], ids=["1x1", "8x1"])
def resnet_meshes(request, devices):
    d = request.param
    jm = jcore.init(devices=devices[:d], data_parallel=d, model_parallel=1)
    yield jm, tcore.Mesh([["cpu"]] * d)
    jax_ext.reset_shared_vars()
    jreset_tables()
    jcore.shutdown()


def test_resnet_tiny_matches_reference(resnet_meshes):
    jm, tm = resnet_meshes
    host = jresnet.init_resnet("tiny", seed=7)
    mine = resnet_imagenet.init_resnet("tiny", seed=7)
    assert list(mine) == list(host)
    for k in host:
        np.testing.assert_array_equal(mine[k], convert.hwio_to_oihw(host[k]))
    X, y = jresnet.synthetic_imagenet(32, size=16, seed=8)
    ref = jresnet.ResNetTrainer("tiny", learning_rate=0.05, mesh=jm, seed=7)
    trainer = resnet_imagenet.ResNetTrainer("tiny", learning_rate=0.05,
                                            mesh=tm, seed=0)
    convert.load_resnet(trainer, host)
    logits = resnet_imagenet.forward(trainer.params, torch.tensor(X), "tiny")
    want = jresnet.forward(jax.tree.map(jnp.asarray, host), jnp.asarray(X),
                           "tiny")
    _close(logits.detach().numpy(), want, NET_RTOL, NET_ATOL, "logits")
    loss = trainer.train_step(X, y)
    jloss = ref.train_step(X, y)
    _close(loss.numpy(), jloss, NET_RTOL, NET_ATOL, "loss")
    for k in host:
        _close(trainer.params[k].numpy(),
               convert.hwio_to_oihw(np.asarray(ref.params[k])),
               NET_RTOL, NET_ATOL, k)
        _close(trainer.velocity[0][k].numpy(),
               convert.hwio_to_oihw(np.asarray(ref.velocity[k])),
               NET_RTOL, NET_ATOL, f"velocity {k}")
    for rep in trainer.replicas[1:]:
        for k, v in rep.items():
            assert torch.equal(v, trainer.params[k])


def test_pipeline_mlp_step_matches_reference(mesh_dp8):
    tm = tcore.Mesh([["cpu"]] * 8)
    x, y = jpipe_mlp.synthetic_regression(256, 16, seed=2)
    host = jax.tree.map(np.asarray, jpipe_mlp.init_params(8, 16, 16, seed=3))
    trainer = pipeline_mlp.PipelineMLPTrainer(
        width=16, in_dim=16, learning_rate=0.02, mesh=tm, axis="data",
        seed=3)
    for a, b in zip(jax.tree.leaves(host),
                    jax.tree.leaves(jax.tree.map(
                        lambda t: t.numpy(), trainer.params))):
        np.testing.assert_array_equal(a, b)
    convert.load_pipeline_mlp(trainer, host)
    xb, yb = x[:64], y[:64]

    @jax.jit
    def step(params, x, y):
        def loss_fn(p):
            h = x @ p["embed"]
            h = jpipeline(p["trunk"], h, jpipe_mlp._block, mesh=mesh_dp8,
                          axis="data")
            return jnp.mean(((h @ p["head"])[:, 0] - y) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        return jax.tree.map(lambda p, g: p - 0.02 * g, params, grads), loss

    want, jloss = step(jax.tree.map(jnp.asarray, host), jnp.asarray(xb),
                       jnp.asarray(yb))
    loss = trainer.step(torch.tensor(xb), torch.tensor(yb))
    _close(loss.numpy(), jloss, NET_RTOL, NET_ATOL, "loss")
    got = jax.tree.map(lambda t: t.numpy(), trainer.params)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        _close(g, w, NET_RTOL, NET_ATOL)
