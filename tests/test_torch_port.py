"""multiverso_tpu_torch as a package: it imports neither JAX nor the JAX
package, its runtime picks the card unless told otherwise, and its fused
superstep keeps the table contract of ``multiverso_tpu.tables.superstep``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch import convert, core
from multiverso_tpu_torch.tables import MatrixTable, make_superstep
from multiverso_tpu_torch.tables import superstep as ss
from multiverso_tpu_torch.utils import configure

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import multiverso_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "multiverso_tpu"))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_import_hygiene():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    count = int(out.stdout.split()[0])
    assert count >= 20, out.stdout      # every module of the package


def test_init_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    core.shutdown()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mvt.init()
    assert not mvt.is_initialized()


def test_init_on_cpu_and_topology():
    try:
        dev = mvt.init(device="cpu")
        assert dev == torch.device("cpu") and mvt.device() == dev
        assert (mvt.rank(), mvt.size(), mvt.num_workers(),
                mvt.num_servers()) == (0, 1, 1, 1)
        mvt.barrier()
        t = mvt.place(np.arange(3, dtype=np.int32))
        assert t.device == dev and t.dtype == torch.int32
        g1, g2 = mvt.generator(5), mvt.generator(5)
        assert torch.equal(torch.rand(4, generator=g1),
                           torch.rand(4, generator=g2))
    finally:
        core.shutdown()


def test_init_parses_flags():
    try:
        rest = configure.parse_flags(["-updater_type=adagrad", "-x=1"])
        assert rest == ["-x=1"]
        mvt.init(device="cpu")
        t = MatrixTable(4, 2, name="flagged")
        assert t.updater.name == "adagrad"
    finally:
        configure.reset_flags()
        core.shutdown()


def test_superstep_contract():
    a = MatrixTable(6, 3, device="cpu", name="ss_a")
    b = MatrixTable(6, 3, device="cpu", name="ss_b")

    def body(params, states, locals_, options, ids, deltas):
        pa, pb = params
        rows = ss.gather_rows(pa, ids)
        pb = ss.row_scatter_add(pb, ids, rows + deltas)
        (count,) = locals_
        return (pa, pb), states, (count + 1,), rows.sum()

    step = make_superstep((a, b), body, name="t")
    with pytest.raises(RuntimeError, match="not been dispatched"):
        step.handle()
    a.add_rows([1, 2], np.ones((2, 3), np.float32))
    ids = torch.tensor([1, 1, 2], dtype=torch.int32)
    locals_, aux = step((0,), ids, torch.ones(3, 3))
    assert locals_ == (1,) and float(aux) == 9.0
    np.testing.assert_array_equal(b.get_rows([0, 1, 2]),
                                  [[0, 0, 0], [4, 4, 4], [2, 2, 2]])
    assert (a.generation, b.generation) == (2, 1)
    assert step.handle().generation == 2
    assert a.default_option.step == 2 and b.default_option.step == 1


def test_superstep_rejects_mixed_devices():
    a = MatrixTable(4, 2, device="cpu", name="dev_a")
    b = MatrixTable(4, 2, device="meta", name="dev_b")
    with pytest.raises(ValueError, match="different devices"):
        make_superstep((a, b), lambda *x: x)


def test_convert_rejects_unknown_weights():
    with pytest.raises(ValueError, match="unknown word2vec weights"):
        convert.load_word_embedding(object(), {"w_mid": np.zeros(1)})
