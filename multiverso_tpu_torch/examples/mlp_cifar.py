"""A data-parallel MLP through the binding-compat API: the analog of the
reference's ``binding/python/examples/theano/`` MLP on CIFAR-10
(counterpart of ``examples/mlp_cifar.py``).

A local train step updates local parameters, then
``ParamManager.sync_all_param`` ships the delta since the last sync
through the ArrayTable and gets the merged values back: workers never
overwrite each other, concurrent updates merge additively. The local step
is plain torch autograd; the sync path is the reference's.

Run: python -m multiverso_tpu_torch.examples.mlp_cifar -epochs=3
     (-device=cpu on the CPU)
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch import core
from multiverso_tpu_torch.bindings.torch_ext import ParamManager
from multiverso_tpu_torch.utils import configure, log

INPUT_DIM = 32 * 32 * 3
NUM_CLASSES = 10

Params = Dict[str, torch.Tensor]


def synthetic_cifar(n: int, seed: int = 0,
                    signal: float = 2.0) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR-shaped data with a planted linear class signal (the
    reference's draws)."""
    rng = np.random.default_rng(seed)
    directions = rng.normal(0, 1, (NUM_CLASSES, INPUT_DIM))
    directions /= np.linalg.norm(directions, axis=1, keepdims=True)
    y = rng.integers(0, NUM_CLASSES, n).astype(np.int32)
    X = rng.normal(0, 1, (n, INPUT_DIM)) + signal * directions[y]
    return X.astype(np.float32), y


def init_mlp(hidden: Tuple[int, ...] = (256, 128), seed: int = 0,
             device: core.DeviceLike = None) -> Params:
    """``{"w0", "b0", ...}`` on ``device`` (default: the runtime's), drawn
    as the reference draws them."""
    rng = np.random.default_rng(seed)
    sizes = (INPUT_DIM,) + tuple(hidden) + (NUM_CLASSES,)
    params = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        params[f"w{i}"] = core.place(
            rng.normal(0, np.sqrt(2.0 / a), (a, b)).astype(np.float32),
            device=device)
        params[f"b{i}"] = core.place(np.zeros((b,), np.float32),
                                     device=device)
    return params


def forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    n_layers = len(params) // 2
    h = x
    for i in range(n_layers):
        h = h @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            h = torch.relu(h)
    return h


def train_step(params: Params, x: torch.Tensor, y: torch.Tensor,
               lr: float) -> Tuple[Params, torch.Tensor]:
    """One SGD step on the mean cross-entropy; returns the new parameters
    and the loss (a 0-d tensor)."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    logp = torch.log_softmax(forward(leaves, x), dim=1)
    loss = -logp.gather(1, y.long()[:, None]).mean()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    with torch.no_grad():
        new = {k: p - lr * g for (k, p), g in zip(leaves.items(), grads)}
    return new, loss.detach()


@torch.no_grad()
def predict(params: Params, x: torch.Tensor) -> torch.Tensor:
    return forward(params, x).argmax(dim=1)


def accuracy(params: Params, X: np.ndarray, y: np.ndarray) -> float:
    dev = next(iter(params.values())).device
    pred = predict(params, torch.as_tensor(np.asarray(X), device=dev))
    return float(np.mean(pred.cpu().numpy() == y))


def train(X: np.ndarray, y: np.ndarray, *, hidden=(256, 128),
          epochs: int = 3, batch_size: int = 128, lr: float = 0.05,
          sync_every: int = 1, seed: int = 0,
          manager: Optional[ParamManager] = None) -> Tuple[Params, float]:
    """The reference example's loop: a local step, then the table's delta
    sync every ``sync_every`` steps and at each epoch's end."""
    params = init_mlp(hidden, seed)
    dev = next(iter(params.values())).device
    pm = manager if manager is not None \
        else ParamManager(params, name="mlp_cifar")
    n = len(X)
    loss = float("nan")
    for epoch in range(epochs):
        order = np.random.default_rng(seed + epoch).permutation(n)
        for it, start in enumerate(range(0, n - batch_size + 1,
                                         batch_size)):
            idx = order[start:start + batch_size]
            params, loss = train_step(
                params, torch.as_tensor(X[idx], device=dev),
                torch.as_tensor(y[idx], device=dev), lr)
            if (it + 1) % sync_every == 0:
                params = pm.sync_all_param(params)
        params = pm.sync_all_param(params)
        log.info("mlp epoch %d: loss=%.4f acc=%.4f", epoch, float(loss),
                 accuracy(params, X, y))
    return params, float(loss)


def main(argv=None) -> float:
    """The CLI; returns the final accuracy."""
    configure.define_int("epochs", 3, "training epochs", overwrite=True)
    configure.define_int("batch_size", 128, "minibatch size", overwrite=True)
    configure.define_float("lr", 0.05, "learning rate", overwrite=True)
    configure.define_int("n_samples", 20000, "synthetic sample count",
                         overwrite=True)
    configure.define_string("device", "", "one torch device (default: the "
                            "first CUDA device)", overwrite=True)
    rest = configure.parse_flags(list(argv or []))
    if rest:
        raise SystemExit(f"unknown arguments {rest}")
    dev = configure.get_flag("device")
    core.init(device=dev or None)
    X, y = synthetic_cifar(configure.get_flag("n_samples"))
    params, _ = train(X, y, epochs=configure.get_flag("epochs"),
                      batch_size=configure.get_flag("batch_size"),
                      lr=configure.get_flag("lr"))
    acc = accuracy(params, X, y)
    log.info("final accuracy: %.4f", acc)
    core.barrier()
    return acc


if __name__ == "__main__":
    main(sys.argv[1:])
