"""Pipeline-parallel MLP training (counterpart of
``examples/pipeline_mlp.py``).

The trunk is S residual tanh blocks, one per device of the chosen mesh
axis, run by :func:`multiverso_tpu_torch.parallel.pipeline.pipeline_apply`
(the GPipe microbatch schedule). A training step is the pipelined forward,
autograd's backward through the schedule, and SGD on the stage-stacked
parameters. The embedding (input projection) and the head live outside the
trunk, as in any homogeneous pipeline.

Run: python -m multiverso_tpu_torch.examples.pipeline_mlp -model_parallel=8
     (the stages are the model axis; -device=cpu on the CPU)
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from multiverso_tpu_torch import core
from multiverso_tpu_torch.parallel.pipeline import pipeline_apply
from multiverso_tpu_torch.utils import configure
from multiverso_tpu_torch.utils.tree import flatten, tree_map


def synthetic_regression(n: int, d: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d,)).astype(np.float32)
    y = np.tanh(x @ w) + 0.05 * rng.normal(size=n).astype(np.float32)
    return x, y.astype(np.float32)


def init_params(stages: int, width: int, in_dim: int, seed: int = 0,
                device: core.DeviceLike = None):
    """Glorot-uniform embedding, stacked trunk and head on ``device``
    (default: the runtime's), drawn as the reference draws them."""
    rng = np.random.default_rng(seed)
    device = core.resolve(device)

    def glorot(*shape):
        lim = np.sqrt(6.0 / (shape[-2] + shape[-1]))
        return torch.tensor(rng.uniform(-lim, lim, shape).astype(np.float32),
                            device=device)

    return {
        "embed": glorot(in_dim, width),
        "trunk": {"w": glorot(stages, width, width),
                  "b": torch.zeros((stages, width), device=device)},
        "head": glorot(width, 1),
    }


def _block(p, h):
    # damped residual branch: S stacked blocks stay stable at depth
    return h + 0.2 * torch.tanh(h @ p["w"] + p["b"])


class PipelineMLPTrainer:
    def __init__(self, width: int = 32, in_dim: int = 16,
                 learning_rate: float = 0.02,
                 mesh: Optional[core.Mesh] = None, axis: Optional[str] = None,
                 microbatches: Optional[int] = None, seed: int = 0):
        self.mesh = mesh if mesh is not None else core.mesh()
        self.axis = axis if axis is not None else core.MODEL_AXIS
        self.stages = self.mesh.shape[self.axis]
        self.device = self.mesh.axis_devices(self.axis)[0]
        self.params = init_params(self.stages, width, in_dim, seed,
                                  self.device)
        self.lr = learning_rate
        self.microbatches = microbatches

    def loss(self, params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        h = x @ params["embed"]
        h = pipeline_apply(params["trunk"], h, _block, mesh=self.mesh,
                           axis=self.axis, microbatches=self.microbatches)
        pred = (h @ params["head"])[:, 0]
        return torch.mean((pred - y) ** 2)

    def step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """One SGD step; returns the loss before it."""
        params = tree_map(lambda p: p.detach().requires_grad_(True),
                          self.params)
        leaves, rebuild = flatten(params)
        loss = self.loss(params, x, y)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            self.params = rebuild([p - self.lr * g
                                   for p, g in zip(leaves, grads)])
        return loss.detach()

    def fit(self, x: np.ndarray, y: np.ndarray, steps: int,
            batch_size: int, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        losses = []
        for _ in range(steps):
            idx = rng.integers(0, len(x), batch_size)
            losses.append(self.step(
                torch.as_tensor(x[idx], device=self.device),
                torch.as_tensor(y[idx], device=self.device)))
        return torch.stack(losses).cpu().numpy()


def main(argv=None) -> np.ndarray:
    """The CLI; returns the losses."""
    configure.define_string("device", "", "one torch device for every "
                            "stage (default: the CUDA devices as a mesh of "
                            "-data_parallel x -model_parallel)",
                            overwrite=True)
    rest = configure.parse_flags(list(argv or []))
    if rest:
        raise SystemExit(f"unknown arguments {rest}")
    dp = configure.get_flag("data_parallel")
    mp = configure.get_flag("model_parallel")
    dev = configure.get_flag("device")
    core.init(devices=[dev] * (max(dp, 1) * mp) if dev else None,
              data_parallel=dp, model_parallel=mp)
    x, y = synthetic_regression(4096, 16, seed=1)
    trainer = PipelineMLPTrainer(width=32, in_dim=16, seed=1)
    losses = trainer.fit(x, y, steps=60, batch_size=256, seed=1)
    print(f"pipeline mlp ({trainer.stages} stages): "
          f"loss {losses[:5].mean():.4f} -> {losses[-5:].mean():.4f}")
    return losses


if __name__ == "__main__":
    main(sys.argv[1:])
