"""A data-parallel ResNet trainer: the analog of the reference's
multiverso-torch ResNet-50 / ImageNet configuration (counterpart of
``examples/resnet_imagenet.py``).

The model is a from-scratch ResNet (conv / GroupNorm / relu residual
stages, v1.5-style strides) written as plain functions on a parameter
dict with the reference's names. Images come in the reference's NHWC
layout; inside, activations are NCHW and conv weights OIHW
(``convert.load_resnet`` carries the reference's HWIO weights across).
``"tiny"`` trains in tests; ``"resnet50"`` is the reference-parity
configuration.

:class:`ResNetTrainer` is synchronous data parallelism over the mesh's
data axis: replica ``d`` (on the first device of data row ``d``) holds the
parameters, takes its ``B / D`` lanes of each batch and computes its part
of the global-mean loss; the gradients are summed in replica order, and
every replica applies the same momentum step, so the replicas stay equal
bit for bit. :class:`BindingResNetTrainer` runs the same step and syncs
through the binding's ``ParamManager`` every ``sync_every`` steps.

Run: python -m multiverso_tpu_torch.examples.resnet_imagenet -arch=tiny
     -steps=20   (-device=cpu on the CPU)
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multiverso_tpu_torch import core
from multiverso_tpu_torch.utils import configure, dashboard, log

ARCHS = {
    # (stage block counts, stage widths, bottleneck?)
    "tiny": ((1, 1), (16, 32), False),
    "resnet18": ((2, 2, 2, 2), (64, 128, 256, 512), False),
    "resnet50": ((3, 4, 6, 3), (256, 512, 1024, 2048), True),
}

Params = Dict[str, torch.Tensor]


def synthetic_imagenet(n: int, size: int = 32, num_classes: int = 10,
                       seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Image-shaped NHWC data with a planted per-class bias (the
    reference's draws)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, n).astype(np.int32)
    patterns = rng.normal(0, 1, (num_classes, size, size, 3))
    X = rng.normal(0, 1, (n, size, size, 3)) + 1.5 * patterns[y]
    return X.astype(np.float32), y


# -- model ----------------------------------------------------------------

def _conv_init(rng, kh, kw, cin, cout):
    """He-normal, drawn in the reference's HWIO order, returned OIHW."""
    fan_in = kh * kw * cin
    w = rng.normal(0, np.sqrt(2.0 / fan_in), (kh, kw, cin, cout))
    return np.ascontiguousarray(w.astype(np.float32).transpose(3, 2, 0, 1))


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NCHW x OIHW with XLA's ``"SAME"`` padding: the output is
    ``ceil(size / stride)`` wide and the padding ``(k - 1) - (size - 1) %
    stride``, its odd pixel after (a 3x3 stride-2 conv on an even input
    pads 0 before and 1 after)."""
    pads = []
    for size, k in ((x.shape[2], w.shape[2]), (x.shape[3], w.shape[3])):
        total = max((-(-size // stride) - 1) * stride + k - size, 0)
        pads.append((total // 2, total - total // 2))
    if all(lo == hi for lo, hi in pads):
        return F.conv2d(x, w, stride=stride,
                        padding=(pads[0][0], pads[1][0]))
    (t, b), (l, r) = pads
    return F.conv2d(F.pad(x, (l, r, t, b)), w, stride=stride)


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta_: torch.Tensor,
               groups: int = 8) -> torch.Tensor:
    """GroupNorm over ``min(groups, C)`` contiguous channel groups, the
    population variance, eps 1e-5 (the reference's)."""
    return F.group_norm(x, min(groups, x.shape[1]), gamma, beta_, eps=1e-5)


def init_resnet(arch: str = "tiny", num_classes: int = 10,
                seed: int = 0) -> Dict[str, np.ndarray]:
    """The parameters as host arrays in the port's layout (conv weights
    OIHW), drawn as the reference draws them."""
    blocks, widths, bottleneck = ARCHS[arch]
    rng = np.random.default_rng(seed)
    cin = widths[0] // 4 if bottleneck else widths[0]
    params: Dict[str, np.ndarray] = {"stem": _conv_init(rng, 3, 3, 3, cin)}
    params["stem_g"] = np.ones((cin,), np.float32)
    params["stem_b"] = np.zeros((cin,), np.float32)
    for s, (nb, width) in enumerate(zip(blocks, widths)):
        for b in range(nb):
            pre = f"s{s}b{b}"
            stride = 2 if (s > 0 and b == 0) else 1
            mid = width // 4 if bottleneck else width
            if bottleneck:
                params[f"{pre}_c1"] = _conv_init(rng, 1, 1, cin, mid)
                params[f"{pre}_c2"] = _conv_init(rng, 3, 3, mid, mid)
                params[f"{pre}_c3"] = _conv_init(rng, 1, 1, mid, width)
            else:
                params[f"{pre}_c1"] = _conv_init(rng, 3, 3, cin, width)
                params[f"{pre}_c2"] = _conv_init(rng, 3, 3, width, width)
            for i, ch in enumerate(
                    (mid, mid, width) if bottleneck else (width, width)):
                params[f"{pre}_g{i}"] = np.ones((ch,), np.float32)
                params[f"{pre}_b{i}"] = np.zeros((ch,), np.float32)
            if stride != 1 or cin != width:
                params[f"{pre}_proj"] = _conv_init(rng, 1, 1, cin, width)
            cin = width
    params["head_w"] = rng.normal(
        0, 0.01, (cin, num_classes)).astype(np.float32)
    params["head_b"] = np.zeros((num_classes,), np.float32)
    return params


def forward(params: Params, x: torch.Tensor, arch: str) -> torch.Tensor:
    """Logits of NHWC images ``x``."""
    blocks, widths, bottleneck = ARCHS[arch]
    h = conv(x.permute(0, 3, 1, 2), params["stem"])
    h = torch.relu(group_norm(h, params["stem_g"], params["stem_b"]))
    for s, (nb, width) in enumerate(zip(blocks, widths)):
        for b in range(nb):
            pre = f"s{s}b{b}"
            stride = 2 if (s > 0 and b == 0) else 1
            shortcut = h
            if f"{pre}_proj" in params:
                shortcut = conv(h, params[f"{pre}_proj"], stride)
            if bottleneck:
                h = torch.relu(group_norm(
                    conv(h, params[f"{pre}_c1"]),
                    params[f"{pre}_g0"], params[f"{pre}_b0"]))
                h = torch.relu(group_norm(
                    conv(h, params[f"{pre}_c2"], stride),
                    params[f"{pre}_g1"], params[f"{pre}_b1"]))
                h = group_norm(conv(h, params[f"{pre}_c3"]),
                               params[f"{pre}_g2"], params[f"{pre}_b2"])
            else:
                h = torch.relu(group_norm(
                    conv(h, params[f"{pre}_c1"], stride),
                    params[f"{pre}_g0"], params[f"{pre}_b0"]))
                h = group_norm(conv(h, params[f"{pre}_c2"]),
                               params[f"{pre}_g1"], params[f"{pre}_b1"])
            h = torch.relu(h + shortcut)
    h = h.mean(dim=(2, 3))
    return h @ params["head_w"] + params["head_b"]


# -- trainer --------------------------------------------------------------

class ResNetTrainer:
    """Synchronous data parallelism over the mesh's data axis (module
    doc)."""

    def __init__(self, arch: str = "tiny", num_classes: int = 10, *,
                 learning_rate: float = 0.1, momentum: float = 0.9,
                 mesh: Optional[core.Mesh] = None, seed: int = 0) -> None:
        self.arch = arch
        self.mesh = mesh if mesh is not None else core.mesh()
        self.lr, self.mu = learning_rate, momentum
        self.devices = self.mesh.axis_devices(core.DATA_AXIS)
        host = init_resnet(arch, num_classes, seed)
        #: replica d's parameters and velocity, on self.devices[d]
        self.replicas = [{k: torch.tensor(v, device=dev)
                          for k, v in host.items()} for dev in self.devices]
        self.velocity = [{k: torch.zeros_like(v) for k, v in p.items()}
                         for p in self.replicas]

    @property
    def params(self) -> Params:
        """Replica 0's parameters (every replica holds the same)."""
        return self.replicas[0]

    def set_params(self, params: Dict[str, object]) -> None:
        """Install ``params`` (tensors or arrays, the port's layout) into
        every replica."""
        with torch.no_grad():
            for rep in self.replicas:
                for k, v in params.items():
                    rep[k].copy_(torch.as_tensor(v))

    def _grads(self, d: int, x: np.ndarray, y: np.ndarray,
               batch: int) -> Tuple[list, torch.Tensor]:
        """Replica ``d``'s gradients of its part of the global-mean loss
        (``-sum(log p) / batch`` over its lanes)."""
        dev = self.devices[d]
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in self.replicas[d].items()}
        logits = forward(leaves, torch.as_tensor(x, device=dev), self.arch)
        logp = torch.log_softmax(logits, dim=1)
        yt = torch.as_tensor(y, device=dev).long()
        part = -logp.gather(1, yt[:, None]).sum() / batch
        return torch.autograd.grad(part, list(leaves.values())), \
            part.detach()

    def train_step(self, x: np.ndarray, y: np.ndarray,
                   lr: Optional[float] = None) -> torch.Tensor:
        """One synchronous step on the global batch ``x``, ``y`` (its size
        divisible by the data axis); returns the global-mean loss on
        replica 0's device."""
        n, batch = len(self.devices), len(x)
        if batch % n:
            raise ValueError(f"batch {batch} does not divide over the "
                             f"data axis of {n}")
        lr = self.lr if lr is None else lr
        per = batch // n
        with dashboard.profile("resnet.step"):
            grads, parts = zip(*(
                self._grads(d, x[d * per:(d + 1) * per],
                            y[d * per:(d + 1) * per], batch)
                for d in range(n)))
            with torch.no_grad():
                for d, (params, velocity) in enumerate(
                        zip(self.replicas, self.velocity)):
                    dev = self.devices[d]
                    for i, k in enumerate(params):
                        g = grads[0][i].to(dev)
                        for r in range(1, n):   # in replica order
                            g = g + grads[r][i].to(dev)
                        velocity[k].mul_(self.mu).add_(g)
                        params[k].sub_(lr * velocity[k])
            loss = parts[0]
            for p in parts[1:]:
                loss = loss + p.to(loss.device)
        return loss

    def fit(self, X: np.ndarray, y: np.ndarray, *, steps: int,
            batch_size: int = 256, seed: int = 0) -> List[float]:
        rng = np.random.default_rng(seed)
        losses = []
        for _ in range(steps):
            idx = rng.integers(0, len(X), batch_size)
            losses.append(float(self.train_step(X[idx], y[idx])))
        return losses

    @torch.no_grad()
    def accuracy(self, X: np.ndarray, y: np.ndarray,
                 batch: int = 512) -> float:
        hits = 0
        for lo in range(0, len(X), batch):
            logits = forward(self.params, torch.as_tensor(
                X[lo:lo + batch], device=self.devices[0]), self.arch)
            hits += int((logits.argmax(dim=1).cpu().numpy()
                         == y[lo:lo + batch]).sum())
        return hits / len(X)


class BindingResNetTrainer(ResNetTrainer):
    """The same trainer driven through the binding-compat surface (the
    reference's multiverso-torch shape): a local step, then
    ``ParamManager.sync_all_param`` ships the delta since the last sync
    through the ArrayTable handler and gets the merged values back, which
    every replica installs."""

    def __init__(self, arch: str = "tiny", num_classes: int = 10, *,
                 learning_rate: float = 0.1, momentum: float = 0.9,
                 sync_every: int = 1, mesh: Optional[core.Mesh] = None,
                 seed: int = 0) -> None:
        super().__init__(arch, num_classes, learning_rate=learning_rate,
                         momentum=momentum, mesh=mesh, seed=seed)
        from multiverso_tpu_torch.bindings.torch_ext import ParamManager
        self.pm = ParamManager(self.params, name="resnet_pm")
        self._sync_every = max(sync_every, 1)
        self._it = 0

    def train_step(self, x: np.ndarray, y: np.ndarray,
                   lr: Optional[float] = None) -> torch.Tensor:
        loss = super().train_step(x, y, lr)
        self._it += 1
        if self._it % self._sync_every == 0:
            self.set_params(self.pm.sync_all_param(self.params))
        return loss


def main(argv=None) -> Tuple[List[float], float]:
    """The CLI; returns the losses and the final accuracy."""
    configure.define_string("arch", "tiny", "tiny | resnet18 | resnet50",
                            overwrite=True)
    configure.define_int("steps", 50, "training steps", overwrite=True)
    configure.define_int("batch_size", 256, "global batch size",
                         overwrite=True)
    configure.define_float("lr", 0.1, "learning rate", overwrite=True)
    configure.define_int("image_size", 32, "synthetic image size",
                         overwrite=True)
    configure.define_bool("binding", False,
                          "train through the ParamManager compat surface",
                          overwrite=True)
    configure.define_string("device", "", "one torch device for every "
                            "replica (default: the CUDA devices as a mesh "
                            "of -data_parallel x -model_parallel)",
                            overwrite=True)
    rest = configure.parse_flags(list(argv or []))
    if rest:
        raise SystemExit(f"unknown arguments {rest}")
    dp = configure.get_flag("data_parallel")
    mp = configure.get_flag("model_parallel")
    dev = configure.get_flag("device")
    core.init(devices=[dev] * (max(dp, 1) * mp) if dev else None,
              data_parallel=dp, model_parallel=mp)
    X, y = synthetic_imagenet(8192, size=configure.get_flag("image_size"))
    cls = BindingResNetTrainer if configure.get_flag("binding") \
        else ResNetTrainer
    trainer = cls(configure.get_flag("arch"),
                  learning_rate=configure.get_flag("lr"))
    losses = trainer.fit(X, y, steps=configure.get_flag("steps"),
                         batch_size=configure.get_flag("batch_size"))
    acc = trainer.accuracy(X, y)
    log.info("resnet %s: loss %.4f -> %.4f, accuracy %.4f",
             configure.get_flag("arch"), losses[0], losses[-1], acc)
    core.barrier()
    return losses, acc


if __name__ == "__main__":
    main(sys.argv[1:])
