"""Updater implementations, each a pure ``apply(param, state, delta,
option) -> (param, state)`` on tensors, with state a dict of tensors.

Counterpart of ``multiverso_tpu/updaters/updaters.py``. The option's
scalars enter the arithmetic as float32 0-d tensors, as the reference's
traced float32 scalars do, so both packages round alike (a Python float
would make ``b2 ** t`` a float64 power)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

State = Dict[str, torch.Tensor]


@dataclasses.dataclass
class AddOption:
    """Per-Add hyperparameters, the reference's ``AddOption`` struct."""
    learning_rate: float = 0.1
    momentum: float = 0.9
    rho: float = 0.999          # second-moment decay (adam)
    lam: float = 1e-8           # epsilon / regularization knob
    step: int = 0               # global step counter (adam bias correction)

    @classmethod
    def for_ftrl(cls, learning_rate: float, l1: float = 0.0,
                 l2: float = 0.0, beta: float = 1.0) -> "AddOption":
        """The ftrl updater's field mapping in ONE place: ``lam`` = L1,
        ``rho`` = L2, ``momentum`` = beta (alpha = learning_rate)."""
        return cls(learning_rate=learning_rate, lam=l1, rho=l2,
                   momentum=beta)

    def snapshot(self) -> "AddOption":
        """A copy, so a later step bump does not reach an applied option."""
        return dataclasses.replace(self)


@dataclasses.dataclass(frozen=True)
class Updater:
    """A named pair of pure functions: state init + apply."""
    name: str
    init_state: Callable[[torch.Tensor], State]
    apply: Callable[[torch.Tensor, State, torch.Tensor, AddOption],
                    Tuple[torch.Tensor, State]]


def _f32(x) -> torch.Tensor:
    """A scalar option field as a float32 0-d (CPU) tensor."""
    return torch.as_tensor(x, dtype=torch.float32)


def _zeros(param: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(param, dtype=torch.float32)


def _no_state(param: torch.Tensor) -> State:
    return {}


def _default_apply(param, state, delta, option):
    return param + delta.to(param.dtype), state


def _sgd_apply(param, state, delta, option):
    lr = _f32(option.learning_rate)
    return param - (lr * delta).to(param.dtype), state


def _adagrad_init(param: torch.Tensor) -> State:
    return {"h": _zeros(param)}


def _adagrad_apply(param, state, delta, option):
    lr, eps = _f32(option.learning_rate), _f32(option.lam)
    d32 = delta.to(torch.float32)
    h = state["h"] + d32 * d32
    return (param - (lr * d32 / (torch.sqrt(h) + eps)).to(param.dtype),
            {"h": h})


def _momentum_init(param: torch.Tensor) -> State:
    return {"v": _zeros(param)}


def _momentum_apply(param, state, delta, option):
    lr, mu = _f32(option.learning_rate), _f32(option.momentum)
    v = mu * state["v"] + delta.to(torch.float32)
    return param - (lr * v).to(param.dtype), {"v": v}


def _adam_init(param: torch.Tensor) -> State:
    return {"m": _zeros(param), "v": _zeros(param)}


def _adam_apply(param, state, delta, option):
    lr, b1, b2, eps = (_f32(option.learning_rate), _f32(option.momentum),
                       _f32(option.rho), _f32(option.lam))
    t = _f32(option.step) + 1.0
    d32 = delta.to(torch.float32)
    m = b1 * state["m"] + (1.0 - b1) * d32
    v = b2 * state["v"] + (1.0 - b2) * d32 * d32
    mhat = m / (1.0 - b1 ** t)
    vhat = v / (1.0 - b2 ** t)
    return (param - (lr * mhat / (torch.sqrt(vhat) + eps)).to(param.dtype),
            {"m": m, "v": v})


def _ftrl_init(param: torch.Tensor) -> State:
    return {"z": _zeros(param), "n": _zeros(param)}


def _ftrl_apply(param, state, delta, option):
    """FTRL-Proximal (per-coordinate). ``learning_rate`` = alpha,
    ``momentum`` = beta, ``lam`` = L1, ``rho`` = L2; the proximal weight
    is recomputed from (z, n), so L1 gives exact zeros."""
    alpha, beta = _f32(option.learning_rate), _f32(option.momentum)
    l1, l2 = _f32(option.lam), _f32(option.rho)
    z, n = state["z"], state["n"]
    g = delta.to(torch.float32)
    n_new = n + g * g
    sigma = (torch.sqrt(n_new) - torch.sqrt(n)) / alpha
    z_new = z + g - sigma * param.to(torch.float32)
    shrunk = torch.sign(z_new) * torch.clamp_min(torch.abs(z_new) - l1, 0.0)
    # |z| <= l1 selects w = 0 outside the division: with beta = l2 = 0 a
    # never-touched coordinate has n = z = 0 and the quotient is 0/0
    w = torch.where(torch.abs(z_new) <= l1, torch.zeros_like(z_new),
                    -shrunk / ((beta + torch.sqrt(n_new)) / alpha + l2))
    return w.to(param.dtype), {"z": z_new, "n": n_new}


def resolve_default_option(updater_name: str,
                           option: "AddOption | None") -> AddOption:
    """The right default AddOption for an updater: ftrl reads the generic
    fields as (L1, L2, beta), so a missing option resolves to
    ``AddOption.for_ftrl()`` and a generic-looking one gets a warning."""
    if updater_name != "ftrl":
        return option or AddOption()
    if option is None:
        return AddOption.for_ftrl(AddOption().learning_rate)
    if option.momentum == 0.9 and option.rho == 0.999:
        from multiverso_tpu_torch.utils import log
        log.warn(
            "updater='ftrl' reads AddOption fields as (lam, rho, "
            "momentum) = (L1, L2, beta); this option carries the "
            "generic adam-oriented defaults (momentum=0.9, rho=0.999), "
            "which mean beta=0.9 and L2=0.999 under ftrl — build it "
            "with AddOption.for_ftrl(lr, l1, l2, beta) instead")
    return option


_REGISTRY: Dict[str, Updater] = {}


def register_updater(updater: Updater) -> None:
    _REGISTRY[updater.name] = updater


def get_updater(name: str) -> Updater:
    """Factory selected by the ``updater_type`` flag."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown updater_type {name!r}; "
                         f"valid: {sorted(_REGISTRY)}") from None


def updater_names():
    return sorted(_REGISTRY)


register_updater(Updater("default", _no_state, _default_apply))
register_updater(Updater("sgd", _no_state, _sgd_apply))
register_updater(Updater("adagrad", _adagrad_init, _adagrad_apply))
register_updater(Updater("momentum", _momentum_init, _momentum_apply))
register_updater(Updater("adam", _adam_init, _adam_apply))
register_updater(Updater("ftrl", _ftrl_init, _ftrl_apply))
