"""Optimizers over the port's parameter trees (port of
``repro.train.optimizer``; not ``torch.optim``).

The API is the reference's, optax-like and functional:
``opt.init(params) -> state``; ``opt.update(grads, state, params) ->
(updates, state)``; apply with :func:`apply_updates`.  ``params`` is a
:class:`~repro_torch.models.layers.ParamTree` or a plain tree of
tensors (``repro_torch.tree``); states and updates are plain trees in
the reference's layout (``{"step", "mu", "nu"}`` for adam, ``{"step",
"mom"}`` with ``mom`` None without momentum, ``{"step", "v"}`` for
adafactor), so a training checkpoint of either package names the same
leaves.  The arithmetic is the reference's, op for op, in float32: the
step is an int32 tensor, bias corrections are ``b ** step`` in float32,
and a Python scalar divided by a tensor is a true division (torch
otherwise multiplies by the tensor's reciprocal).
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import torch
from torch import nn

from .. import tree as T

F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]


def _over(x: float, t: torch.Tensor) -> torch.Tensor:
    """``x / t`` as a float32 true division."""
    return torch.full_like(t, x, dtype=F32) / t


def _zeros(p) -> torch.Tensor:
    """Float32 zeros of ``p``'s shape (and, for a DTensor, placement)."""
    return torch.zeros_like(p, dtype=F32,
                            memory_format=torch.contiguous_format)


def apply_updates(params, updates):
    """``params + updates`` in each parameter's dtype.  A ``nn.Module``
    (a ParamTree) is updated in place, under ``torch.no_grad()``, and
    returned; a plain tree gives a new tree."""
    if isinstance(params, nn.Module):
        with torch.no_grad():
            for p, u in zip(T.leaves(params), T.leaves(updates),
                            strict=True):
                p.copy_((p + u).to(p.dtype))
        return params
    return T.tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.to(F32))) for x in T.leaves(tree)]
    total = sq[0]
    for s in sq[1:]:
        total = total + s
    return torch.sqrt(total)


def clip_by_global_norm(updates, max_norm: float):
    g = global_norm(updates)
    scale = torch.clamp(_over(max_norm, torch.clamp(g, min=1e-9)), max=1.0)
    return T.tree_map(lambda u: u * scale, updates), g


def _lr(lr) -> Callable:
    return lr if callable(lr) else (lambda i: lr)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=T.leaves(params)[0].device)


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    lr_fn = _lr(lr)

    def init(params):
        mom = T.tree_map(_zeros, params) if momentum else None
        return {"step": _step0(params), "mom": mom}

    @torch.no_grad()
    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        if momentum:
            mom = T.tree_map(lambda m, g: momentum * m + g.to(F32),
                             state["mom"], grads)
            upd = T.tree_map(lambda m: -lr_t * m, mom)
            return upd, {"step": step, "mom": mom}
        return T.tree_map(lambda g: -lr_t * g, grads), {"step": step,
                                                        "mom": None}

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam / AdamW (decoupled decay when weight_decay > 0)."""
    lr_fn = _lr(lr)

    def init(params):
        return {"step": _step0(params),
                "mu": T.tree_map(_zeros, params),
                "nu": T.tree_map(_zeros, params)}

    @torch.no_grad()
    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=F32,
                                           device=step.device),
                              step.to(F32))
        bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=F32,
                                           device=step.device),
                              step.to(F32))
        mu = T.tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(F32),
                        state["mu"], grads)
        nu = T.tree_map(lambda v, g: b2 * v
                        + (1 - b2) * torch.square(g.to(F32)),
                        state["nu"], grads)

        def upd(m, v, p):
            u = -(lr_t * (m / bc1) / (torch.sqrt(v / bc2) + eps))
            if weight_decay:
                u = u - lr_t * weight_decay * p.to(F32)
            return u

        if params is None:
            params = T.tree_map(torch.zeros_like, mu)
        updates = T.tree_map(upd, mu, nu, params)
        return updates, {"step": step, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def adamw(lr, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


def adafactor(lr, eps: float = 1e-30, decay: float = 0.8,
              clip_threshold: float = 1.0) -> Optimizer:
    """Adafactor (factored second moment for leaves of rank >= 2)."""
    lr_fn = _lr(lr)

    def _factored(shape) -> bool:
        return len(shape) >= 2

    def init(params):
        def per(p):
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=F32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=F32, device=p.device)}
            return {"v": _zeros(p)}
        return {"step": _step0(params), "v": T.tree_map(per, params)}

    @torch.no_grad()
    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        beta = 1.0 - torch.pow(step.to(F32), -decay)

        def per(g, v):
            g = g.to(F32)
            g2 = torch.square(g) + eps
            if _factored(g.shape):
                vr = beta * v["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * v["vc"] + (1 - beta) * g2.mean(-2)
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr.mean(-1)[..., None, None],
                                       min=eps))
                u = g / torch.sqrt(denom + eps)
                nv = {"vr": vr, "vc": vc}
            else:
                nv = {"v": beta * v["v"] + (1 - beta) * g2}
                u = g / torch.sqrt(nv["v"] + eps)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms / torch.full_like(rms, clip_threshold),
                                min=1.0)
            return -lr_t * u, nv

        # per-leaf (update, state) pairs at the gradient's leaves
        outs = T.tree_map(per, grads, state["v"])
        updates = T.tree_map(lambda _, o: o[0], grads, outs)
        new_v = T.tree_map(lambda _, o: o[1], grads, outs)
        return updates, {"step": step, "v": new_v}

    return Optimizer(init, update)


def get_optimizer(name: str, lr, **kw) -> Optimizer:
    return {"sgd": sgd, "adam": adam, "adamw": adamw,
            "adafactor": adafactor}[name](lr, **kw)


# -- schedules ---------------------------------------------------------------

def warmup_cosine(peak: float, warmup: int, total: int,
                  floor: float = 0.1):
    def fn(step):
        step = torch.as_tensor(step).to(F32)
        warm = peak * step / torch.full_like(step, max(warmup, 1))
        t = torch.clamp((step - warmup)
                        / torch.full_like(step, max(total - warmup, 1)),
                        0.0, 1.0)
        cos = (floor * peak + (1 - floor) * peak * 0.5
               * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return fn
