"""Generic training loop with the production affordances (port of
``repro.train.loop``): gradient accumulation, global-norm clipping,
optional gradient compression (error feedback carried in the train
state), periodic atomic checkpoints with auto-resume, straggler
monitoring, cooperative preemption.

The step takes the gradient with ``torch.autograd`` and updates the
parameters under ``torch.no_grad()``; a ParamTree is updated in place,
so an engine built on it scores with the trained weights.  No kernel of
the port has a backward: the scorers' parameters sit after every kernel
(the lookup's M is a constant, and KNRM weights the pooled features), so
the kernels run forward inside the step and autograd reaches every
parameter.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from .. import obs
from .. import tree as T
from ..ckpt import (latest_step, restore_checkpoint, save_checkpoint,
                    wait_async)
from ..dist.compression import compress_with_feedback
from ..dist.fault import PreemptionGuard, StragglerMonitor
from ..obs.metrics import DEFAULT_S_BUCKETS
from .optimizer import Optimizer, apply_updates, clip_by_global_norm

_log = obs.get_logger("repro.train")


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    residual: Any = None      # error-feedback buffer (compression on)
    step: int = 0


def value_and_grad(loss_fn: Callable, params, batch):
    """``(loss, grads)`` of ``loss_fn(params, batch)``: grads a plain tree
    of ``params``' structure, zeros for a leaf the loss does not use (as
    ``jax.grad`` gives), a DTensor's with its parameter's placements.  A
    ``nn.Module``'s parameters are differentiated as they are; a plain
    tree's leaves through detached copies."""
    if isinstance(params, nn.Module):
        xs, live = T.leaves(params), params
    else:
        xs = [p.detach().requires_grad_(True) for p in T.leaves(params)]
        live = T.unflatten(params, xs)
    with torch.enable_grad():
        loss = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, xs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else _summed(g, x)
             for x, g in zip(xs, grads)]
    return loss.detach(), T.unflatten(params, grads)


def _summed(g, x):
    """``g`` with ``x``'s placements where it is a DTensor partial sum
    (a replicated parameter's gradient from each rank's part, as
    ``models.mace`` gives it): summed here, once."""
    from ..dist.dtensor import is_dtensor
    if is_dtensor(g) and any(p.is_partial() for p in g.placements):
        return g.redistribute(g.device_mesh, x.placements)
    return g


def make_train_step(loss_fn: Callable, opt: Optimizer, *,
                    clip_norm: float = 1.0, accum: int = 1,
                    compression: Optional[str] = None,
                    donate: bool = True) -> Callable:
    """Returns step(params, opt_state, residual, batch) -> (params,
    opt_state, residual, metrics) with metrics ``{"loss", "grad_norm"}``
    as 0-d tensors on the parameters' device.

    loss_fn(params, batch) -> scalar tensor.  ``accum`` > 1 sums the
    loss and the gradients over microbatches ``batch[i]`` (every leaf of
    the batch has a leading axis of ``accum``), in order, then scales by
    ``1 / accum``.  ``donate`` is accepted and has no effect (torch
    frees the old state when the caller drops it).

    Placed state (DTensor parameters, optimizer state and batch, as the
    reference's ``jit`` on sharded inputs) steps on its mesh: the step
    runs with that mesh current (``launch.mesh.set_mesh``) and plain
    tensors taken as replicated, its gradients, moments and updates
    keep their parameter's placement, and its metrics come back
    replicated."""
    del donate

    def grads_of(params, batch):
        if accum == 1:
            return value_and_grad(loss_fn, params, batch)
        dev = T.leaves(params)[0].device
        tot = torch.zeros((), dtype=torch.float32, device=dev)
        g = T.tree_map(lambda p: torch.zeros_like(
            p, dtype=torch.float32, memory_format=torch.contiguous_format),
            params)
        for i in range(accum):
            mb = T.tree_map(lambda x: x[i], batch)
            l, gi = value_and_grad(loss_fn, params, mb)
            tot, g = tot + l, T.tree_map(torch.add, g, gi)
        inv = 1.0 / accum
        return tot * inv, T.tree_map(lambda x: x * inv, g)

    def step(params, opt_state, residual, batch):
        mesh = _mesh_of(params)
        if mesh is None:
            return plain_step(params, opt_state, residual, batch)
        from torch.distributed.tensor.experimental import \
            implicit_replication

        from ..launch.mesh import set_mesh
        from ..dist.dtensor import replicate_all
        with set_mesh(mesh), implicit_replication():
            *state, metrics = plain_step(params, opt_state, residual, batch)
            # whole values on every rank (a loss may be a partial sum)
            return (*state, {k: replicate_all(v) for k, v in
                             metrics.items()})

    def plain_step(params, opt_state, residual, batch):
        loss, grads = grads_of(params, batch)
        with torch.no_grad():
            if compression:
                grads, residual = compress_with_feedback(
                    grads, residual, scheme=compression)
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, residual, {"loss": loss,
                                             "grad_norm": gnorm}

    return step


def _mesh_of(tree):
    """The mesh of the first DTensor leaf of ``tree``, or None."""
    from ..dist.dtensor import is_dtensor
    for leaf in T.leaves(tree):
        if is_dtensor(leaf):
            return leaf.device_mesh
    return None


@dataclass
class FitResult:
    state: TrainState
    history: list = field(default_factory=list)
    straggler: StragglerMonitor = field(default_factory=StragglerMonitor)


def fit(state: TrainState, step_fn: Callable, next_batch: Callable[[int], Any],
        *, n_steps: int, ckpt_dir: Optional[str] = None,
        ckpt_every: int = 100, keep: int = 3, log_every: int = 50,
        data_state: Optional[Callable[[], Dict]] = None,
        guard: Optional[PreemptionGuard] = None,
        verbose: bool = True) -> FitResult:
    """Run the loop; resume from ckpt_dir if a checkpoint exists (the
    parameters, optimizer state and residual; ``data_state`` is saved
    into the manifest's ``extra`` and not restored, as in the
    reference)."""
    res = FitResult(state=state)
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        tree = {"params": state.params, "opt": state.opt_state,
                "residual": state.residual}
        tree, manifest = restore_checkpoint(ckpt_dir, tree)
        state.params = T.assign(state.params, tree["params"])
        state.opt_state = tree["opt"]
        state.residual = tree["residual"]
        state.step = manifest["step"]
        if verbose:
            _log.info("resumed", step=state.step)

    while state.step < n_steps:
        if guard is not None and guard.should_stop:
            if ckpt_dir:
                _save(ckpt_dir, state, keep, data_state)
                wait_async()
            if verbose:
                _log.info("preempted; checkpointed", step=state.step)
            return res
        batch = next_batch(state.step)
        t0 = time.perf_counter()
        with obs.span("train.step"):
            state.params, state.opt_state, state.residual, metrics = \
                step_fn(state.params, state.opt_state, state.residual,
                        batch)
            # float() waits for the step's device work (block_until_ready)
            metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.perf_counter() - t0
        slow = res.straggler.record(state.step, dt)
        state.step += 1
        if obs.enabled():
            obs.counter("seine_train_steps_total", "optimiser steps").inc()
            obs.gauge("seine_train_loss",
                      "most recent train loss").set(metrics["loss"])
            obs.histogram("seine_train_step_seconds",
                          "per-step wall time",
                          buckets=DEFAULT_S_BUCKETS).observe(dt)
        res.history.append({"step": state.step, "sec": dt, **metrics,
                            "straggler": slow})
        if verbose and state.step % log_every == 0:
            fields = dict(step=state.step, loss=f"{metrics['loss']:.4f}",
                          ms=f"{dt * 1e3:.0f}")
            if slow:
                fields["straggler"] = True
            _log.info("step", **fields)
        if ckpt_dir and state.step % ckpt_every == 0:
            _save(ckpt_dir, state, keep, data_state)
    if ckpt_dir:
        _save(ckpt_dir, state, keep, data_state)
        wait_async()
    return res


def _save(ckpt_dir, state: TrainState, keep, data_state) -> None:
    # async: the device-to-host copy runs on this thread, the file I/O and
    # the atomic publish overlap the next training steps.  Every fit()
    # exit joins through wait_async(), which raises the first background
    # write failure: a checkpoint that never landed must not look like a
    # clean run.
    tree = {"params": state.params, "opt": state.opt_state,
            "residual": state.residual}
    extra = {"data": data_state()} if data_state else {}
    save_checkpoint(ckpt_dir, state.step, tree, extra=extra, keep=keep,
                    async_write=True)
