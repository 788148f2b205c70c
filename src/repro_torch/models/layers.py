"""The layer helpers the retrievers use (port of the init helpers and
``mlp_apply`` of ``repro.models.layers``).

Parameters live in :class:`ParamTree`, an ``nn.Module`` holding the same
nested dict/list structure as the reference's parameter pytrees and
indexed like it (``params["mlp"]["w"][0]``), so each scorer reads like
its JAX original and ``convert.params_from_jax`` maps a JAX tree onto it
name for name.  Inits draw from an explicit ``torch.Generator`` on the
CPU and move the result to the device: ``jax.random`` streams cannot be
reproduced in torch, so parity tests carry the JAX parameters across.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn


class ParamTree(nn.Module):
    """A nested dict of tensors, lists of tensors and lists of dicts as
    an ``nn.Module``, read with ``tree[name]`` like the JAX pytree."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(name, nn.Parameter(v))
            elif isinstance(v, dict):
                self.add_module(name, ParamTree(v))
            elif all(isinstance(x, torch.Tensor) for x in v):
                self.add_module(name, nn.ParameterList(v))
            else:
                self.add_module(name, nn.ModuleList(ParamTree(x) for x in v))

    def __getitem__(self, name: str):
        return getattr(self, name)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return torch.randn(d_in, d_out, generator=gen) * scale


def mlp_init(gen: torch.Generator, dims: Tuple[int, ...]) -> dict:
    """Plain MLP parameter stack: dims = (d0, d1, ..., dn)."""
    return {
        "w": [dense_init(gen, dims[i], dims[i + 1])
              for i in range(len(dims) - 1)],
        "b": [torch.zeros(dims[i + 1]) for i in range(len(dims) - 1)],
    }


def mlp_apply(p, x: torch.Tensor, act=torch.relu, final_act=None
              ) -> torch.Tensor:
    n = len(p["w"])
    for i in range(n):
        x = x @ p["w"][i] + p["b"][i]
        if i < n - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x
