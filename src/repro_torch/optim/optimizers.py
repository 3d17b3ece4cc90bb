"""Tree optimizers for Ferret's per-stage partial updates.

Counterpart of ``repro.optim.optimizers``: an ``Optimizer`` is a pair of
pure functions over a nested tensor dict, so each pipeline stage carries
its own optimizer state. Updates allocate new tensors and never modify
their inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

Tree = Any
f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Any]
    update: Callable[[Tree, Tree, Any], Tuple[Tree, Any]]
    # update(params, grads, state) -> (new_params, new_state)


class AdamWState(NamedTuple):
    mu: Tree
    nu: Tree
    count: torch.Tensor  # 0-d int32 on the parameters' device


def _zeros_f32(params: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros_like(p, dtype=f32), params)


def _unzip(params: Tree, out: list) -> list:
    """Per-leaf result tuples → one tree per tuple position."""
    _, treedef = tree_flatten(params)
    return [tree_unflatten(treedef, list(col)) for col in zip(*out)]


def adamw(
    lr: float = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    grad_clip: float = 0.0,
) -> Optimizer:
    def init(params: Tree) -> AdamWState:
        device = tree_leaves(params)[0].device
        return AdamWState(
            mu=_zeros_f32(params), nu=_zeros_f32(params),
            count=torch.zeros((), dtype=torch.int32, device=device),
        )

    def update(params: Tree, grads: Tree, state: AdamWState):
        if grad_clip > 0.0:
            gnorm = torch.sqrt(
                sum(torch.sum(torch.square(g.to(f32))) for g in tree_leaves(grads))
            )
            scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        count = state.count + 1
        # bias corrections in float32 on the device, as the reference computes them
        cf = count.to(f32)
        b1c = 1.0 - torch.pow(torch.full_like(cf, b1), cf)
        b2c = 1.0 - torch.pow(torch.full_like(cf, b2), cf)

        def leaf(p, g, m, v):
            g32 = g.to(f32)
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * torch.square(g32)
            mhat = m / b1c
            vhat = v / b2c
            step = lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.to(f32))
            return (p.to(f32) - step).to(p.dtype), m, v

        out = [
            leaf(p, g, m, v)
            for p, g, m, v in zip(
                tree_leaves(params), tree_leaves(grads),
                tree_leaves(state.mu), tree_leaves(state.nu),
            )
        ]
        new_params, new_mu, new_nu = _unzip(params, out)
        return new_params, AdamWState(new_mu, new_nu, count)

    return Optimizer(init=init, update=update)


class SGDState(NamedTuple):
    momentum: Tree


def sgd(lr: float = 1e-3, momentum: float = 0.0) -> Optimizer:
    def init(params: Tree) -> SGDState:
        return SGDState(momentum=_zeros_f32(params))

    def update(params: Tree, grads: Tree, state: SGDState):
        def leaf(p, g, m):
            m = momentum * m + g.to(f32)
            return (p.to(f32) - lr * m).to(p.dtype), m

        out = [
            leaf(p, g, m)
            for p, g, m in zip(
                tree_leaves(params), tree_leaves(grads), tree_leaves(state.momentum)
            )
        ]
        new_params, new_m = _unzip(params, out)
        return new_params, SGDState(new_m)

    return Optimizer(init=init, update=update)
