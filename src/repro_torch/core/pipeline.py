"""Fine-grained asynchronous pipeline engine (paper §5.1.1).

Counterpart of ``repro.core.pipeline``. Executes the *learning dynamics*
of Ferret's async 1F1B pipeline — per-stage gradient staleness
τ_j = P-1-j, gradient accumulation (T2), back-prop omission (T3), worker
interleave/removal (T4) — round by round over arriving stream items, driven
by the host-side ``EngineSchedule`` (repro_torch.core.schedule).

The schedule is numpy on the host, so the reference's traced conditionals
(compute, push, pop) are host ``if``s here, and a round only back-propagates
into the stages that push a gradient in it: the reference computes the
other stages' gradients and discards them, so the numbers are the same.
Everything a round produces (loss, accuracy, λ) stays on the device;
``run`` returns it stacked, so the caller waits for the card once per run.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core import compensation as comp_lib
from repro_torch.core.schedule import EngineSchedule, RingGeometry
from repro_torch.optim.optimizers import Optimizer
from repro_torch.state.engine_state import EngineState
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

Tree = Any
f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class StagedModel:
    """Model split into P sequential stages.

    forward_stage(j, stage_params, x, batch) -> activations (stage j<P-1)
                                                or logits  (stage P-1)
    loss(logits, batch) -> (scalar loss, metrics dict)
    """

    num_stages: int
    forward_stage: Callable
    loss: Callable


def staged_from_transformer(cfg, boundaries) -> StagedModel:
    """Adapter: repro_torch.models.transformer -> StagedModel."""
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import cross_entropy_loss

    P = len(boundaries) - 1

    def fwd(j, sp, x, batch):
        return T.stage_forward(cfg, sp, x, j, P, boundaries, batch)

    def loss(logits, batch):
        ce = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
        preds = torch.argmax(logits, dim=-1)
        acc = torch.mean((preds == batch["labels"]).to(f32))
        return ce, {"acc": acc}

    return StagedModel(P, fwd, loss)


class FerretEngine:
    """Runs schedule rounds over a stream. Construct once per (model,
    partition); ``set_schedule`` swaps in the next segment's schedule."""

    def __init__(
        self,
        staged: StagedModel,
        schedule: EngineSchedule,
        optimizer: Optimizer,
        comp_cfg: comp_lib.CompensationConfig,
        lr: float = 1e-3,
    ):
        self.staged = staged
        self.sched = schedule
        self.opt = optimizer
        self.comp_cfg = comp_cfg
        self.lr = lr

    def set_schedule(self, schedule: EngineSchedule) -> None:
        self.sched = schedule

    @property
    def ring_geometry(self) -> RingGeometry:
        return RingGeometry(ring_size=self.sched.ring_size, delta_ring=self.sched.delta_ring)

    # -- state ------------------------------------------------------------
    def init_state(
        self,
        stage_params: List[Tree],
        opt_states=None,
        comp_states=None,
        rings=None,
        deltas=None,
    ) -> EngineState:
        """``EngineState`` for ``stage_params``; the optional pieces carry a
        run's state across segments and are fresh (zero rings, new optimizer
        and compensation state) when omitted."""
        Rsz, K = self.sched.ring_size, self.sched.delta_ring
        if rings is None:
            rings = tuple(
                tree_map(lambda p: torch.zeros((Rsz, *p.shape), dtype=f32, device=p.device), sp)
                for sp in stage_params
            )
        if deltas is None:
            deltas = tuple(
                tree_map(lambda p: torch.zeros((K, *p.shape), dtype=f32, device=p.device), sp)
                for sp in stage_params
            )
        if opt_states is None:
            opt_states = tuple(self.opt.init(sp) for sp in stage_params)
        if comp_states is None:
            comp_states = tuple(comp_lib.init_state(sp, self.comp_cfg) for sp in stage_params)
        return EngineState(
            stage_params=tuple(stage_params),
            rings=tuple(rings),
            deltas=tuple(deltas),
            opt_states=tuple(opt_states),
            comp_states=tuple(comp_states),
            geometry=self.ring_geometry,
        )

    # -- one round ----------------------------------------------------------
    def _full_loss(self, stages, batch):
        x = None
        for j in range(self.staged.num_stages):
            x = self.staged.forward_stage(j, stages[j], x, batch)
        return self.staged.loss(x, batch)

    def _loss_and_grads(self, stages, batch, grad_stages) -> Tuple:
        """Loss, metrics and the gradients of the stages in ``grad_stages``."""
        if not grad_stages:
            with torch.no_grad():
                loss, metrics = self._full_loss(stages, batch)
            return loss, metrics, {}
        stages_t = list(stages)
        inputs, treedefs = {}, {}
        for j in grad_stages:
            leaves, treedefs[j] = tree_flatten(stages[j])
            inputs[j] = [p.detach().requires_grad_(True) for p in leaves]
            stages_t[j] = tree_unflatten(treedefs[j], inputs[j])
        with torch.enable_grad():
            loss, metrics = self._full_loss(stages_t, batch)
            flat = torch.autograd.grad(loss, [p for j in grad_stages for p in inputs[j]])
        grads, i = {}, 0
        for j in grad_stages:
            n = len(inputs[j])
            grads[j] = tree_unflatten(treedefs[j], list(flat[i:i + n]))
            i += n
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def _live_round(self, m: int, batch, st: Dict[str, list], delta_mask, tau):
        s = self.sched
        P = self.staged.num_stages
        K = s.delta_ring
        grad_stages = [j for j in range(P) if s.push_slot[m, j] >= 0]
        loss, metrics, grads = self._loss_and_grads(st["stages"], batch, grad_stages)
        pmask = float(s.process[m])
        lam_sum = torch.zeros((), dtype=f32, device=loss.device)
        for j in range(P):
            # ---- push (accumulate into the gradient ring, T2) ----
            if s.push_slot[m, j] >= 0:
                bmask = pmask * float(s.backward[m, j])
                slot = int(s.push_slot[m, j])
                reset = bool(s.push_reset[m, j])
                for ring, g in zip(tree_leaves(st["rings"][j]), tree_leaves(grads[j])):
                    g = g.to(f32) * bmask
                    if reset:
                        ring[slot].copy_(g)
                    else:
                        ring[slot].add_(g)

            # ---- pop (compensate + apply, Alg. 1) ----
            if s.pop_slot[m, j] >= 0:
                pslot, scale = int(s.pop_slot[m, j]), float(s.pop_scale[m, j])
                g = tree_map(lambda a: a[pslot] * scale, st["rings"][j])
                head = int(s.delta_push_slot[m, j])
                order = [(head + i) % K for i in range(K)]  # oldest→newest
                mask = delta_mask[m, j]

                def ordered(a):
                    return torch.stack([a[i] for i in order]) * mask.reshape(
                        (K,) + (1,) * (a.ndim - 1)
                    )

                dl = tree_map(ordered, st["deltas"][j])
                params = st["stages"][j]
                comp_s, gc = comp_lib.compensate(
                    self.comp_cfg, st["comps"][j], g, dl, lr=self.lr, tau=tau[m, j]
                )
                newp, st["opts"][j] = self.opt.update(params, gc, st["opts"][j])
                dslot = max(head, 0)
                for ring, a, b in zip(
                    tree_leaves(st["deltas"][j]), tree_leaves(newp), tree_leaves(params)
                ):
                    ring[dslot].copy_(a.to(f32) - b.to(f32))
                st["stages"][j], st["comps"][j] = newp, comp_s
            lam_sum = lam_sum + st["comps"][j].lam
        return loss, metrics["acc"], lam_sum / P

    # -- run ------------------------------------------------------------
    def run(self, state: EngineState, stream: Dict[str, torch.Tensor]):
        """Run every schedule round. ``stream``: tensors stacked over rounds
        (e.g. tokens ``(R, b, s)``) on the state's device.

        The rings of ``state`` are updated in place; the returned state holds
        them with the new weights, optimizer and compensation state.
        Returns (final_state, ys): per-round ``loss``, ``acc``, ``admitted``,
        ``lam`` and ``tau_mean`` as ``(R,)`` f32 tensors on the device.
        Rounds with ``compute=False`` (schedule padding) run nothing and
        report zeros.
        """
        s = self.sched
        R = s.num_rounds
        lens = {k: v.shape[0] for k, v in stream.items()}
        if set(lens.values()) != {R}:
            raise ValueError(f"stream rounds {lens} do not match the schedule's {R}")
        device = tree_leaves(state.stage_params[0])[0].device
        compute = s.compute if s.compute is not None else np.ones(R, bool)
        # the only schedule arrays the device reads, uploaded once per run
        delta_mask = torch.as_tensor(s.delta_mask, dtype=f32, device=device)
        tau = torch.as_tensor(s.tau, device=device)
        st = {
            "stages": list(state.stage_params),
            "rings": list(state.rings),
            "deltas": list(state.deltas),
            "opts": list(state.opt_states),
            "comps": list(state.comp_states),
        }
        zero = torch.zeros((), dtype=f32, device=device)
        losses, accs, lams = [], [], []
        for m in range(R):
            if not compute[m]:
                losses.append(zero)
                accs.append(zero)
                lams.append(zero)
                continue
            batch = {k: v[m] for k, v in stream.items()}
            loss, acc, lam = self._live_round(m, batch, st, delta_mask, tau)
            losses.append(loss)
            accs.append(acc)
            lams.append(lam)
        host = {
            "admitted": (s.process & compute).astype(np.float32),
            "tau_mean": np.where(compute, s.tau.astype(np.float32).mean(axis=1), 0.0),
        }
        ys = {
            "loss": torch.stack(losses).to(f32),
            "acc": torch.stack(accs),
            "lam": torch.stack(lams),
            **{k: torch.as_tensor(v, dtype=f32, device=device) for k, v in host.items()},
        }
        final = dataclasses.replace(
            state,
            stage_params=tuple(st["stages"]),
            opt_states=tuple(st["opts"]),
            comp_states=tuple(st["comps"]),
        )
        return final, ys


# ---------------------------------------------------------------------------
# Delta-ring ordering: update u writes slot (u mod K). At pop time,
# delta_push = U mod K (U updates applied so far), and slot (U mod K) still
# holds update U-K — the *oldest* of the last K. Hence
# order = (delta_push + arange(K)) % K walks updates U-K..U-1 oldest→newest,
# and delta_mask keeps the most recent τ of them (the live staleness window).
# ---------------------------------------------------------------------------
