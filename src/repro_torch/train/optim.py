"""Optimizers (AdamW, Adafactor), gradient clipping and the learning-rate
schedule, as in the JAX package's ``train/optim.py``.

The reference's optimizers are pure pytree transforms whose state XLA
donates; the port's write the update into the parameters and the state in
place under ``torch.no_grad()``, so a step keeps every tensor's storage.
Parameters, gradients and state are dicts keyed by the port's parameter
names (``LM.named_parameters()``). A reference leaf stacked over the
layers is several port tensors (:func:`repro_torch.nn.lm.stack_groups`);
where the reference reduces over a whole leaf (Adafactor's update RMS) the
port reduces over the layers of that leaf together.

Scalars follow the reference's float32 arithmetic: the schedule, the bias
corrections ``1 - b1**t`` and ``1 - b2**t`` and Adafactor's ``beta2`` are
0-d float32 tensors on the host. The state is float32.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.nn.lm import stack_groups

Tensors = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable      # (params) -> state
    update: Callable    # (grads, state, params, step) -> metrics, in place


def _f32(x) -> torch.Tensor:
    """A host 0-d float32 tensor (a step counter or a Python number)."""
    return torch.as_tensor(x).detach().to("cpu", torch.float32)


def _global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The float32 2-norm of every gradient together (the norm of the
    leaves' norms: one launch a few hundred leaves on the card)."""
    norms = torch._foreach_norm([g.to(torch.float32) for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float):
    """-> (the gradients in float32 scaled to a global norm of at most
    ``max_norm``, new tensors; the global norm before clipping). The norm
    and the scale stay on the gradients' device."""
    gn = _global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(gn, 1e-9), max=1.0)
    return torch._foreach_mul([g.to(torch.float32) for g in grads],
                              scale), gn


@dataclasses.dataclass(frozen=True)
class Schedule:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_ratio: float = 0.1

    def __call__(self, step) -> torch.Tensor:
        """Linear warm-up, then a cosine decay to ``min_ratio`` of the
        peak: a 0-d float32 host tensor."""
        step = _f32(step)
        warm = torch.clamp((step + 1) / self.warmup_steps, max=1.0)
        prog = torch.clamp((step - self.warmup_steps) /
                           max(self.decay_steps - self.warmup_steps, 1),
                           0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(np.pi * prog))
        return self.peak_lr * warm * (self.min_ratio +
                                      (1 - self.min_ratio) * cos)


def adamw(schedule: Schedule, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          max_grad_norm=1.0) -> Optimizer:
    def init(params: Tensors) -> Dict[str, Tensors]:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"mu": {n: zeros(p) for n, p in params.items()},
                "nu": {n: zeros(p) for n, p in params.items()}}

    @torch.no_grad()
    def update(grads: Tensors, state, params: Tensors, step) -> Dict:
        names = list(params)
        g, gn = clip_by_global_norm([grads[n] for n in names], max_grad_norm)
        lr = schedule(step)
        t = _f32(step) + 1.0
        c1 = float(1.0 - b1 ** t)
        c2 = float(1.0 - b2 ** t)
        mu = [state["mu"][n] for n in names]
        nu = [state["nu"][n] for n in names]
        p = [params[n] for n in names]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(g, 1 - b2), g))
        del g
        den = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        upd = torch._foreach_div(mu, c1)
        torch._foreach_div_(upd, den)
        del den
        pf = [x.to(torch.float32) for x in p]
        torch._foreach_add_(upd, torch._foreach_mul(pf, weight_decay))
        torch._foreach_mul_(upd, float(lr))
        if all(x is y for x, y in zip(p, pf)):
            torch._foreach_sub_(p, upd)
        else:
            torch._foreach_copy_(p, torch._foreach_sub(pf, upd))
        return {"grad_norm": gn, "lr": lr}

    return Optimizer(init=init, update=update)


def adafactor(schedule: Schedule, eps=1e-30, clip_threshold=1.0,
              decay_adamant=0.8, max_grad_norm=1.0,
              min_dim_size_to_factor=128) -> Optimizer:
    """Factored second moments (rows and columns) for a leaf whose last
    two axes are both at least ``min_dim_size_to_factor``: O(n+m) state
    in place of O(nm). The choice is made on the reference leaf's shape,
    the stacked axis included, and the update's RMS clip is taken over the
    whole leaf."""

    def _factored(shape) -> bool:
        return (len(shape) >= 2 and shape[-1] >= min_dim_size_to_factor
                and shape[-2] >= min_dim_size_to_factor)

    def _leaf_shape(params: Tensors, names: List[str]):
        shape = tuple(params[names[0]].shape)
        if len(names) > 1 or names[0].startswith("blocks."):
            if len(shape) == 1 and _factored((len(names),) + shape):
                raise NotImplementedError(
                    f"a stacked 1-D leaf of {len(names)} layers would share "
                    f"its column statistics across layers ({names[0]})")
            return (len(names),) + shape
        return shape

    def init(params: Tensors) -> Dict[str, Tensors]:
        state = {}
        for names in stack_groups(params).values():
            factored = _factored(_leaf_shape(params, names))
            for n in names:
                s = params[n].shape
                z = lambda shp: torch.zeros(shp, dtype=torch.float32,
                                            device=params[n].device)
                state[n] = ({"vr": z(s[:-1]), "vc": z(s[:-2] + s[-1:])}
                            if factored else {"v": z(s)})
        return state

    @torch.no_grad()
    def update(grads: Tensors, state, params: Tensors, step) -> Dict:
        names = list(params)
        clipped, gn = clip_by_global_norm([grads[n] for n in names],
                                          max_grad_norm)
        g_of = dict(zip(names, clipped))
        lr = float(schedule(step))
        t = _f32(step) + 1.0
        beta2 = 1.0 - t ** (-decay_adamant)
        b2, ob2 = float(beta2), float(1.0 - beta2)
        for group in stack_groups(params).values():
            pres = []
            for n in group:
                g, s = g_of[n], state[n]
                g2 = g * g + eps
                if "vr" in s:
                    s["vr"].mul_(b2).add_(ob2 * g2.mean(dim=-1))
                    s["vc"].mul_(b2).add_(ob2 * g2.mean(dim=-2))
                    vr, vc = s["vr"], s["vc"]
                    denom_r = vr / torch.clamp_min(
                        vr.mean(dim=-1, keepdim=True), eps)
                    pres.append(g / (torch.sqrt(denom_r)[..., None]
                                     * torch.sqrt(vc)[..., None, :] + eps))
                else:
                    s["v"].mul_(b2).add_(ob2 * g2)
                    pres.append(g / (torch.sqrt(s["v"]) + eps))
            # the update's RMS over the whole reference leaf, clipped
            count = sum(x.numel() for x in pres)
            rms = torch.sqrt(sum(torch.sum(x * x) for x in pres) / count
                             + eps)
            shrink = torch.clamp_min(rms / clip_threshold, 1.0)
            for n, pre in zip(group, pres):
                p = params[n]
                p.copy_(p.to(torch.float32) - lr * (pre / shrink))
        return {"grad_norm": gn, "lr": _f32(lr)}

    return Optimizer(init=init, update=update)


def make_optimizer(name: str,
                   schedule: Optional[Schedule] = None) -> Optimizer:
    schedule = schedule or Schedule()
    if name == "adamw":
        return adamw(schedule)
    if name == "adafactor":
        return adafactor(schedule)
    raise KeyError(name)
