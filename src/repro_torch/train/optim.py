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


# the updates make their float32 temporaries for runs of tensors of at most
# this many elements together (1 GiB of float32), not for every tensor at
# once: at dbrx's width those were twice the parameters' bytes
RUN_NUMEL = 1 << 28


def _runs(tensors: Sequence[torch.Tensor]) -> List[List[int]]:
    """Indices of ``tensors`` in consecutive runs of at most
    :data:`RUN_NUMEL` elements together (a larger tensor alone), each run
    on one device (a model mesh's shards may lie on several)."""
    out: List[List[int]] = []
    total = RUN_NUMEL
    for i, t in enumerate(tensors):
        if total + t.numel() > RUN_NUMEL or (
                out and t.device != tensors[out[-1][0]].device):
            out.append([])
            total = 0
        out[-1].append(i)
        total += t.numel()
    return out


def _global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The float32 2-norm of every gradient together (the norm of the
    leaves' norms: one launch a run of leaves on the card)."""
    norms = []
    for run in _runs(grads):
        norms += torch._foreach_norm([grads[i].to(torch.float32)
                                      for i in run])
    return torch.linalg.vector_norm(torch.stack(
        [n.to(norms[0].device) for n in norms]))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp_min(gn, 1e-9), max=1.0)


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float):
    """-> (the gradients in float32 scaled to a global norm of at most
    ``max_norm``, new tensors; the global norm before clipping). The norm
    and the scale stay on the gradients' device. The optimizers clip a
    run of gradients at a time, to the same values."""
    gn = _global_norm(grads)
    return torch._foreach_mul([g.to(torch.float32) for g in grads],
                              _clip_scale(gn, max_norm)), gn


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
        if _is_sharded(params):
            return {k: {n: p.like(zeros) for n, p in params.items()}
                    for k in ("mu", "nu")}
        return {"mu": {n: zeros(p) for n, p in params.items()},
                "nu": {n: zeros(p) for n, p in params.items()}}

    def update_run(g, mu, nu, p, c1: float, c2: float, lr: float) -> None:
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
        torch._foreach_mul_(upd, lr)
        if all(x is y for x, y in zip(p, pf)):
            torch._foreach_sub_(p, upd)
        else:
            torch._foreach_copy_(p, torch._foreach_sub(pf, upd))

    @torch.no_grad()
    def update(grads: Tensors, state, params: Tensors, step) -> Dict:
        if _is_sharded(params):      # elementwise: shard by shard
            return update(_flat(grads), {k: _flat(state[k])
                                         for k in ("mu", "nu")},
                          _flat(params), step)
        names = list(params)
        gs = [grads[n] for n in names]
        gn = _global_norm(gs)
        scale = _clip_scale(gn, max_grad_norm)
        lr = schedule(step)
        t = _f32(step) + 1.0
        c1 = float(1.0 - b1 ** t)
        c2 = float(1.0 - b2 ** t)
        for run in _runs(gs):
            part = [names[i] for i in run]
            g = torch._foreach_mul([grads[n].to(torch.float32)
                                    for n in part],
                                   scale.to(grads[part[0]].device))
            update_run(g, [state["mu"][n] for n in part],
                       [state["nu"][n] for n in part],
                       [params[n] for n in part], c1, c2, float(lr))
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
        if _is_sharded(params):
            return _adafactor_init_sharded(params, _factored, _leaf_shape)
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
        sharded = _is_sharded(params)
        gn = _global_norm(list(_flat(grads).values()) if sharded
                          else [grads[n] for n in names])
        scale = _clip_scale(gn, max_grad_norm)
        lr = float(schedule(step))
        t = _f32(step) + 1.0
        beta2 = 1.0 - t ** (-decay_adamant)
        b2, ob2 = float(beta2), float(1.0 - beta2)
        if sharded:
            _adafactor_update_sharded(grads, state, params, scale, lr, b2,
                                      ob2, eps, clip_threshold)
            return {"grad_norm": gn, "lr": _f32(lr)}

        def precondition(g, s):
            """A clipped gradient (overwritten) -> its preconditioned
            update, from the second moments already updated."""
            if "vr" in s:
                vr, vc = s["vr"], s["vc"]
                denom_r = vr / torch.clamp_min(
                    vr.mean(dim=-1, keepdim=True), eps)
                den = (torch.sqrt(denom_r)[..., None]
                       * torch.sqrt(vc)[..., None, :])
                return g.div_(den.add_(eps))
            return g.div_(torch.sqrt(s["v"]).add_(eps))

        clipped = lambda n: grads[n].to(torch.float32) * scale
        for group in stack_groups(params).values():
            # first pass: the second moments, and the sum of the update's
            # squares over the whole reference leaf; a leaf of at most
            # RUN_NUMEL elements keeps its updates for the second pass
            count = sum(params[n].numel() for n in group)
            kept = {} if count <= RUN_NUMEL else None
            sq = 0
            for n in group:
                g, s = clipped(n), state[n]
                g2 = g * g
                g2.add_(eps)
                if "vr" in s:
                    s["vr"].mul_(b2).add_(ob2 * g2.mean(dim=-1))
                    s["vc"].mul_(b2).add_(ob2 * g2.mean(dim=-2))
                else:
                    s["v"].mul_(b2).add_(ob2 * g2)
                del g2
                pre = precondition(g, s)
                sq = sq + torch.sum(pre * pre)
                if kept is not None:
                    kept[n] = pre
            # its RMS, clipped; the second pass applies each update, and
            # a larger leaf's it recomputes (the same values): one
            # tensor's temporaries at a time, not a whole leaf's updates
            rms = torch.sqrt(sq / count + eps)
            shrink = torch.clamp_min(rms / clip_threshold, 1.0)
            for n in group:
                pre = (kept.pop(n) if kept is not None
                       else precondition(clipped(n), state[n]))
                pre.div_(shrink).mul_(lr)
                p = params[n]
                pf = p.to(torch.float32)
                if pf is p:
                    p.sub_(pre)
                else:
                    p.copy_(pf.sub_(pre))
        return {"grad_norm": gn, "lr": _f32(lr)}

    return Optimizer(init=init, update=update)


# -- on a model mesh -----------------------------------------------------------
# Parameters, gradients and state are Shardeds (nn.collectives) keyed by the
# port's parameter names; the state follows its parameter's spec, Adafactor's
# row and column statistics their own (the reference's axes, one dropped).
# The global norm runs over every distinct shard in a fixed order. Adafactor
# reads whole rows (columns) of the squared gradient for a statistic and the
# whole row statistic for its mean, gathered from the shards that hold them,
# so each statistic is the one-device value; the update's sum of squares is
# summed over the shards of the reference leaf in order.

def _is_sharded(tree) -> bool:
    from repro_torch.nn.collectives import Sharded
    return isinstance(next(iter(tree.values()), None), Sharded)


def _flat(tree) -> Dict:
    """{name: Sharded} -> {(name, coord): shard}."""
    return {(n, c): t for n, leaf in tree.items()
            for c, t in leaf.shards.items()}


def _adafactor_init_sharded(params, factored, leaf_shape):
    from repro_torch.nn.collectives import Sharded
    from repro_torch.nn.sharding import (adafactor_axes, axes_of,
                                         shard_shape, spec_for)
    state = {}
    shapes = {n: torch.empty(p.shape, device="meta")
              for n, p in params.items()}
    for names in stack_groups(params).values():
        fac = factored(leaf_shape(shapes, names))
        for n in names:
            p = params[n]
            s = p.shape
            ax = adafactor_axes(axes_of(n), fac)
            shp = {"vr": s[:-1], "vc": s[:-2] + s[-1:], "v": s}
            out = {}
            for key, axes in ax.items():
                spec = spec_for(shp[key], axes, p.mesh)
                local = shard_shape(shp[key], spec, p.mesh)
                out[key] = Sharded.build(
                    shp[key], spec, p.mesh, lambda c, box, pos, local=local:
                    torch.zeros(local, dtype=torch.float32,
                                device=p.mesh.device(pos)))
            state[n] = out
    return state


def _adafactor_update_sharded(grads, state, params, scale, lr, b2, ob2, eps,
                              clip_threshold) -> None:
    for group in stack_groups(params).values():
        count = sum(int(np.prod(params[n].shape)) for n in group)
        pres = {}
        sq = 0
        for n in group:
            p, st = params[n], state[n]
            g2 = grads[n].like(
                lambda t: t.to(torch.float32) * scale.to(t.device))
            g2 = g2.like(lambda t: t.mul_(t).add_(eps))
            if "vr" in st:
                # a statistic's box of the squared gradient: its rows
                # (columns) whole
                for key, dim in (("vr", -1), ("vc", -2)):
                    v = st[key]
                    for c, t in v.shards.items():
                        box = list(v.box(c))
                        box = (box + [(0, p.shape[-1])] if key == "vr" else
                               box[:-1] + [(0, p.shape[-2])] + box[-1:])
                        got = g2.assemble(box, t.device, at=v.owner(c))
                        t.mul_(b2).add_(ob2 * got.mean(dim=dim))
            else:
                for c, t in st["v"].shards.items():
                    t.mul_(b2).add_(ob2 * g2.shards[c])
            del g2
            pres[n] = {}
            for c, gt in grads[n].shards.items():
                pos = p.owner(c)
                box = list(p.box(c))
                g = gt.to(torch.float32) * scale.to(gt.device)
                if "vr" in st:
                    vr, vc = st["vr"], st["vc"]
                    rows = vr.assemble(box[:-1], g.device, at=pos)
                    allr = vr.assemble(box[:-2] + [(0, p.shape[-2])],
                                       g.device, at=pos)
                    cols = vc.assemble(box[:-2] + box[-1:], g.device, at=pos)
                    denom_r = rows / torch.clamp_min(
                        allr.mean(dim=-1, keepdim=True), eps)
                    den = (torch.sqrt(denom_r)[..., None]
                           * torch.sqrt(cols)[..., None, :])
                    pre = g.div_(den.add_(eps))
                else:
                    pre = g.div_(torch.sqrt(st["v"].shards[c]).add_(eps))
                sq = sq + torch.sum(pre * pre).to(params[group[0]].mesh.home)
                pres[n][c] = pre
        rms = torch.sqrt(sq / count + eps)
        shrink = torch.clamp_min(rms / clip_threshold, 1.0)
        for n in group:
            for c, t in params[n].shards.items():
                pre = pres[n].pop(c)
                pre.div_(shrink.to(pre.device)).mul_(lr)
                pf = t.to(torch.float32)
                if pf is t:
                    t.sub_(pre)
                else:
                    t.copy_(pf.sub_(pre))


def make_optimizer(name: str,
                   schedule: Optional[Schedule] = None) -> Optimizer:
    schedule = schedule or Schedule()
    if name == "adamw":
        return adamw(schedule)
    if name == "adafactor":
        return adafactor(schedule)
    raise KeyError(name)
