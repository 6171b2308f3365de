"""The train step and the serve and prefill steps, as in the JAX package's
``train/step.py``, and the train state's checkpoints in its on-disk tree.

  state = init_state(gen, cfg, schedule, device)
        = {"params": LM module, "opt": optimizer state, "step": 0-d int32}
  train_step = make_train_step(cfg, schedule, num_microbatches=...)
  train_step(state, batch) -> (state, metrics)

A step differentiates ``lm.loss`` with autograd and writes the optimizer's
update into the parameters and the optimizer state in place (the port's
counterpart of the reference's donated state): the returned state is the
same dict, every tensor in its own storage. The step counter lives on the
host. Microbatches split the batch into contiguous row blocks; their
gradients accumulate in float32 and are scaled by ``1/n``.

Checkpoints hold the reference's tree, ``{"params", "opt", "step"}`` with
each ``blocks`` leaf stacked over the layers (:func:`checkpoint_tree`,
:func:`restore_state`), so a snapshot of either package restores in the
other.

On a model mesh (``init_state(..., mesh=)``, :func:`shard_state`) the
parameters are an ``nn.lm.ShardedLM`` and the optimizer state follows
their specs; the step is the same code, differentiating every distinct
shard, and each shard keeps its storage. A checkpoint gathers the shards
into whole leaves, so it restores on any mesh or on one device.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.analysis.contracts import kernel_contract
from repro_torch.configs.base import ModelConfig
from repro_torch.nn import lm
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compress
from repro_torch.train.optim import Schedule, make_optimizer


def init_state(gen, cfg: ModelConfig, schedule: Optional[Schedule] = None,
               device="cuda", mesh=None) -> Dict:
    """Random parameters from ``gen`` (a ``torch.Generator`` on ``device``
    or an int seed), zero optimizer state, step 0. With a ``mesh``
    (``launch.mesh.ModelMesh``) the parameters are drawn on its home
    device and laid out over it (an ``lm.ShardedLM``), and the optimizer
    state follows them (``device`` unused)."""
    params = (lm.init_sharded(gen, cfg, mesh) if mesh is not None
              else lm.init(gen, cfg, device))
    opt = make_optimizer(cfg.optimizer, schedule)
    return {"params": params, "opt": opt.init(_named(params)),
            "step": torch.zeros((), dtype=torch.int32)}


def shard_state(state: Dict, cfg: ModelConfig, mesh,
                schedule: Optional[Schedule] = None) -> Dict:
    """A one-device train state laid out over ``mesh``: copies, each
    shard on its position's device; ``state`` is not changed."""
    params = lm.shard(state["params"], cfg, mesh)
    out = {"params": params,
           "opt": make_optimizer(cfg.optimizer, schedule).init(params.leaves),
           "step": state["step"].clone()}
    with torch.no_grad():
        for k1, sub in state["opt"].items():
            for k2, t in sub.items():
                _copy(out["opt"][k1][k2], t)
    return out


def _named(params) -> Dict:
    """The optimizer's view of the parameters: ``{name: tensor}``, or
    ``{name: Sharded}`` for a sharded LM."""
    if isinstance(params, lm.ShardedLM):
        return params.leaves
    return dict(params.named_parameters())


def _tensors(params) -> Dict:
    """What autograd differentiates: every parameter, or every distinct
    shard (keyed by (name, coord))."""
    if isinstance(params, lm.ShardedLM):
        return params.shard_tensors()
    return dict(params.named_parameters())


def _regroup(params, grads: Dict) -> Dict:
    """Gradients keyed as :func:`_tensors` -> keyed as :func:`_named`."""
    if not isinstance(params, lm.ShardedLM):
        return grads
    from repro_torch.nn.collectives import Sharded
    return {n: Sharded(leaf.shape, leaf.spec, leaf.mesh,
                       {c: grads[(n, c)] for c in leaf.shards})
            for n, leaf in params.leaves.items()}


@kernel_contract(collectives="model-mesh", donated=("state",),
                 variant="mesh")
def make_train_step(cfg: ModelConfig, schedule: Optional[Schedule] = None, *,
                    num_microbatches: int = 1,
                    grad_compression: Optional[str] = None):
    opt = make_optimizer(cfg.optimizer, schedule)

    def grads_of(params, named, batch):
        loss, metrics = lm.loss(params, cfg, batch)
        grads = torch.autograd.grad(loss, list(named.values()))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def compute_grads(params, batch):
        named = _tensors(params)
        if num_microbatches == 1:
            loss, metrics, grads = grads_of(params, named, batch)
            return loss, metrics, _regroup(params, dict(zip(named, grads)))
        B = batch["tokens"].shape[0]
        rows = B // num_microbatches
        acc_l = acc_m = acc_g = None
        for i in range(num_microbatches):
            mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            loss, metrics, grads = grads_of(params, named, mb)
            if acc_g is None:
                # the float32 sum made a gradient at a time, each freed
                # once cast: not every gradient twice at once
                grads = list(grads)
                acc_l, acc_m, acc_g = loss, metrics, []
                for j, g in enumerate(grads):
                    acc_g.append(g.to(torch.float32))
                    grads[j] = None
            else:
                acc_l = acc_l + loss
                acc_m = {k: acc_m[k] + v for k, v in metrics.items()}
                # mixed dtypes promote tensor by tensor: no float32 copies
                torch._foreach_add_(acc_g, grads)
            del grads
        scale = 1.0 / num_microbatches
        torch._foreach_mul_(acc_g, scale)
        return (acc_l * scale, {k: v * scale for k, v in acc_m.items()},
                _regroup(params, dict(zip(named, acc_g))))

    def train_step(state: Dict, batch: Dict):
        params = state["params"]
        dev = lm.device_of(params)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        loss, metrics, grads = compute_grads(params, batch)
        if grad_compression == "int8_pod":
            grads = compress.compress_pod_gradients(grads)
        opt_metrics = opt.update(grads, state["opt"], _named(params),
                                 state["step"])
        state["step"] += 1
        return state, {**metrics, **opt_metrics, "loss": loss}

    return train_step


def make_serve_step(cfg: ModelConfig):
    """Single-token decode step of the serving engine."""
    def serve_step(params, token, caches):
        return lm.decode_step(params, cfg, token, caches)
    return serve_step


def make_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill_step(params, tokens, prefix=None):
        return lm.prefill(params, cfg, tokens, max_len, prefix)
    return prefill_step


# -- the state in the reference's tree ---------------------------------------

def state_tensors(state: Dict) -> Dict[str, torch.Tensor]:
    """Every parameter and optimizer-state tensor of ``state`` by a dotted
    name (``params.<name>``, ``opt.mu.<name>``, ``opt.<name>.vr``; a
    shard's name ends in its coordinate, ``[0, 1]``)."""
    from repro_torch.nn.collectives import Sharded
    out = {}

    def add(name, t):
        if isinstance(t, Sharded):
            for c, sh in t.shards.items():
                out[f"{name}{list(c)}"] = sh
        else:
            out[name] = t
    for n, p in _named(state["params"]).items():
        add(f"params.{n}", p)
    for k1, sub in state["opt"].items():
        for k2, t in sub.items():
            add(f"opt.{k1}.{k2}", t)
    return out


def _stacked(state: Dict) -> Dict[tuple, tuple]:
    """The reference tree's path of each leaf -> (its port tensors, the
    layers of a ``blocks`` leaf in order; whether the reference stacks
    them on a leading axis)."""
    out: Dict[tuple, tuple] = {}

    def add(prefix: tuple, flat: Dict[str, torch.Tensor], suffix=()):
        for path, names in lm.stack_groups(flat).items():
            out[prefix + tuple(path.split(".")) + suffix] = (
                [flat[n] for n in names], path.startswith("blocks."))

    add(("params",), _named(state["params"]))
    opt = state["opt"]
    if set(opt) == {"mu", "nu"}:            # AdamW
        for k in ("mu", "nu"):
            add(("opt", k), opt[k])
    else:                                   # Adafactor: {"vr", "vc"} / {"v"}
        for key in ("vr", "vc", "v"):
            add(("opt",), {n: s[key] for n, s in opt.items() if key in s},
                (key,))
    return out


def _put(tree: Dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def checkpoint_tree(state: Dict) -> Dict:
    """The state as the reference's tree, each ``blocks`` leaf stacked
    over the layers on a leading axis (on the state's device, where the
    stack is a fast copy): what ``checkpoint.save_async`` copies to the
    host and writes. A leaf that is not stacked is the state's own
    tensor, detached: copy the tree before the next step changes it."""
    from repro_torch.nn.collectives import Sharded
    tree: Dict = {}
    with torch.no_grad():
        for path, (ts, stacked) in _stacked(state).items():
            ts = [t.full() if isinstance(t, Sharded) else t for t in ts]
            _put(tree, path, torch.stack(ts) if stacked else ts[0].detach())
    tree["step"] = state["step"]
    return tree


def _copy(dst, src) -> None:
    """Copy a whole tensor into a state tensor, or into each shard of a
    Sharded its slice, in place."""
    from repro_torch.nn.collectives import Sharded
    if isinstance(dst, Sharded):
        dst.copy_from(src)
    else:
        dst.copy_(src)


def load_state(state: Dict, carried: Dict) -> None:
    """Copy a state in the port's names (:func:`repro_torch.convert.
    train_state_from_jax`) into ``state`` in place: a sharded state takes
    each leaf's slices into its shards."""
    with torch.no_grad():
        if isinstance(state["params"], lm.ShardedLM):
            for n, leaf in state["params"].leaves.items():
                leaf.copy_from(carried["params"][n])
        else:
            state["params"].load_state_dict(carried["params"])
        for k1, sub in carried["opt"].items():
            for k2, t in sub.items():
                _copy(state["opt"][k1][k2], t)
        state["step"].copy_(torch.as_tensor(carried["step"]))


def restore_state(state: Dict, directory: str,
                  step: Optional[int] = None) -> int:
    """Restore the newest (or the given) checkpoint under ``directory``
    into ``state`` in place; returns its step. The leaves go through the
    host, so the card holds no second copy of the state. A sharded state
    takes each leaf's slices, whatever mesh the snapshot was saved on
    (snapshots hold whole leaves)."""
    stacks = _stacked(state)
    template: Dict = {}
    for path, (ts, stacked) in stacks.items():
        shape = tuple(ts[0].shape)
        _put(template, path, torch.empty(
            ((len(ts),) + shape) if stacked else shape, dtype=ts[0].dtype,
            device="meta"))
    template["step"] = torch.empty((), dtype=torch.int32, device="meta")
    tree, got = ckpt.restore(template, directory, step, device="cpu")
    with torch.no_grad():
        for path, (ts, stacked) in stacks.items():
            src = tree
            for k in path:
                src = src[k]
            for r, t in enumerate(ts):
                _copy(t, src[r] if stacked else src)
        state["step"].copy_(tree["step"])
    return got
