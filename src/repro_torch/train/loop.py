"""End-to-end training loop: data plane + train step + checkpoints +
recovery, as in the JAX package's ``train/loop.py``.

The loop runs on ``pipe_cfg.device``: the data plane's sketches and the
model share the card (or the CPU). Each step folds its batch into the data
plane's n-gram statistics (one plan launch on the card), then takes a
train step; every ``ckpt_every`` steps the state is written in the
reference's tree (``train.step.checkpoint_tree``) by
``checkpoint.save_async``. On an injected failure ``run_with_recovery``
restores the newest checkpoint in place (after joining its writer) and
replays from it; the corpus is stateless-resumable, so a replayed step
sees the same batch (and folds it into the statistics once more, as the
reference's loop does). ``log`` also gets a line for each snapshot and
restore, with its seconds; a step's line also carries the MoE's
``load_balance`` and ``dropped_frac`` when the model has experts.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataPlane, PipelineConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import (FailureInjector, Watchdog,
                                     run_with_recovery)
from repro_torch.train.optim import Schedule
from repro_torch.train.step import (checkpoint_tree, init_state,
                                    make_train_step, restore_state)


@dataclasses.dataclass
class LoopConfig:
    n_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    log_every: int = 10
    seed: int = 0
    num_microbatches: int = 1


def train(cfg: ModelConfig, pipe_cfg: PipelineConfig, loop_cfg: LoopConfig,
          schedule: Optional[Schedule] = None,
          injector: Optional[FailureInjector] = None,
          log: Callable[[str], None] = print, *,
          state: Optional[Dict] = None,
          data: Optional[DataPlane] = None, mesh=None) -> Dict:
    """Train ``loop_cfg.n_steps`` steps. The initial state is drawn from
    ``loop_cfg.seed`` on ``pipe_cfg.device`` (laid out over ``mesh``, a
    ``launch.mesh.ModelMesh``, when one is given: the batch is then split
    over its ``pod`` and ``data`` axes and the parameters by their
    specs), or copied from ``state`` (which is not changed); ``data`` is
    the data plane to draw batches from (default: a new
    ``DataPlane(pipe_cfg)``, which keeps its own data mesh). Returns
    ``run_with_recovery``'s dict (``history``, ``restarts``,
    ``final_step``) with ``losses``, ``stragglers``, ``telemetry`` and the
    final ``state``."""
    device = torch.device(pipe_cfg.device)
    data = data if data is not None else DataPlane(pipe_cfg)

    def initial() -> Dict:
        if state is not None:
            return copy.deepcopy(state)
        home = mesh.home if mesh is not None else device
        gen = torch.Generator(device=home).manual_seed(loop_cfg.seed)
        return init_state(gen, cfg, schedule, device, mesh=mesh)

    step_fn = make_train_step(cfg, schedule,
                              num_microbatches=loop_cfg.num_microbatches)
    watchdog = Watchdog()
    box: Dict = {"state": None}

    def restore_ckpt() -> int:
        t0 = time.perf_counter()
        ckpt.flush()     # a restore sees every snapshot already issued
        t1 = time.perf_counter()
        latest = ckpt.latest_step(loop_cfg.ckpt_dir)
        if latest is None or box["state"] is None:
            box["state"] = None    # drop the old state before a new one
            box["state"] = initial()
        if latest is None:
            return 0
        got = restore_state(box["state"], loop_cfg.ckpt_dir)
        log(f"restored step {got} in {time.perf_counter() - t1:.2f} s "
            f"(waited {t1 - t0:.2f} s for the snapshot writer)")
        return got

    def save_ckpt(step: int) -> None:
        t0 = time.perf_counter()
        ckpt.save_async(checkpoint_tree(box["state"]), loop_cfg.ckpt_dir,
                        step)
        log(f"checkpoint step {step}: copied to the host in "
            f"{time.perf_counter() - t0:.2f} s, written by a thread")

    losses = []

    def one_step(step: int) -> Dict:
        watchdog.start()
        batch = data.next_batch(step)
        box["state"], metrics = step_fn(box["state"], batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = watchdog.stop(step)
        if step % loop_cfg.log_every == 0:
            tel = data.telemetry()
            moe = (f" load_balance {float(metrics['load_balance']):.4f} "
                   f"dropped_frac {float(metrics['dropped_frac']):.4f}"
                   if cfg.n_experts else "")
            log(f"step {step:5d} loss {loss:7.4f} "
                f"ce {float(metrics['ce']):7.4f} "
                f"gnorm {float(metrics['grad_norm']):8.3f} "
                f"{dt*1e3:7.1f} ms  distinct_ngrams~"
                f"{tel['distinct_ngrams']:.3g} "
                f"deduped {tel['docs_deduped']}{moe}")
        return {"loss": loss}

    try:
        result = run_with_recovery(one_step, save_ckpt, restore_ckpt,
                                   n_steps=loop_cfg.n_steps,
                                   ckpt_every=loop_cfg.ckpt_every,
                                   injector=injector)
    finally:
        ckpt.flush()
    result["losses"] = losses
    result["stragglers"] = watchdog.stragglers
    result["telemetry"] = data.telemetry()
    result["state"] = box["state"]
    return result
