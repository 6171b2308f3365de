"""Training launcher: config -> state -> hash data plane -> train step ->
checkpoint/restore -> watchdog, as the JAX package's
``repro.launch.train``, on one device.

  python -m repro_torch.launch.train --arch qwen1.5-0.5b --recommended \\
      --steps 50 --seq 1024 --batch 8 [--resume] [--device cuda]

The reference's flags plus ``--device`` (default ``cuda``); its
``--host-devices`` (XLA's virtual CPU devices) has no counterpart.
``--data-mesh``, ``--model-mesh`` and ``--pod-mesh`` lay the state out
over a (pod, data, model) model mesh (``launch.mesh``): on distinct cards
where the machine has one for every position, else as virtual shards of
``--device``; the batch is split over pod and data, as the reference's
``launch/train.py`` does. The reference checks that XLA lowered its
state donation to aliasing; the port updates the state in place, and
checks after the first step that every parameter and optimizer-state
tensor (every shard, on a mesh) kept its storage.
"""
import argparse
import os
import tempfile
from typing import Dict, List


def storage_pointers(state: Dict) -> Dict[str, int]:
    """``data_ptr`` of every parameter and optimizer-state tensor."""
    from repro_torch.train.step import state_tensors
    return {k: t.data_ptr() for k, t in state_tensors(state).items()}


def moved(before: Dict[str, int], state: Dict) -> List[str]:
    """The tensors of ``state`` whose storage is not where ``before``
    found it (or that are new or gone)."""
    after = storage_pointers(state)
    return sorted(k for k in before.keys() | after.keys()
                  if before.get(k) != after.get(k))


def model_mesh(data: int, model: int, pod: int, device):
    """The mesh the flags ask for (None for one device): one card a
    position where there are enough, else virtual shards of ``device``."""
    import torch

    from repro_torch.launch.mesh import make_debug_mesh, make_mesh
    if max(data, model, pod) <= 1:
        return None
    n = data * model * max(pod, 1)
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n:
        return make_mesh([torch.device("cuda", i) for i in range(n)], data,
                         model, pod)
    return make_debug_mesh(data, model, pod, device=dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-tiny")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--pod-mesh", type=int, default=0)
    ap.add_argument("--recommended", action="store_true",
                    help="apply the RECOMMENDED overrides of the registry")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.registry import get_config, get_recommended_config
    from repro_torch.data.pipeline import DataPlane, PipelineConfig
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault import Watchdog
    from repro_torch.train.optim import Schedule
    from repro_torch.train.step import (checkpoint_tree, init_state,
                                        make_train_step, restore_state)

    cfg = (get_recommended_config(args.arch) if args.recommended
           else get_config(args.arch))
    sched = Schedule(peak_lr=3e-3, warmup_steps=10, decay_steps=args.steps)
    data = DataPlane(PipelineConfig(seq_len=args.seq, batch_size=args.batch,
                                    vocab=cfg.vocab, dedup=True,
                                    device=args.device))
    step_fn = make_train_step(cfg, sched,
                              num_microbatches=cfg.num_microbatches)
    mesh = model_mesh(args.data_mesh, args.model_mesh, args.pod_mesh,
                      args.device)
    if mesh is not None:
        print(f"mesh: {mesh}")
    home = mesh.home if mesh is not None else args.device
    gen = torch.Generator(device=home).manual_seed(0)
    state = init_state(gen, cfg, sched, args.device, mesh=mesh)
    start = 0
    if args.resume and ckpt.latest_step(args.ckpt_dir) is not None:
        start = restore_state(state, args.ckpt_dir)
        print(f"resumed from step {start}")

    wd = Watchdog()
    before = storage_pointers(state)
    for step in range(start, args.steps):
        wd.start()
        state, metrics = step_fn(state, data.next_batch(step))
        loss = float(metrics["loss"])
        dt = wd.stop(step)
        if step == start:
            lost = moved(before, state)
            if lost:
                print(f"warning: the step did NOT update the state in "
                      f"place ({len(lost)} tensors moved, e.g. {lost[0]}) "
                      f"— expect double-buffered optimizer state")
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:8.4f} {dt*1e3:8.1f} ms "
                  f"(stragglers so far: {len(wd.stragglers)})")
        if (step + 1) % args.ckpt_every == 0:
            ckpt.save_async(checkpoint_tree(state), args.ckpt_dir, step + 1)
    ckpt.flush()
    print(f"done. data plane: {data.telemetry()}")


if __name__ == "__main__":
    main()
