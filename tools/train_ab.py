"""Time a training step of this checkout against another checkout's, and
Adafactor's update with a leaf's updates kept against recomputed, on one
card.

  python3 tools/train_ab.py --base DIR [--rounds 2] [--steps 6]
  python3 tools/train_ab.py --adafactor [--rounds 3]

``--base``: DIR is the root of another checkout of the repository (for
instance the parent commit unpacked with ``git archive`` into a directory
that ``.gitignore`` lists). Each side runs in a process of its own with
its checkout's ``src`` first on ``sys.path`` (both packages are named
``repro_torch``): ``chip_smoke.py``'s phase-13 model, qwen1.5-0.5b
recommended (float32 parameters, remat ``dots``, AdamW, one microbatch)
at (8, 1024), from seed 0 on random tokens from seed 0; two warm-up
steps, then ``--steps`` steps, each timed on the host's clock ending in a
synchronise. The sides run base, this, this, base, ``--rounds`` times;
each line gives a run's steps and median.

``--adafactor``: ``chip_smoke.py``'s phase-14 MoE, dbrx-132b at its
published widths cut to 2 layers, and Adafactor's update on random bf16
gradients from seed 0: with ``optim.RUN_NUMEL`` as shipped (a leaf of more
elements recomputes its updates in the second pass) and past every leaf
(every leaf keeps them), in turns (shipped, kept, kept, shipped,
``--rounds`` times), each update timed by CUDA events, with each side's
peak memory over its updates.

Each line names the card and its power limit.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TRAIN_ARCH, TRAIN_B, TRAIN_SEQ, WARM = "qwen1.5-0.5b", 8, 1024, 2
TRAIN_SCHEDULE = dict(peak_lr=1e-3, warmup_steps=4, decay_steps=12)
MOE_ARCH, MOE_LAYERS = "dbrx-132b", 2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def child(root: Path, steps: int) -> None:
    """One side of ``--base``: the step times of ``root``'s package, as a
    JSON line."""
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.train import optim
    from repro_torch.train import step as tstep

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = registry.get_recommended_config(TRAIN_ARCH)
    sched = optim.Schedule(**TRAIN_SCHEDULE)
    state = tstep.init_state(0, cfg, sched, device="cuda")
    fn = tstep.make_train_step(cfg, sched)
    rng = np.random.default_rng(0)
    ms = []
    for i in range(WARM + steps):
        batch = {"tokens": rng.integers(0, cfg.vocab, size=(
            TRAIN_B, TRAIN_SEQ)).astype(np.int32)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = fn(state, batch)
        loss = float(m["loss"])
        if i >= WARM:
            ms.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"ms": ms, "loss": loss,
                      "package": str(Path(optim.__file__).parents[2])}))


def base_ab(base: Path, rounds: int, steps: int, card: str) -> None:
    import numpy as np
    runs = {"base": [], "this": []}
    for _ in range(rounds):
        for side in ("base", "this", "this", "base"):
            root = base if side == "base" else ROOT
            out = subprocess.run(
                [sys.executable, __file__, "--child", str(root), "--steps",
                 str(steps)], capture_output=True, text=True, check=True,
                timeout=600)
            r = json.loads(out.stdout.strip().splitlines()[-1])
            runs[side].append(float(np.median(r["ms"])))
            print(f"train_ab[{side}]: {TRAIN_ARCH} recommended ({TRAIN_B}, "
                  f"{TRAIN_SEQ}) from {r['package']}: steps "
                  f"{[round(t, 2) for t in r['ms']]} ms, median "
                  f"{np.median(r['ms']):.2f} ms, loss {r['loss']:.6f} "
                  f"[{card}]", flush=True)
    b, t = (float(np.median(runs[k])) for k in ("base", "this"))
    print(f"train_ab: median of the runs' medians: base {b:.2f} ms, this "
          f"{t:.2f} ms, this / base {t / b:.4f}; runs base "
          f"{[round(x, 2) for x in runs['base']]}, this "
          f"{[round(x, 2) for x in runs['this']]} [{card}]")


def adafactor_ab(rounds: int, card: str) -> None:
    import dataclasses

    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import registry
    from repro_torch.nn import lm
    from repro_torch.train import optim

    dev = torch.device("cuda")
    cfg = dataclasses.replace(registry.get_recommended_config(MOE_ARCH),
                              n_layers=MOE_LAYERS)
    params = dict(lm.init(0, cfg, device=dev).named_parameters())
    gen = torch.Generator(dev).manual_seed(0)
    grads = {n: torch.randn(p.shape, dtype=p.dtype, device=dev,
                            generator=gen) for n, p in params.items()}
    opt = optim.make_optimizer("adafactor", optim.Schedule(**TRAIN_SCHEDULE))
    state = opt.init(params)
    shipped = optim.RUN_NUMEL
    groups = optim.stack_groups(params).values()
    past = [g for g in groups
            if sum(params[n].numel() for n in g) > shipped]
    times = {"recomputed": [], "kept": []}
    peaks = {"recomputed": 0, "kept": 0}
    step = 0
    for _ in range(rounds):
        for side in ("recomputed", "kept", "kept", "recomputed"):
            optim.RUN_NUMEL = shipped if side == "recomputed" else 1 << 62
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            opt.update(grads, state, params, step)
            b.record()
            torch.cuda.synchronize()
            step += 1
            times[side].append(a.elapsed_time(b))
            peaks[side] = max(peaks[side], torch.cuda.max_memory_allocated())
    optim.RUN_NUMEL = shipped
    r, k = (float(np.median(times[s])) for s in ("recomputed", "kept"))
    print(f"adafactor_ab: {MOE_ARCH} {MOE_LAYERS} layers, "
          f"{sum(p.numel() for p in params.values())} bf16 parameters, "
          f"{len(past)} of {len(groups)} leaves past RUN_NUMEL = {shipped} "
          f"elements ({sum(params[n].numel() for g in past for n in g)} "
          f"elements); one update: recomputed (as shipped) "
          f"{[round(t, 2) for t in times['recomputed']]} ms, median {r:.2f},"
          f" peak {peaks['recomputed'] / 2**30:.2f} GiB; kept "
          f"{[round(t, 2) for t in times['kept']]} ms, median {k:.2f}, peak "
          f"{peaks['kept'] / 2**30:.2f} GiB; the second pass's recompute "
          f"{r - k:.2f} ms an update [{card}]")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path)
    ap.add_argument("--adafactor", action="store_true")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.steps)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("train_ab: no CUDA device is available", file=sys.stderr)
        return 2
    card = card_line()
    if args.base:
        base_ab(args.base.resolve(), args.rounds, args.steps, card)
    if args.adafactor:
        adafactor_ab(args.rounds, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
