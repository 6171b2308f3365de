"""End-to-end training on the port: the hash-deduped data plane -> LM ->
AdamW, with checkpoints and recovery from an injected failure
(``examples/train_lm.py`` through ``repro_torch``). On a card the data
plane's dedup and stats run the plan kernel; ``--device cpu`` runs its
plain version.

Run: PYTHONPATH=src python examples/train_lm_torch.py [--device cpu]
       [--steps N] [--batch B] [--seq S]
The ~100M-parameter configuration:
    PYTHONPATH=src python examples/train_lm_torch.py --preset 100m --steps 300
"""
import argparse
import os
import shutil
import tempfile

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import PipelineConfig
from repro_torch.train.fault import FailureInjector
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.optim import Schedule

TINY = ModelConfig(
    name="demo-6m", n_layers=4, d_model=256, vocab=8192, n_heads=4,
    n_kv_heads=2, head_dim=64, d_ff=1024, unit=(LayerSpec("attn", "dense"),),
    q_chunk=128, kv_chunk=128, param_dtype="float32",
    activation_dtype="float32")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--preset", default="demo", choices=["demo", "100m"])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available (pass "
                         "--device cpu to run on the CPU)")
    cfg = TINY if args.preset == "demo" else get_config("paper-tiny")
    if args.preset == "100m":
        args.seq, args.batch = 1024, 8
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    pipe = PipelineConfig(seq_len=args.seq, batch_size=args.batch,
                          vocab=cfg.vocab, dedup=True, seed=0,
                          device=args.device)
    loop = LoopConfig(n_steps=args.steps,
                      ckpt_every=max(1, min(25, args.steps // 4)),
                      ckpt_dir=args.ckpt_dir,
                      log_every=max(1, min(10, args.steps // 4)))
    sched = Schedule(peak_lr=3e-3 if args.preset == "demo" else 6e-4,
                     warmup_steps=min(20, max(1, args.steps // 4)),
                     decay_steps=args.steps)
    injector = FailureInjector(fail_at_steps=(args.steps // 2,))

    print(f"model={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"steps={args.steps} batch={args.batch}x{args.seq} on "
          f"{args.device}")
    res = train(cfg, pipe, loop, schedule=sched, injector=injector)

    tail = res["losses"][-max(1, min(10, args.steps // 4)):]
    first, last = res["losses"][0], sum(tail) / len(tail)
    print(f"\nloss {first:.3f} -> {last:.3f}  "
          f"(restarts={res['restarts']}, stragglers="
          f"{len(res['stragglers'])})")
    print("data plane:", res["telemetry"])
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    assert last < first, "training must reduce the loss"
    assert res["restarts"] >= 1, "the failure-recovery path must have fired"
    print("OK")


if __name__ == "__main__":
    main()
