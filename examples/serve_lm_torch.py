"""Batched serving with the rolling-hash no-repeat-ngram sampler, on the
port (``examples/serve_lm.py`` through ``repro_torch``). On a card each
decode step's bans go through the fused decode kernel; ``--device cpu``
runs its plain version.

Run: PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
       [--steps N]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.nn import lm
from repro_torch.serve.engine import SamplerConfig, ServeEngine


def repeated_ngrams(row, n=3) -> int:
    grams = [tuple(row[i:i + n]) for i in range(len(row) - n + 1)]
    return len(grams) - len(set(grams))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=32,
                    help="tokens each sequence generates")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available (pass "
                         "--device cpu to run on the CPU)")
    cfg = get_config("paper-tiny").smoke()
    params = lm.init(0, cfg, args.device)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, size=(4, 8))
    print(f"serving {cfg.name}-smoke on {args.device}: batch=4, "
          f"prompt_len=8, greedy decode\n")

    plain = ServeEngine(cfg, params, SamplerConfig(temperature=0.0))
    out_plain, _ = plain.generate(prompts, args.steps)
    guarded = ServeEngine(cfg, params,
                          SamplerConfig(temperature=0.0, no_repeat_ngram=3))
    out_guard, stats = guarded.generate(prompts, args.steps)

    for b in range(4):
        print(f"seq {b}: unconstrained repeats "
              f"{repeated_ngrams(out_plain[b])} 3-grams; with hash filter "
              f"{repeated_ngrams(out_guard[b])}")
    print(f"\ncandidates banned by the rolling-hash filter: "
          f"{stats['banned_candidates']}")
    t = stats["telemetry"]
    print(f"decode-plane telemetry: banned_rate={t['banned_rate']:.2e} "
          f"bloom_fill_mean={t['bloom_fill_mean']:.4f} "
          f"pool dispatches={t['dispatches']}")
    assert all(repeated_ngrams(out_guard[b]) == 0 for b in range(4))
    print("OK: no 3-gram repeated under the filter")


if __name__ == "__main__":
    main()
