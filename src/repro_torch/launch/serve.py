"""Serving CLI: batched generation with the hash-based sampler.

  python -m repro_torch.launch.serve --arch paper-tiny --batch 4 \
      --max-new 32 --no-repeat-ngram 3 [--no-smoke] [--device cuda]

The flags of the reference's ``repro.launch.serve`` plus ``--device``
(default ``cuda``) and ``--no-smoke`` (the published widths; the reference
always runs the reduced config). Weights are random, from a seeded
``torch.Generator``.
"""
import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-tiny")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True, help="use the reduced config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--no-repeat-ngram", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.nn import lm
    from repro_torch.serve.engine import SamplerConfig, ServeEngine

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    params = lm.init(0, cfg, device=args.device)
    eng = ServeEngine(cfg, params, SamplerConfig(
        temperature=args.temperature, top_k=args.top_k,
        no_repeat_ngram=args.no_repeat_ngram))
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen)
    if params.embed.table.is_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, stats = eng.generate(prompts, args.max_new)
    dt = time.perf_counter() - t0
    toks = args.batch * args.max_new
    print(f"{cfg.name} on {args.device}: generated {toks} tokens in "
          f"{dt:.2f}s ({toks / dt:.1f} tok/s), "
          f"{stats['banned_candidates']} candidates banned by the "
          f"rolling-hash filter")
    for b in range(min(args.batch, 2)):
        print(f"seq {b}:", out[b].tolist())


if __name__ == "__main__":
    main()
