"""Near-duplicate removal: ``MinHashDeduper.add_batch`` over a ``documents``
mix, in a closed loop of one client.

Set-up makes the parameters from the seed on the device (the h1 table and
the MinHash lanes, handed in through ``import_params``), starts the
generator process and signs warm-up documents of every block length the
signing path uses. On the card the process keeps one intra-op thread, so
that a run loads the host with its one Python thread and the generator.
The window hands one batch at a time to ``add_batch`` and times each call,
from the hand-over until the flags are on the host. ``signature_many`` is
wrapped so that its time and its signatures are kept: the signatures are
what the verdict reference reads.

Judged once the window has closed: the signature of every document of the
window against the reference's, and every verdict against the reference's
verdicts over the reference's own signatures; and every document
answered.
"""
from __future__ import annotations

import contextlib
import fcntl
import gc
import json
import os
import subprocess
import sys
import time
from typing import Dict, List

import numpy as np

from bench import generate, roofline
from bench.reference import dedup as ref
from bench.reference.hashing import random_u32, to_u32

TAG_PARAMS = 11


def make_params(seed: int, settings: dict, device) -> Dict:
    """The h1 table and the MinHash lanes (``a`` odd) as int64 lanes, drawn
    on ``device`` in three calls."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(int(generate.rng_for(seed, TAG_PARAMS).integers(1 << 62)))
    k = settings["n_signatures"]
    return {"h1": random_u32(gen, (settings["vocab"],), device),
            "a": random_u32(gen, (k,), device) | 1,
            "b": random_u32(gen, (k,), device)}


class Feed:
    """Batches of a ``documents`` mix from the generator process, read from
    its standard output between calls. The pipe holds 1 MiB, so the
    generator writes the next batch while the current one is in the
    program, and no thread of this process competes with the program for
    the interpreter."""

    def __init__(self, root, mix: dict, seed: int):
        self.proc = subprocess.Popen(
            [sys.executable, str(root / "bench" / "generate.py"),
             json.dumps(mix), str(int(seed))],
            stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
            env={**os.environ, "OMP_NUM_THREADS": "1"})
        with contextlib.suppress(OSError, AttributeError):
            fcntl.fcntl(self.proc.stdout.fileno(), fcntl.F_SETPIPE_SZ, 1 << 20)

    def get(self) -> List[np.ndarray]:
        batch = generate.read_batch(self.proc.stdout)
        if batch is None:
            raise RuntimeError(f"the generator stopped (exit "
                               f"{self.proc.poll()})")
        return batch

    def cpu_s(self) -> float:
        """The generator's CPU seconds so far."""
        try:
            with open(f"/proc/{self.proc.pid}/stat") as f:
                parts = f.read().rsplit(")", 1)[1].split()
            return (int(parts[11]) + int(parts[12])) / os.sysconf("SC_CLK_TCK")
        except (OSError, IndexError, ValueError):
            return float("nan")

    def close(self) -> None:
        self.proc.kill()
        self.proc.stdout.close()
        self.proc.wait()


def host_clocks() -> Dict[str, float]:
    """This thread's and this process's CPU seconds so far."""
    return {"thread": time.thread_time(), "process": time.process_time()}


def program(ctx, settings: dict, params: Dict):
    """The program's deduper with the benchmark's parameters."""
    from repro_torch.data.dedup import DedupConfig, MinHashDeduper
    dd = MinHashDeduper(DedupConfig(**settings, impl=ctx.impl,
                                    device=str(ctx.device)))
    dd.import_params({"fam": {"h1": to_u32(params["h1"])},
                      "mh": {"a": to_u32(params["a"]),
                             "b": to_u32(params["b"])}})
    return dd


def warm_up(ctx, dd) -> None:
    """Sign documents of 1 to 2 x stream_block_chunks chunks, a group of
    stream_rows each: every block shape the signing path can use is built
    before the window."""
    cfg = getattr(dd, "cfg", None)
    if cfg is None:                 # a stand-in of the program
        return
    docs = generate.warm_documents(ctx.seed, cfg.vocab, cfg.stream_rows,
                                   cfg.stream_chunk_s,
                                   range(1, 2 * cfg.stream_block_chunks + 1))
    dd.signature_many(docs)


def _stand_in(discard: bool = True, verify: bool = True):
    def make(ctx, params):
        s = ctx.config["settings"]
        return ref.ReferenceDeduper(params, s["ngram_n"], s["L"],
                                    s["lsh_bands"], s["threshold"],
                                    discard=discard, verify=verify)
    return make


# the reference in the program's place: sound, and with a guarantee of the
# configuration broken (the Theorem-1 discard; the verify of candidates)
CONTROLS = {"reference": _stand_in(),
            "no_discard": _stand_in(discard=False),
            "no_verify": _stand_in(verify=False)}


def run(ctx) -> Dict:
    settings = ctx.config["settings"]
    n, L, k = settings["ngram_n"], settings["L"], settings["n_signatures"]
    if ctx.cuda:
        # the host's work is one Python thread's; a pool of intra-op threads
        # would only copy 1 MiB blocks, and between copies its idle threads
        # spin: with 8 threads the process kept 6.5 cores busy
        ctx.torch.set_num_threads(1)
    feed = Feed(ctx.root, ctx.traffic, ctx.seed)
    try:
        params = make_params(ctx.seed, settings, ctx.device)
        dd = ctx.make_program(lambda: program(ctx, settings, params), params)
        ctx.mark("parameters and the program")
        warm_up(ctx, dd)
        ctx.synchronize()
        ctx.mark("warm-up")

        sign_s: List[float] = []
        feed_s = 0.0
        sigs: List[np.ndarray] = []
        signature_many = dd.signature_many

        def timed_signature_many(docs):
            with ctx.tracer.span("sign"):
                t = time.perf_counter()
                out = signature_many(docs)
                sign_s.append(time.perf_counter() - t)
            sigs.append(out)
            return out

        dd.signature_many = timed_signature_many
        batches: List[List[np.ndarray]] = []
        flags: List[np.ndarray] = []
        call_s: List[float] = []
        gc_s = [0.0, 0]

        def gc_timer(phase, info):
            gc_s[0] += time.perf_counter() * (1 if phase == "stop" else -1)
            gc_s[1] += phase == "stop"

        gc.callbacks.append(gc_timer)
        launches = ctx.launches()
        clocks, gen_cpu = host_clocks(), feed.cpu_s()
        with ctx.window() as w:
            while not w.done(len(batches)):
                t = time.perf_counter()
                docs = feed.get()
                feed_s += time.perf_counter() - t
                with ctx.tracer.span("add_batch"):
                    t = time.perf_counter()
                    got = dd.add_batch(docs)
                    call_s.append(time.perf_counter() - t)
                batches.append(docs)
                flags.append(np.asarray(got))
        launches = ctx.launches() - launches
        clocks = {k: v - clocks[k] for k, v in host_clocks().items()}
        gen_cpu = feed.cpu_s() - gen_cpu
        gc.callbacks.remove(gc_timer)
        ctx.read_memory_peak()
    finally:
        feed.close()
    if hasattr(dd, "close"):
        dd.close()
    del dd
    ctx.free()

    docs = [d for b in batches for d in b]
    lens = np.asarray([d.shape[0] for d in docs], np.int64)
    windows = np.maximum(lens - n + 1, 0)
    plan = ("cyclic", n, L, (("minhash", k),))
    nbytes = (4 * lens.sum() + 4 * len(docs) * k
              + len(batches) * 4 * (settings["vocab"] + 2 * k))
    bound_s, _ = roofline.bound(plan, float(windows.sum()), float(nbytes))
    tenths = [f"{np.median(part) * 1e3:.1f}"
              for part in np.array_split(np.asarray(call_s), 10) if part.size]
    ctx.note(f"{len(call_s)} calls, median ms by tenth of the window: "
             f"{' '.join(tenths)}; tokens a call {lens.sum() / len(call_s):.0f}; "
             f"in add_batch {sum(call_s):.3f} s, reading the feed "
             f"{feed_s:.3f} s; {gc_s[1]} garbage collections {gc_s[0]:.3f} s")
    ctx.note(f"CPU seconds in the window: this thread {clocks['thread']:.3f}, "
             f"the process {clocks['process']:.3f}, the generator "
             f"{gen_cpu:.3f}; {os.cpu_count()} cores, "
             f"{ctx.torch.get_num_threads()} intra-op threads")
    checks = judge(ctx, settings, params, batches, flags, sigs, lens, windows)
    return {"attempted": len(docs),
            "failed": checks["docs_unanswered"][0],
            "tokens": int(lens.sum()), "docs": len(docs),
            "calls_s": call_s, "sign_s": sign_s, "launches": launches,
            "bound_s": bound_s, "checks": checks}


def judge(ctx, settings, params, batches, flags, sigs, lens, windows) -> Dict:
    """The numbers compared, each as (value, limit)."""
    n, L = settings["ngram_n"], settings["L"]
    N = lens.shape[0]
    got = np.full(N, -1, np.int8)          # -1: no verdict came
    at = 0
    for docs, f in zip(batches, flags):
        m = min(len(docs), f.shape[0])
        got[at : at + m] = f[:m]
        at += len(docs)
    unanswered = int((got < 0).sum())
    # the program's signatures, one row a document, in stream order
    program_sigs = (np.concatenate(sigs) if sigs
                    else np.zeros((0, settings["n_signatures"]), np.uint32))
    unread = int(program_sigs.shape[0] != N)
    t = time.perf_counter()
    docs = [d for b in batches for d in b]
    want = ref.signatures(docs, params, n, L)
    expect = ref.verdicts(want, settings["lsh_bands"], settings["threshold"])
    sig_off = (N if unread
               else int((want != program_sigs).any(axis=1).sum()))
    verdict_off = int(((got >= 0) & (got != expect)).sum())
    ctx.note(f"reference: {N} documents ({int(windows.sum())} windows) "
             f"signed and judged in {time.perf_counter() - t:.3f} s; its "
             f"verdicts flag {int(expect.sum())}, the program's "
             f"{int((got == 1).sum())}")
    return {"docs_unanswered": (unanswered, 0),
            "signatures_unread": (unread, 0),
            "signature_docs_off": (sig_off, 0),
            "verdicts_off": (verdict_off, 0)}
