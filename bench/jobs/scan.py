"""The corpus scan: each ``token_blocks`` block through
``NgramStats.update_stream_many`` (a configuration's ``stats``) and then
``Decontaminator.update_stream_many`` (its ``decontam``) on the same host
block, the streams closed by ``finalize_stream``. A configuration gives
either half or both.

Set-up makes the parameters from the seed on the device (the h1 tables,
the CountMin lanes, the eval filter of the configuration's eval set,
handed in through ``rebind_params``), makes the pool of host blocks and
runs one block through the program on throwaway streams, so that the
window's block shapes are built. The window cycles the pool; the scan's
blocks are asynchronous, so its one latency is the whole window, which
ends when the sketches and the fractions are on the host.

Judged once the window has closed, against the reference's scan of the
same blocks: the token count, every HLL register and every CountMin cell
(``stats``), every row's hit fraction (``decontam``).
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np

from bench import generate, roofline
from bench.reference import scan as ref
from bench.reference.hashing import random_u32, to_u32

TAG_PARAMS = 12


def make_params(seed: int, cfg: dict, device) -> Dict:
    """The stats h1 table and CountMin lanes (``a`` odd) and the decontam
    pair of h1 tables, as int64 lanes drawn on ``device`` (each half's,
    where the configuration gives it); then the eval filter of the
    configuration's eval set."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(int(generate.rng_for(seed, TAG_PARAMS).integers(1 << 62)))
    st, dc = cfg.get("stats"), cfg.get("decontam")
    params, evals = {}, None
    if st:
        tables = random_u32(gen, (1, st["vocab"]), device)
        params.update(h1_stats=tables[0],
                      cms_a=random_u32(gen, (st["cms_depth"],), device) | 1,
                      cms_b=random_u32(gen, (st["cms_depth"],), device))
    if dc:
        ev = cfg["eval"]
        tables = random_u32(gen, (2, dc["vocab"]), device)
        params.update(h1_a=tables[0], h1_b=tables[1])
        evals = generate.eval_passages(seed, ev.get("vocab", dc["vocab"]),
                                       ev["zipf_alpha"], ev["passages"],
                                       ev["passage_tokens"])
        params["bits"] = ref.bloom_words(evals, params["h1_a"],
                                         params["h1_b"], dc["ngram_n"],
                                         dc["L"], dc["log2_m"], dc["k"])
    return params, evals


class Program:
    """The program's stats and decontam instances with the benchmark's
    parameters, as one scan: each half that the configuration gives."""

    def __init__(self, ctx, cfg: dict, params: Dict):
        import torch
        dev = str(ctx.device)
        st, dc = cfg.get("stats"), cfg.get("decontam")
        # a cell of several cards row-shards the streams over all of them
        shards = ctx.chips if ctx.chips > 1 else None
        self.ng = self.dc = None
        if st:
            from repro_torch.data.stats import NgramStats, StatsConfig
            self.ng = NgramStats(StatsConfig(**st, impl=ctx.impl, device=dev,
                                             data_shards=shards))
            table = torch.zeros((st["cms_depth"], 1 << st["cms_log2_width"]),
                                dtype=torch.int32, device=ctx.device)
            self.ng.rebind_params({"fam": {"h1": to_u32(params["h1_stats"])},
                                   "cms": {"a": to_u32(params["cms_a"]),
                                           "b": to_u32(params["cms_b"]),
                                           "table": table}})
        if dc:
            from repro_torch.data.decontam import (Decontaminator,
                                                   DecontamConfig)
            self.dc = Decontaminator(DecontamConfig(**dc, impl=ctx.impl,
                                                    device=dev,
                                                    data_shards=shards))
            self.dc.rebind_params({"pa": {"h1": to_u32(params["h1_a"])},
                                   "pb": {"h1": to_u32(params["h1_b"])},
                                   "bits": to_u32(params["bits"])})

    def open(self, rows: int) -> None:
        self.ss = self.ng.init_stream(rows) if self.ng is not None else None
        self.ds = self.dc.init_stream(rows) if self.dc is not None else None

    def update(self, block: np.ndarray) -> None:
        if self.ng is not None:
            self.ss = self.ng.update_stream_many(self.ss, block)
        if self.dc is not None:
            self.ds = self.dc.update_stream_many(self.ds, block)

    def close(self) -> Dict:
        """The closed streams on the host: the token count, and registers
        and table (stats) and each row's hit fraction (decontam)."""
        got = {}
        if self.ng is not None:
            out = self.ng.finalize_stream(self.ss)
            got.update(hll=out["hll"].cpu().numpy(),
                       cms=out["cms"].cpu().numpy(),
                       tokens=int(self.ng.token_count(out)))
        if self.dc is not None:
            got["fractions"] = np.asarray(self.dc.finalize_stream(self.ds))
            # the symbols the decontam streams took in, row by row
            got.setdefault("tokens", int(np.sum(self.ds["seen"])))
        return got


class StandIn:
    """The reference in the program's place (a control)."""

    def __init__(self, scan: "ref.ReferenceScan"):
        self.scan = scan
        self.fresh = scan

    def open(self, rows: int) -> None:
        self.scan = ref.ReferenceScan(self.fresh.params, self.fresh.cfg,
                                      self.fresh.carry, self.fresh.discard)
        self.tokens = 0

    def update(self, block: np.ndarray) -> None:
        self.scan.update(block)
        self.tokens += block.size

    def close(self) -> Dict:
        s, got = self.scan.state, {"tokens": self.tokens}
        if "hll" in s:
            got.update(hll=s["hll"].cpu().numpy(), cms=s["cms"].cpu().numpy())
        if "hits" in s:
            got["fractions"] = ref.fractions(s["hits"].cpu().numpy(),
                                             s["windows"].cpu().numpy())
        return got


def _stand_in(carry: bool = True, discard: bool = True):
    def make(ctx, params):
        return StandIn(ref.ReferenceScan(params, ctx.config, carry=carry,
                                         discard=discard))
    return make


# the reference in the program's place: sound, and with a guarantee of the
# configuration broken (windows across blocks; the Theorem-1 discard)
CONTROLS = {"reference": _stand_in(),
            "no_carry": _stand_in(carry=False),
            "no_discard": _stand_in(discard=False)}


def run(ctx) -> Dict:
    cfg, mix = ctx.config, ctx.traffic
    params, evals = make_params(ctx.seed, cfg, ctx.device)
    ctx.mark("parameters and the eval filter")
    pool, planted = generate.token_pool(mix, ctx.seed, evals)
    P, T, B, C = pool.shape
    ctx.mark("the pool of blocks")
    prog = ctx.make_program(lambda: Program(ctx, cfg, params), params)
    ctx.mark("the program")
    # warm-up: the window's block shape through both, on throwaway streams
    prog.open(B)
    prog.update(pool[0])
    prog.close()
    ctx.synchronize()
    ctx.mark("warm-up")

    prog.open(B)
    fed = 0
    issued = []
    launches = ctx.launches()
    with ctx.window() as w:
        while not w.done(fed):
            with ctx.tracer.span("block"):
                prog.update(pool[fed % P])
            fed += 1
            issued.append(time.perf_counter())
        with ctx.tracer.span("finalize"):
            got = prog.close()
    launches = ctx.launches() - launches
    ctx.read_memory_peak()
    del prog
    ctx.free()

    gaps = np.diff(np.asarray(issued))
    ctx.note("host ms a block, median by tenth of the window: " + " ".join(
        f"{np.median(p) * 1e3:.3f}" for p in np.array_split(gaps, 10) if p.size))
    want = ref.scan(pool, fed, params, cfg)
    st, dc = cfg.get("stats"), cfg.get("decontam")
    windows = want["windows"].cpu().numpy()
    win = float(windows.sum())
    tokens = fed * T * B * C
    checks, bound_s = {"tokens_off": (abs(got["tokens"] - tokens), 0)}, 0.0
    if st:
        checks["hll_registers_off"] = (
            int((got["hll"] != want["hll"].cpu().numpy()).sum()), 0)
        checks["cms_cells_off"] = (
            int((got["cms"] != want["cms"].cpu().numpy()).sum()), 0)
        plan = ("cyclic", st["ngram_n"], st["L"],
                (("hll", st["hll_b"]), ("cms", st["cms_depth"])))
        state = 4 * ((1 << st["hll_b"])
                     + st["cms_depth"] * (1 << st["cms_log2_width"]))
        nbytes = fed * (4 * T * B * C + 4 * st["vocab"] + 2 * state)
        bound_s += roofline.bound(plan, win, nbytes)[0]
    if dc:
        expect = ref.fractions(want["hits"].cpu().numpy(), windows)
        flagged = expect > dc["max_hit_frac"]
        ctx.note(f"planted rows {len(planted)}, flagged by the reference "
                 f"{int(flagged.sum())} (planted {int(flagged[planted].sum())})"
                 f"; probes a window {want['probes'] / win:.4f}")
        checks["rows_off"] = (int((got["fractions"] != expect).sum()), 0)
        plan = ("cyclic", dc["ngram_n"], dc["L"], (("bloom", dc["k"]),))
        nbytes = fed * (4 * T * B * C + 8 * dc["vocab"] + 2 * 4 * B
                        + (1 << dc["log2_m"]) // 8)
        bound_s += roofline.bound(plan, win, nbytes, want["probes"] / win)[0]
    ctx.note(f"{fed} blocks of {T}x{B}x{C}")
    return {"attempted": fed, "failed": 0, "tokens": tokens, "docs": None,
            "calls_s": None, "sign_s": None, "launches": launches,
            "bound_s": bound_s, "checks": checks}
