"""Streaming corpus telemetry — the paper's §2 application.

Per training batch, on the card: rolling hashes -> HyperLogLog
distinct-n-gram registers + CountMin heavy-hitter counts. The state is a
small dict (registers, table, token count) that lives beside the train
state.

Both sketches ride the plan engine in ONE pass: a two-sketch (HLL +
CountMin) :class:`SketchPlan` is built once and executed per batch with
:func:`repro_torch.kernels.api.run` — on CUDA one launch of the plan kernel
does the rolling hash, the Theorem-1 discard, the register maxima and the
CountMin counts, with the running state carried in as each sketch's
``init``. :meth:`NgramStats.heavy_hitter_count` queries through the plain
window-hash kernels (``ops.cyclic`` / ``ops.general``) with the same hash
spec, so query columns cannot drift from update columns.

The families outside the fused engine (THREEWISE, ID37, BUFFERED-GENERAL)
take the unfused path, as the JAX package's do: the window hashes are
materialised by the family itself and folded by the plain
``HyperLogLog.update`` and ``CountMinSketch.add`` (no plan, no kernel); the
stream API needs a fused family.

The token counter accumulates as a uint32 (lo, hi) pair on the host, exact
past 2^32 tokens. :meth:`NgramStats.export_stream` /
:meth:`~NgramStats.import_stream` snapshot an open stream together with
the draw it was accumulated under, in the JAX package's layout.

Multi-device updates: with ``mesh`` (a
:class:`~repro_torch.kernels.shard.DataMesh`) or ``StatsConfig.data_shards``
the batch pass runs through :func:`repro_torch.kernels.shard.run_auto`
(rows split over the shards, the registers merged by max and the tables by
addition) and the streams are row-sharded over the mesh; an exported
stream imports onto any shard count. The state is the same bits at any
count.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import CountMinSketch, HyperLogLog, make_family, u32
from repro_torch.kernels import api, ops, shard, stream
from repro_torch.kernels.plan import CountMinSpec, HashSpec, HLLSpec, SketchPlan


@dataclasses.dataclass
class StatsConfig:
    ngram_n: int = 8
    L: int = 32
    hll_b: int = 12
    cms_depth: int = 4
    cms_log2_width: int = 16
    vocab: int = 1 << 17
    seed: int = 11
    family: str = "cyclic"       # rolling family: cyclic | general (fused);
                                 # other paper families take the unfused path
    impl: str = "auto"           # kernel dispatch: auto | kernel | ref
    # shard the per-batch sketch pass and the streams over this many
    # shards (None = one device)
    data_shards: Optional[int] = None
    device: str = "cuda"


def _hash_spec(family: str, n: int, L: int) -> Optional[HashSpec]:
    """The fused engine's HashSpec for the family, or None (unfused)."""
    if family == "cyclic":
        return HashSpec(family="cyclic", n=n, L=L, discard=True)
    if family == "general":
        return HashSpec(family="general", n=n, L=L)
    return None


def _add_tokens(tokens_state: np.ndarray, added: int) -> np.ndarray:
    """(lo, hi) uint32 pair + a batch's token count, with carry."""
    total = NgramStats.token_count({"tokens": tokens_state}) + int(added)
    return np.array([total & 0xFFFFFFFF, (total >> 32) & 0xFFFFFFFF],
                    np.uint32)


class NgramStats:
    def __init__(self, cfg: StatsConfig = None, mesh=None):
        self.cfg = cfg = cfg or StatsConfig()
        self.device = torch.device(cfg.device)
        # an explicit mesh wins over cfg.data_shards
        self.mesh = shard.resolve(mesh, cfg.data_shards, self.device)
        gen = torch.Generator().manual_seed(cfg.seed)
        self.fam = make_family(cfg.family, n=cfg.ngram_n, L=cfg.L)
        self.fp = self.fam.init(gen, cfg.vocab, self.device)
        self.hll = HyperLogLog(b=cfg.hll_b, hash_bits=self.fam.out_bits)
        self.cms = CountMinSketch(depth=cfg.cms_depth,
                                  log2_width=cfg.cms_log2_width)
        self._cms_params = self.cms.init(gen, self.device)
        # the fused HLL + CountMin plan, built once: one plan execution per
        # batch is the whole sketch data plane (None: the unfused path)
        hs = _hash_spec(cfg.family, cfg.ngram_n, cfg.L)
        self.plan = None
        if hs is not None:
            self.plan = SketchPlan(
                hs, (("hll", HLLSpec(b=cfg.hll_b)),
                     ("cms", CountMinSpec(depth=cfg.cms_depth,
                                          log2_width=cfg.cms_log2_width))))
            # Theorem-1 consistency: the plan's post-discard width is the
            # hash_bits the HLL's rank extraction assumes
            assert self.plan.hash.out_bits == self.hll.hash_bits, (
                self.plan.hash.out_bits, self.hll.hash_bits)

    def _lookup(self, tokens) -> torch.Tensor:
        """Token ids -> h1 values (uint32, masked to L bits) on the
        device."""
        return self.fam._lookup(self.fp, stream.stage(tokens, self.device))

    def _cms_ops(self) -> Dict:
        return {"a": self._cms_params["a"], "b": self._cms_params["b"]}

    def init_state(self) -> Dict:
        return {"hll": self.hll.init(self.device),
                "cms": self._cms_params["table"].clone(),
                "tokens": np.zeros((2,), np.uint32)}

    @staticmethod
    def token_count(state: Dict) -> int:
        """Total tokens seen, as an exact Python int (safe past 2^32)."""
        t = np.asarray(state["tokens"], np.uint32)
        return (int(t[1]) << 32) | int(t[0])

    def _unfused_hashes(self, tokens) -> torch.Tensor:
        """The unfused families' masked window hashes — the one definition
        the update and the query share, so the two cannot drift."""
        t = stream.stage(tokens, self.device)
        h = self.fam.hash_windows_batched(self.fp, t)
        if hasattr(self.fam, "pairwise_bits"):
            h = self.fam.pairwise_bits(h)
        return h

    def update(self, state: Dict, tokens) -> Dict:
        """Fold a (B, S) token batch into the state: ONE plan execution
        (one kernel launch on CUDA) with the registers and table carried
        in; for an unfused family the plain HLL and CountMin updates of
        the family's window hashes."""
        n_tok = int(np.prod(tuple(tokens.shape)))
        if self.plan is None:
            h = self._unfused_hashes(tokens).reshape(-1)
            cms = self.cms.add({**self._cms_params, "table": state["cms"]},
                               h)["table"]
            return {"hll": self.hll.update(state["hll"], h), "cms": cms,
                    "tokens": _add_tokens(state["tokens"], n_tok)}
        h1v = self._lookup(tokens)
        out = shard.run_auto(self.plan, h1v,
                             operands={"hll": {"init": state["hll"]},
                                       "cms": {**self._cms_ops(),
                                               "init": state["cms"]}},
                             impl=self.cfg.impl, mesh=self.mesh)
        return {"hll": out["hll"], "cms": out["cms"],
                "tokens": _add_tokens(state["tokens"], n_tok)}

    # -- streaming (unbounded token streams, fixed chunk shape) ------------

    def init_stream(self, batch: int, state: Optional[Dict] = None) -> Dict:
        """Open ``batch`` parallel token streams, continuing from ``state``
        (default: a fresh :meth:`init_state`). The rolling-hash tail and
        the sketch states carry across chunks, so an n-gram spanning two
        chunks of a stream is still counted. Fused families only."""
        if self.plan is None:
            raise ValueError(
                f"streaming stats needs a fused family (cyclic|general), "
                f"not {self.cfg.family!r}")
        state = state or self.init_state()
        sstate = stream.init_state(
            self.plan, batch, carry={"hll": state["hll"],
                                     "cms": state["cms"]},
            device=self.device, mesh=self.mesh)
        return {"stream": sstate, "tokens": state["tokens"],
                "batch": int(batch)}

    @staticmethod
    def _added(tokens, lengths) -> int:
        return (int(np.prod(tuple(tokens.shape))) if lengths is None
                else int(np.sum(np.asarray(
                    lengths.cpu() if isinstance(lengths, torch.Tensor)
                    else lengths, np.int64))))

    def _step(self, sstate: Dict, tokens, lengths, fn) -> Dict:
        st = fn(self.plan, sstate["stream"], self._lookup(tokens),
                lengths=lengths, operands={"cms": self._cms_ops()},
                impl=self.cfg.impl)
        return {**sstate, "stream": st,
                "tokens": _add_tokens(sstate["tokens"],
                                      self._added(tokens, lengths))}

    def update_stream(self, sstate: Dict, tokens, lengths=None) -> Dict:
        """Fold one (B, C) token chunk into the stream (rows advance
        independently; ``lengths`` marks the real symbols per row)."""
        return self._step(sstate, tokens, lengths, stream.update)

    def update_stream_many(self, sstate: Dict, tokens, lengths=None) -> Dict:
        """Fold a (T, B, C) block of T chunks into the stream: on CUDA one
        graph replay of T plan launches (``stream.update_many``),
        bit-identical to T :meth:`update_stream` calls."""
        return self._step(sstate, tokens, lengths, stream.update_many)

    def finalize_stream(self, sstate: Dict) -> Dict:
        """Close the stream into an ordinary stats state (the carried
        registers and table ARE the running state)."""
        out = stream.finalize(self.plan, sstate["stream"])
        return {"hll": out["hll"], "cms": out["cms"],
                "tokens": sstate["tokens"]}

    # -- parameters ---------------------------------------------------------

    def export_params(self) -> Dict:
        """The sampled draw every estimate depends on (h1 table, CountMin
        row constants and initial table) as host numpy arrays;
        :meth:`rebind_params` is its inverse."""
        host = lambda tree: {k: v.cpu().numpy() for k, v in tree.items()}
        return {"fam": host(self.fp), "cms": host(self._cms_params)}

    def rebind_params(self, params: Dict) -> None:
        """Adopt another draw (before any state import): ``{"fam": {"h1"},
        "cms": {"a", "b", "table"}}`` as tensors
        (:func:`repro_torch.convert.stats_params_from_jax`) or arrays."""
        self.fp = {k: api.as_u32(v, self.device).contiguous()
                   for k, v in params["fam"].items()}
        cms = params["cms"]
        self._cms_params = {
            "a": api.as_u32(cms["a"], self.device).contiguous(),
            "b": api.as_u32(cms["b"], self.device).contiguous(),
            "table": api.as_i32(cms["table"], self.device).contiguous()}

    def export_stream(self, sstate: Dict) -> Dict:
        """Snapshot an open stream and the draw it was accumulated under as
        one host numpy tree (the JAX package's layout): ``params``,
        ``stream`` (``stream.export_state``) and ``tokens``. The params
        must persist with the state: register indices and table columns
        are functions of this draw."""
        return {"params": self.export_params(),
                "stream": stream.export_state(self.plan, sstate["stream"],
                                              batch=sstate.get("batch")),
                "tokens": np.asarray(sstate["tokens"], np.uint32).copy()}

    def import_stream(self, tree: Dict) -> Dict:
        """Rebuild a live stream state on this instance's device (or mesh:
        the exported tree is unpadded and imports onto any shard count)
        from :meth:`export_stream`'s tree (this package's or the JAX
        package's): the params are re-bound first, then the carry."""
        self.rebind_params(tree["params"])
        sstate = stream.import_state(self.plan, tree["stream"],
                                     device=self.device, mesh=self.mesh)
        return {"stream": sstate,
                "tokens": np.asarray(tree["tokens"], np.uint32).copy(),
                "batch": int(np.asarray(tree["stream"]["seen"]).shape[0])}

    # -- queries ------------------------------------------------------------

    def distinct_ngrams(self, state: Dict) -> float:
        return float(self.hll.estimate(state["hll"]))

    def query_hashes(self, tokens) -> torch.Tensor:
        """(..., S) tokens -> (..., S-n+1) masked window hashes, the ones
        the update feeds to CountMin: through the plain window-hash
        kernels for a fused family, the family's own hashes otherwise."""
        if self.plan is None:
            return self._unfused_hashes(tokens)
        h1v = self._lookup(tokens)
        hs = self.plan.hash
        if hs.family == "cyclic":
            h = ops.cyclic(h1v, n=hs.n, L=hs.L, impl=self.cfg.impl)
        else:
            h = ops.general(h1v, n=hs.n, p=hs.p, L=hs.L, impl=self.cfg.impl)
        return (u32.lanes(h) & hs.hash_mask).to(torch.uint32)

    def heavy_hitter_count(self, state: Dict, tokens) -> np.ndarray:
        """Estimated frequency of the first window of each given sequence."""
        h = self.query_hashes(tokens)
        return self.cms.query({**self._cms_params, "table": state["cms"]},
                              h[..., 0]).cpu().numpy()
