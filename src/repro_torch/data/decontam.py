"""Train/eval decontamination via Bloom-filtered n-gram membership.

Eval-set n-grams are fingerprinted (CYCLIC, Theorem-1 bits) into a Bloom
filter; training batches are scanned on the card and a sequence whose
share of hit windows exceeds ``max_hit_frac`` is flagged. The Bloom false
positive analysis assumes independent probe positions, supplied by two
independent CYCLIC draws feeding double hashing.

The scan runs behind a one-Bloom :class:`SketchPlan` built once: on CUDA
one launch of the plan kernel does both rolling hashes, the discard, the k
probes against the filter and the per-row hit counts, so only a (B,)
count vector leaves the kernel. Before it, a token block is staged on the
device once and both draws gather their h1 values from that one copy;
``impl="ref"`` keeps the plain version, one staging and one gather a draw.
A profiler that records sees the spans ``decontam.update`` (a stream's
chunk or block), ``decontam.lookup`` (the staging and the lookups) and
``decontam.finalize`` (:mod:`repro_torch.trace`). The eval-set add is a
plain torch OR-scatter (it runs once per eval set, not per batch).

:meth:`Decontaminator.export_stream` / :meth:`~Decontaminator.import_stream`
snapshot an open stream scan with both family draws and the filter, in
the JAX package's layout.

Multi-device scans: with ``mesh`` (a
:class:`~repro_torch.kernels.shard.DataMesh`) or
``DecontamConfig.data_shards`` the batch scan runs through
:func:`repro_torch.kernels.shard.run_auto` (rows split over the shards, the
filter copied to each device) and the streams are row-sharded; the counts
are the same bits at any shard count.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import BloomFilter, make_family
from repro_torch.kernels import api, shard, stream
from repro_torch.kernels.plan import BloomSpec, HashSpec, SketchPlan


@dataclasses.dataclass
class DecontamConfig:
    ngram_n: int = 8
    L: int = 32
    log2_m: int = 22
    k: int = 4
    vocab: int = 1 << 17
    max_hit_frac: float = 0.5    # flag a sequence when >50% of windows hit
    seed: int = 7
    impl: str = "auto"           # kernel dispatch: auto | kernel | ref
    # shard the scan over this many shards (None = one device): rows are
    # independent, the filter is copied to every device
    data_shards: Optional[int] = None
    device: str = "cuda"


class Decontaminator:
    def __init__(self, cfg: DecontamConfig, mesh=None):
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        # an explicit mesh wins over cfg.data_shards
        self.mesh = shard.resolve(mesh, cfg.data_shards, self.device)
        gen = torch.Generator().manual_seed(cfg.seed)
        self.fam_a = make_family("cyclic", n=cfg.ngram_n, L=cfg.L)
        self.fam_b = make_family("cyclic", n=cfg.ngram_n, L=cfg.L)
        self.pa = self.fam_a.init(gen, cfg.vocab, self.device)
        self.pb = self.fam_b.init(gen, cfg.vocab, self.device)
        self.bloom = BloomFilter(log2_m=cfg.log2_m, k=cfg.k)
        self.bits = self.bloom.init(self.device)
        self.plan = SketchPlan(
            HashSpec(family="cyclic", n=cfg.ngram_n, L=cfg.L, discard=True),
            (("bloom", BloomSpec(k=cfg.k, log2_m=cfg.log2_m)),))
        # Theorem-1 consistency: the scan's probes draw from exactly the
        # bits the eval-set add used
        assert self.plan.hash.out_bits == self.fam_a.out_bits, (
            self.plan.hash.out_bits, self.fam_a.out_bits)

    def _lookups(self, tokens) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both draws' h1 values of a token block. With ``impl="ref"`` the
        plain version: each draw stages its own copy of the block
        (:func:`repro_torch.kernels.stream.stage`) and gathers. Otherwise
        the block is staged on the device once and each draw gathers from
        that copy."""
        with trace.span("decontam.lookup"):
            if self.cfg.impl == "ref":
                return tuple(fam._lookup(p, stream.stage(tokens, self.device))
                             for fam, p in ((self.fam_a, self.pa),
                                            (self.fam_b, self.pb)))
            t = stream.stage(tokens, self.device)
            return (self.fam_a._lookup(self.pa, t),
                    self.fam_b._lookup(self.pb, t))

    def add_eval_set(self, tokens) -> None:
        """tokens: (B, S) eval sequences to protect."""
        t = stream.stage(tokens, self.device)
        ha = self.fam_a.pairwise_bits(self.fam_a.hash_windows_batched(
            self.pa, t))
        hb = self.fam_b.pairwise_bits(self.fam_b.hash_windows_batched(
            self.pb, t))
        self.bits = self.bloom.add(self.bits, ha.reshape(-1), hb.reshape(-1))

    def contamination(self, tokens) -> np.ndarray:
        """(B, S) train batch -> (B,) float32 fraction of windows present
        in the eval set."""
        ha, hb = self._lookups(tokens)
        counts = shard.run_auto(self.plan, ha, h1v_b=hb,
                                operands={"bloom": {"bits": self.bits}},
                                impl=self.cfg.impl, mesh=self.mesh)["bloom"]
        W = ha.shape[-1] - self.cfg.ngram_n + 1
        return (counts.to(torch.float32) / W).cpu().numpy()

    def flag(self, tokens) -> np.ndarray:
        return self.contamination(tokens) > self.cfg.max_hit_frac

    # -- streaming (unbounded train streams, fixed chunk shape) ------------

    def init_stream(self, batch: int) -> dict:
        """Open ``batch`` parallel train streams: hit counts and both
        rolling-hash tails carry across chunks, so a window spanning two
        chunks is still probed. ``seen`` counts each row's symbols on the
        host, for the final fraction."""
        return {"stream": stream.init_state(self.plan, batch,
                                            device=self.device,
                                            mesh=self.mesh),
                "seen": np.zeros((batch,), np.int64)}

    def _step(self, sstate, tokens, lengths, many: bool) -> dict:
        with trace.span("decontam.update"):
            ha, hb = self._lookups(tokens)
            fn = stream.update_many if many else stream.update
            st = fn(self.plan, sstate["stream"], ha, chunk_b=hb,
                    lengths=lengths, operands={"bloom": {"bits": self.bits}},
                    impl=self.cfg.impl)
            shape = tuple(ha.shape)
            if lengths is None:
                got = np.full(shape[-2:-1],
                              shape[-1] * (shape[0] if many else 1), np.int64)
            else:
                got = np.asarray(lengths.cpu()
                                 if isinstance(lengths, torch.Tensor)
                                 else lengths, np.int64)
                got = got.sum(axis=0) if many else got
            return {"stream": st, "seen": sstate["seen"] + got}

    def update_stream(self, sstate: dict, tokens, lengths=None) -> dict:
        """Fold one (B, C) token chunk into the stream scan."""
        return self._step(sstate, tokens, lengths, many=False)

    def update_stream_many(self, sstate: dict, tokens, lengths=None) -> dict:
        """Fold a (T, B, C) block of T token chunks into the stream scan:
        on CUDA one graph replay of T plan launches, bit-identical to T
        :meth:`update_stream` calls."""
        return self._step(sstate, tokens, lengths, many=True)

    def finalize_stream(self, sstate: dict) -> np.ndarray:
        """-> (B,) fraction of each stream's windows present in the eval
        set (0.0 for streams shorter than one window)."""
        with trace.span("decontam.finalize"):
            counts = stream.finalize(self.plan, sstate["stream"],
                                     batch=len(sstate["seen"]))["bloom"]
            counts = counts.cpu().numpy().astype(np.int64)
        windows = np.maximum(sstate["seen"] - self.cfg.ngram_n + 1, 0)
        return np.where(windows > 0, counts / np.maximum(windows, 1), 0.0)

    # -- parameters ---------------------------------------------------------

    def rebind_params(self, params: dict) -> None:
        """Adopt another pair of family draws and eval-set filter:
        ``{"pa": {"h1"}, "pb": {"h1"}, "bits"}`` as tensors
        (:func:`repro_torch.convert.decontam_params_from_jax`) or
        arrays."""
        self.pa = {k: api.as_u32(v, self.device).contiguous()
                   for k, v in params["pa"].items()}
        self.pb = {k: api.as_u32(v, self.device).contiguous()
                   for k, v in params["pb"].items()}
        self.bits = api.as_u32(params["bits"], self.device).contiguous()

    def export_stream(self, sstate: dict) -> dict:
        """Snapshot an open stream scan and everything its verdicts depend
        on, as one host numpy tree (the JAX package's layout): both family
        draws and the eval-set filter (``params``), the carry (hit counts,
        both rolling tails) and the per-row symbol totals (``seen``)."""
        host = lambda tree: {k: v.cpu().numpy() for k, v in tree.items()}
        return {"params": {"pa": host(self.pa), "pb": host(self.pb),
                           "bits": self.bits.cpu().numpy()},
                "stream": stream.export_state(self.plan, sstate["stream"],
                                              batch=len(sstate["seen"])),
                "seen": np.asarray(sstate["seen"], np.int64).copy()}

    def import_stream(self, tree: dict) -> dict:
        """Rebuild a live stream scan on this instance's device (or mesh,
        whatever shard count it was saved at) from :meth:`export_stream`'s
        tree (this package's or the JAX package's): the params are re-bound
        first, then the carry."""
        self.rebind_params(tree["params"])
        return {"stream": stream.import_state(self.plan, tree["stream"],
                                              device=self.device,
                                              mesh=self.mesh),
                "seen": np.asarray(tree["seen"], np.int64).copy()}
