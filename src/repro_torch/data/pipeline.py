"""Deterministic, resumable input pipeline with the hash data plane wired in.

* stateless sampling: ``batch_for_step(step)`` is a pure function of
  (seed, step, host_id), so any step can be recomputed after a restart;
* dedup, decontamination and n-gram statistics run per batch on the card;
* packing: documents are packed into fixed-length rows with EOS separators.

* durability: :meth:`DataPlane.snapshot` / :meth:`DataPlane.restore` write
  and read the stats state with its draw through ``data/durable.py``, in
  the JAX package's format (a snapshot of either package restores in the
  other).
* ``PipelineConfig.data_shards`` routes the corpus dedup's signing over a
  data mesh of that many shards (:mod:`repro_torch.kernels.shard`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.data import durable
from repro_torch.data.corpus import CorpusSpec, documents
from repro_torch.data.decontam import Decontaminator
from repro_torch.data.dedup import DedupConfig, MinHashDeduper
from repro_torch.data.stats import NgramStats, StatsConfig


@dataclasses.dataclass
class PipelineConfig:
    seq_len: int = 1024
    batch_size: int = 8           # per host
    vocab: int = 8192
    eos_id: int = 0
    seed: int = 0
    dedup: bool = True
    host_id: int = 0
    num_hosts: int = 1
    hash_family: str = "cyclic"   # the dedup signing family
    impl: str = "auto"            # kernel dispatch: auto | kernel | ref
    # sign the dedup pass over a data mesh of this many shards (None = one
    # device)
    data_shards: Optional[int] = None
    device: str = "cuda"


class PackedCorpus:
    """Documents -> deduped -> one flat token stream with EOS separators."""

    def __init__(self, cfg: PipelineConfig, spec: Optional[CorpusSpec] = None):
        self.cfg = cfg
        spec = spec or CorpusSpec(vocab=cfg.vocab, seed=cfg.seed)
        docs, _ = documents(spec)
        self.n_duplicates = 0
        if cfg.dedup:
            with MinHashDeduper(DedupConfig(vocab=cfg.vocab, seed=cfg.seed,
                                            family=cfg.hash_family,
                                            impl=cfg.impl,
                                            data_shards=cfg.data_shards,
                                            device=cfg.device)) as dd:
                flags = dd.add_batch(docs)
            self.n_duplicates = int(flags.sum())
            kept: List[np.ndarray] = [d for d, f in zip(docs, flags) if not f]
        else:
            kept = docs
        self.stream = pack(kept, cfg.vocab, cfg.eos_id)
        self.n_docs_kept = len(kept)

    def batch_for_step(self, step: int) -> np.ndarray:
        """Pure function of step: (batch_size, seq_len) int32."""
        cfg = self.cfg
        n_rows = max(1, (len(self.stream) - 1) // cfg.seq_len)
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
        rows = rng.integers(0, n_rows, size=cfg.batch_size)
        take = min(cfg.seq_len, len(self.stream))
        idx = rows[:, None] * cfg.seq_len + np.arange(take)[None, :]
        return self.stream[idx].astype(np.int32)


def pack(docs, vocab: int, eos_id: int) -> np.ndarray:
    """Documents -> one int32 stream, each document (mod ``vocab``)
    followed by ``eos_id``."""
    pieces = []
    for d in docs:
        pieces.append(np.asarray(d) % vocab)
        pieces.append(np.asarray([eos_id], np.int32))
    return np.concatenate(pieces).astype(np.int32)


class DataPlane:
    """Bundles the paper-hash services used by the training loop."""

    def __init__(self, cfg: PipelineConfig,
                 stats: Optional[NgramStats] = None,
                 decontam: Optional[Decontaminator] = None):
        self.corpus = PackedCorpus(cfg)
        self.stats = stats or NgramStats(StatsConfig(impl=cfg.impl,
                                                     device=cfg.device))
        self.stats_state = self.stats.init_state()
        self.decontam = decontam

    def next_batch(self, step: int) -> Dict[str, np.ndarray]:
        tokens = self.corpus.batch_for_step(step)
        if self.decontam is not None:
            clean = ~self.decontam.flag(tokens)
            # replace contaminated rows with resampled ones (step-salted)
            if not clean.all():
                repl = self.corpus.batch_for_step(step + 10_000_019)
                tokens = np.where(clean[:, None], tokens, repl)
        self.stats_state = self.stats.update(self.stats_state, tokens)
        return {"tokens": tokens}

    def telemetry(self) -> Dict[str, float]:
        return {
            "distinct_ngrams": self.stats.distinct_ngrams(self.stats_state),
            "tokens_seen": self.stats.token_count(self.stats_state),
            "docs_kept": self.corpus.n_docs_kept,
            "docs_deduped": self.corpus.n_duplicates,
        }

    # -- durability ---------------------------------------------------------
    # The corpus is stateless-resumable (batch_for_step is pure), so the
    # only state a restart must carry is the stats accumulator and the
    # draw it was accumulated under.

    def snapshot(self, directory: str, step: int, *, keep: int = 3,
                 async_: bool = False, injector=None):
        """Epoch-tagged atomic snapshot of the per-step data-plane state:
        ``{"params": the stats draw, "stats": {"hll", "cms", "tokens"}}``.
        Every leaf is copied to the host before this returns, also with
        ``async_`` (``train/checkpoint.py``)."""
        tree = {"params": self.stats.export_params(),
                "stats": self.stats_state}
        return durable.save(tree, directory, step, keep=keep, async_=async_,
                            injector=injector)

    def restore(self, directory: str, epoch: Optional[int] = None) -> int:
        """Adopt the newest (or given) snapshot: the draw re-bound before
        the state it produced. Returns the step restored from (feed it
        back to :meth:`next_batch`)."""
        tree, epoch = durable.load(directory, epoch)
        self.stats.rebind_params(tree["params"])
        dev = self.stats.device
        st = tree["stats"]
        self.stats_state = {
            "hll": torch.from_numpy(np.asarray(st["hll"], np.int32).copy()
                                    ).to(dev),
            "cms": torch.from_numpy(np.asarray(st["cms"], np.int32).copy()
                                    ).to(dev),
            "tokens": np.asarray(st["tokens"], np.uint32).copy()}
        return epoch
