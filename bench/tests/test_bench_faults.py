"""A whole run at a small size on the CPU with the timed path broken under
it: each fault a cell can have must make ``correct`` false — a step that
leaves its state unchanged, half of the batch left out, an answer altered
where it is produced. (The cells run on one card, so there is no exchange
between cards to leave out.)"""
from __future__ import annotations

import numpy as np
import pytest

from bench_sizes import run_small

from repro_torch.data.decontam import Decontaminator
from repro_torch.data.dedup import MinHashDeduper


def _dedup_state_unchanged(mp):
    # kept documents are never stored: the index stays empty
    mp.setattr(MinHashDeduper, "_insert", lambda self, sig, keys: None)


def _dedup_half_batch(mp):
    add = MinHashDeduper.add_batch
    mp.setattr(MinHashDeduper, "add_batch",
               lambda self, docs: add(self, docs[: len(docs) // 2]))


def _dedup_answer_altered(mp):
    add = MinHashDeduper.add_batch

    def altered(self, docs):
        flags = add(self, docs)
        flags[-1] = not flags[-1]
        return flags
    mp.setattr(MinHashDeduper, "add_batch", altered)


def _dedup_signs_unseen(mp):
    # signatures made past the instance's signature_many: the harness
    # cannot read them
    add = MinHashDeduper.add_batch

    def unseen(self, docs):
        self.signature_many = lambda d: MinHashDeduper.signature_many(self, d)
        return add(self, docs)
    mp.setattr(MinHashDeduper, "add_batch", unseen)


def _scan_state_unchanged(mp):
    mp.setattr(Decontaminator, "update_stream_many",
               lambda self, sstate, tokens, lengths=None: sstate)


def _scan_half_batch(mp):
    many = Decontaminator.update_stream_many

    def half(self, sstate, tokens, lengths=None):
        T, B, C = tokens.shape
        lengths = np.zeros((T, B), np.int32)
        lengths[:, : B // 2] = C
        return many(self, sstate, tokens, lengths)
    mp.setattr(Decontaminator, "update_stream_many", half)


def _scan_answer_altered(mp):
    fin = Decontaminator.finalize_stream

    def altered(self, sstate):
        out = np.array(fin(self, sstate))
        out[0] += 1.0
        return out
    mp.setattr(Decontaminator, "finalize_stream", altered)


DEDUP = [_dedup_state_unchanged, _dedup_half_batch, _dedup_answer_altered,
         _dedup_signs_unseen]
FAULTS = {"dedup.web": DEDUP, "dedup.long": DEDUP,
          "scan.web": [_scan_state_unchanged, _scan_half_batch,
                       _scan_answer_altered]}
# batches a fault's window needs at the small size: an index left empty
# shows once the long mix's 5% copies have come
UNITS = {("dedup.long", "_dedup_state_unchanged"): 24}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in FAULTS
                                        for f in FAULTS[c]],
                         ids=lambda v: v if isinstance(v, str)
                         else v.__name__.lstrip("_"))
def test_fault_makes_the_run_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = run_small(cell, units=UNITS.get((cell, fault.__name__), 4))
    assert not out["correct"], out["checks"]
