"""Durable sketch state: epoch-tagged atomic snapshots for the data plane.

Every sketch bound downstream (MinHash Jaccard unbiasedness, HLL and
CountMin error, the Bloom false-positive rate) holds only while the sampled
hash parameters and the sketch state accumulated under them survive
together: a restart that re-draws against a half-built store voids every
bound while looking healthy. Every state here is a small mergeable summary,
so it checkpoints and restores exactly.

This module is the file layer, on the port's ``train/checkpoint.py`` (the
JAX package's format: tmp dir + fsync + rename, rotation, a crc32 a leaf,
``flush`` for async writers), so a snapshot written by either package
loads in the other. It adds what sketch state needs:

* **template-free restore** — band and signature state grows between
  snapshots, so :func:`load` rebuilds the nested dict from the snapshot's
  own key paths;
* **epoch tags** — a snapshot is ``<dir>/step_<epoch>``; ``epoch`` is the
  caller's resume cursor, so the recovery loop is
  :func:`repro_torch.train.fault.run_with_recovery`.

Restore order is params before state throughout the consumers
(``MinHashDeduper.import_state``, ``NgramStats.import_stream``,
``Decontaminator.import_stream``, ``service.DedupService.import_state``):
the draw is re-bound first, then the state accumulated under it, so a
resumed run is bit-identical to one that never restarted. Leaves come
back as host numpy arrays; each consumer moves them to its device.
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional, Tuple

from repro_torch.train import checkpoint as _ckpt
from repro_torch.train import fault as _fault

# re-exported: a durable shutdown barrier is part of this module's contract
flush = _ckpt.flush

_KEY_RE = re.compile(r"\['((?:[^'\\]|\\.)*)'\]")


def save(tree: Dict, directory: str, epoch: int, *, keep: int = 3,
         async_: bool = False, injector=None):
    """Write one epoch-tagged atomic snapshot of a durable-state pytree.

    ``tree`` must be a nested dict with string keys and array-like leaves
    (the durable-state convention — what every ``export_state`` /
    ``export_stream`` in the data plane produces). ``async_`` hands the
    file I/O to a background writer (join with :func:`flush`). ``injector``
    is a :class:`repro_torch.train.fault.FailureInjector` fired *after* the tmp
    write but *before* the atomic rename — the mid-snapshot-kill seam: an
    injected :class:`~repro_torch.train.fault.SnapshotInterrupt` loses this
    epoch's write, leaves only a stale ``.tmp``, and restore falls back to
    the previous snapshot (asserted in tests).

    Returns the checkpoint path (sync) or the writer thread (async).
    """
    _check_tree(tree)
    pre = None
    if injector is not None:
        def pre(tmp, final):  # noqa: ARG001 - seam signature
            injector.maybe_fail(epoch)
    if async_:
        return _ckpt.save_async(tree, directory, epoch, keep=keep,
                                pre_rename=pre)
    return _ckpt.save(tree, directory, epoch, keep=keep, pre_rename=pre)


def latest_epoch(directory: str) -> Optional[int]:
    """Newest complete snapshot's epoch (stale ``.tmp`` half-writes and
    unreadable metas are invisible), or None."""
    return _ckpt.latest_step(directory)


def load(directory: str, epoch: Optional[int] = None, *,
         on_corrupt: str = "raise") -> Tuple[Dict, int]:
    """Rebuild a durable-state pytree from a snapshot — template-free.

    Unlike ``train.checkpoint.restore`` no shape template is needed (sketch
    index state grows between snapshots); the nested dict structure is
    reconstructed from the checkpoint meta's key paths. Returns
    ``(tree, epoch)`` with every leaf a host numpy array.

    Every leaf is crc32-verified against the snapshot meta (written at
    save time): a flipped byte raises the typed
    :class:`~repro_torch.train.fault.DataCorruption` instead of riding through
    the shape/dtype checks silently. ``on_corrupt="skip"`` omits corrupt
    leaves from the returned tree instead of raising — the replicated
    dedup service restores this way and read-repairs the damaged replica
    from its intact snapshot peers.
    """
    if on_corrupt not in ("raise", "skip"):
        raise ValueError(f"on_corrupt must be 'raise'|'skip', "
                         f"got {on_corrupt!r}")
    epoch = epoch if epoch is not None else latest_epoch(directory)
    if epoch is None:
        raise FileNotFoundError(f"no durable snapshot under {directory}")
    d = os.path.join(directory, f"step_{epoch:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    tree: Dict = {}
    for e in meta["leaves"]:
        keys = _KEY_RE.findall(e["path"])
        if not keys or "".join(f"['{k}']" for k in keys) != e["path"]:
            raise ValueError(
                f"snapshot {d} leaf path {e['path']!r} is not a nested "
                f"string-keyed dict path — not a durable-state snapshot")
        try:
            leaf = _ckpt.read_leaf(d, e)
        except _fault.DataCorruption:
            if on_corrupt == "raise":
                raise
            continue            # skip: caller repairs from an intact peer
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree, epoch


def _check_tree(tree, path="tree") -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            if not isinstance(k, str) or not k or "'" in k:
                raise ValueError(
                    f"{path}: durable-state keys must be non-empty strings "
                    f"without quotes, got {k!r}")
            _check_tree(v, f"{path}[{k!r}]")
        return
    try:
        arr = _ckpt.to_host(tree)
    except (TypeError, ValueError, RuntimeError) as e:
        raise ValueError(f"{path}: leaf is not array-like "
                         f"({type(tree).__name__})") from e
    if arr.dtype == object:
        # numpy happily wraps arbitrary objects 0-d; np.save would
        # then pickle them — not a durable, versionable format
        raise ValueError(f"{path}: leaf is not array-like "
                         f"({type(tree).__name__} -> object dtype)")


# ---------------------------------------------------------------------------
# convenience wrappers: whole-object snapshot/restore for the data plane
# ---------------------------------------------------------------------------

def save_deduper(dd, directory: str, epoch: int, *, keep: int = 3,
                 async_: bool = False, injector=None):
    """Snapshot a :class:`~repro_torch.data.dedup.MinHashDeduper` (hash params +
    signature store + packed band index)."""
    return save(dd.export_state(), directory, epoch, keep=keep,
                async_=async_, injector=injector)


def restore_deduper(dd, directory: str, epoch: Optional[int] = None) -> int:
    """Restore a deduper in place (params re-bound before state); returns
    the epoch restored from."""
    tree, epoch = load(directory, epoch)
    dd.import_state(tree)
    return epoch


def save_stats_stream(stats, sstate, directory: str, epoch: int, *,
                      keep: int = 3, async_: bool = False, injector=None):
    """Snapshot an open :class:`~repro_torch.data.stats.NgramStats` stream."""
    return save(stats.export_stream(sstate), directory, epoch, keep=keep,
                async_=async_, injector=injector)


def restore_stats_stream(stats, directory: str,
                         epoch: Optional[int] = None) -> Tuple[Dict, int]:
    """-> (live stream state on ``stats``'s device or mesh, whatever shard
    count it was saved at; epoch restored from)."""
    tree, epoch = load(directory, epoch)
    return stats.import_stream(tree), epoch


def save_decontam_stream(dec, sstate, directory: str, epoch: int, *,
                         keep: int = 3, async_: bool = False, injector=None):
    """Snapshot an open :class:`~repro_torch.data.decontam.Decontaminator`
    stream scan (both family draws + filter + carry)."""
    return save(dec.export_stream(sstate), directory, epoch, keep=keep,
                async_=async_, injector=injector)


def restore_decontam_stream(dec, directory: str,
                            epoch: Optional[int] = None) -> Tuple[Dict, int]:
    """-> (live stream state on ``dec``'s device or mesh, whatever shard
    count it was saved at; epoch restored from)."""
    tree, epoch = load(directory, epoch)
    return dec.import_stream(tree), epoch
