"""Atomic, async checkpointing in the JAX package's on-disk format.

One directory per step, ``<dir>/step_%08d``, holding one ``.npy`` per leaf
and a ``meta.json`` with the step and, per leaf, its key path, its file
name and the crc32 of its bytes. The port writes and reads exactly the
format of the JAX package's ``train/checkpoint.py``, so a snapshot written
by either package restores in the other:

* leaves are visited as ``jax.tree_util.tree_flatten_with_path`` visits a
  tree of dicts and lists: dict keys in sorted order, list items in order,
  ``None`` as an empty subtree;
* a leaf's key path is ``jax.tree_util.keystr``'s: ``['key']`` for a dict
  key (``repr`` of the key), ``[i]`` for a list index;
* a leaf's file name is its key path with every run of characters outside
  ``[A-Za-z0-9_.]`` replaced by ``_`` and stripped of ``_`` at both ends,
  ``_`` appended until it is unique.

Properties:

* **atomic** — written to ``<dir>.tmp``, fsync'd, then renamed; a stale
  ``.tmp`` from a mid-write kill is invisible to :func:`latest_step` and
  :func:`restore`, and is swept by the next write;
* **async** — :func:`save_async` copies every leaf to host numpy in the
  caller's thread (a tensor the caller changes next cannot leak into the
  file) and hands the file I/O to a thread that :func:`flush` joins;
* **verified** — :func:`read_leaf` checks each leaf's crc32 and raises
  :class:`~repro_torch.train.fault.DataCorruption` on a mismatch;
* **rotation** — the newest ``keep`` snapshots stay.

Tensors are saved as their host numpy arrays (uint32 stays uint32).
"""
from __future__ import annotations

import io
import json
import os
import re
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.fault import DataCorruption

_SAVE_LOCK = threading.Lock()
# async writers not yet joined; flush() drains it
_INFLIGHT: list = []
_INFLIGHT_LOCK = threading.Lock()


def _key(k) -> str:
    return f"[{k!r}]"


def flatten_with_path(tree, path: str = "") -> List[Tuple[str, Any]]:
    """``(keystr path, leaf)`` pairs of a tree of dicts, lists and tuples,
    in the JAX package's order: dict keys sorted, sequences in order,
    ``None`` holding no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_path(tree[k], path + _key(k))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten_with_path(v, path + f"[{i}]")
        return out
    return [(path, tree)]


def to_host(leaf) -> np.ndarray:
    """A leaf (tensor, array or scalar) as a host numpy array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def host_tree(tree):
    """The tree with every leaf a host numpy copy (structure kept). A
    device tensor's copy to the host is the copy."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.device.type != "cpu":
        return to_host(tree)
    return np.array(to_host(tree))


def _leaf_name(path: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.]+", "_", path).strip("_") or "leaf"


def save(state, directory: str, step: int, keep: int = 3,
         pre_rename=None) -> str:
    """Synchronous checkpoint write. Returns the checkpoint path.

    ``pre_rename(tmp, final)`` is called after the tmp directory is fully
    written and fsync'd and before the atomic rename: the seam through
    which a test kills the process mid-snapshot (the write is lost, the
    tmp stale, and restore falls back to the previous snapshot)."""
    return _write(host_tree(state), directory, step, keep, pre_rename)


def save_async(state, directory: str, step: int, keep: int = 3,
               pre_rename=None) -> threading.Thread:
    """Copy every leaf to host numpy now, in the caller's thread; write in
    a background thread. Join it with :func:`flush` before exit."""
    host_state = host_tree(state)
    t = threading.Thread(target=_write, args=(host_state, directory, step,
                                              keep, pre_rename),
                         daemon=True)
    with _INFLIGHT_LOCK:
        _INFLIGHT.append(t)
    t.start()
    return t


def flush() -> None:
    """Join every in-flight :func:`save_async` writer."""
    while True:
        with _INFLIGHT_LOCK:
            if not _INFLIGHT:
                return
            t = _INFLIGHT.pop()
        t.join()


def _write(host_state, directory: str, step: int, keep: int,
           pre_rename=None) -> str:
    with _SAVE_LOCK:
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        # a stale tmp of this same step must not leak its leaves into the
        # fresh snapshot
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        meta = {"step": step, "leaves": []}
        names = set()
        for path, leaf in flatten_with_path(host_state):
            name = _leaf_name(path)
            while name in names:
                name += "_"
            names.add(name)
            fname = os.path.join(tmp, name + ".npy")
            np.save(fname, np.asarray(leaf))
            with open(fname, "rb") as fh:
                crc = zlib.crc32(fh.read())
            meta["leaves"].append({"path": path, "file": name + ".npy",
                                   "crc32": int(crc)})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if pre_rename is not None:
            pre_rename(tmp, final)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _rotate(directory, keep)
        return final


def _pool_map(fn, items: list) -> list:
    """``fn`` over ``items`` in order, on a few threads: file reads,
    crc32 and numpy's copies release the interpreter lock, so a restore
    of many large leaves reads them side by side. (Writes stay on one
    thread: ``save_async`` overlaps them with training steps, which a
    pool of writers would starve of the host.)"""
    if len(items) < 2:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(min(8, len(items), os.cpu_count() or 1)) as pool:
        return list(pool.map(fn, items))


def _rotate(directory: str, keep: int) -> None:
    ckpts = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for old in ckpts[:-keep]:
        shutil.rmtree(os.path.join(directory, old))
    # any .tmp visible here is a dead half-write: writes are serialized by
    # _SAVE_LOCK (held now) and a live writer renames before releasing it
    for stale in os.listdir(directory):
        if stale.endswith(".tmp"):
            shutil.rmtree(os.path.join(directory, stale), ignore_errors=True)


def _readable_meta(directory: str, d: str) -> bool:
    """True iff the snapshot's meta.json exists and parses."""
    try:
        with open(os.path.join(directory, d, "meta.json")) as f:
            json.load(f)
        return True
    except (OSError, ValueError):
        return False


def latest_step(directory: str) -> Optional[int]:
    """Newest complete snapshot's step (stale ``.tmp`` half-writes and
    unreadable metas are invisible), or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")
             and _readable_meta(directory, d)]
    return max(steps) if steps else None


def read_leaf(ckpt_dir: str, entry: Dict[str, Any]) -> np.ndarray:
    """Load one leaf named by a meta.json entry, verifying its crc32
    (:class:`DataCorruption` on a mismatch or an unreadable file; a leaf
    without a ``crc32`` loads unverified)."""
    fname = os.path.join(ckpt_dir, entry["file"])
    with open(fname, "rb") as fh:
        data = fh.read()
    want = entry.get("crc32")
    if want is not None and zlib.crc32(data) != int(want):
        raise DataCorruption(
            f"checkpoint leaf {entry['path']} ({fname}) failed crc32 "
            f"verification — payload corrupt")
    try:
        return np.load(io.BytesIO(data), allow_pickle=False)
    except Exception as e:
        raise DataCorruption(
            f"checkpoint leaf {entry['path']} ({fname}) unreadable: "
            f"{e}") from e


def _unflatten_like(template, leaves: Dict[str, Any], path: str = ""):
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten_like(template[k], leaves, path + _key(k))
                for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_like(v, leaves, path + f"[{i}]")
                              for i, v in enumerate(template))
    return leaves[path]


def _placements(template, shardings, path: str = "") -> Dict[str, Any]:
    """``{keystr path: device or None}`` for every leaf of ``template``,
    read from the matching ``shardings`` tree (a None there, at a leaf or
    above it, places nothing)."""
    if template is None:
        return {}
    if isinstance(template, dict):
        out = {}
        for k in template:
            sub = None if shardings is None else shardings[k]
            out.update(_placements(template[k], sub, path + _key(k)))
        return out
    if isinstance(template, (list, tuple)):
        out = {}
        for i, v in enumerate(template):
            sub = None if shardings is None else shardings[i]
            out.update(_placements(v, sub, path + f"[{i}]"))
        return out
    if shardings is None or hasattr(shardings, "spec"):    # a Placement
        return {path: shardings}
    return {path: torch.device(shardings)}


def restore(template, directory: str, step: Optional[int] = None,
            shardings=None, device=None):
    """Restore into the structure of ``template`` -> ``(tree, step)``. A
    tensor leaf of the template comes back as a tensor of its dtype on
    ``device`` (default: the template leaf's device), any other leaf as a
    numpy array of the template's dtype; shapes must match.

    ``shardings``: optional tree matching ``template`` whose leaves are
    ``torch.device``s (or None): a leaf with a device comes back as a
    tensor of the template's dtype on that device, whatever the template
    leaf is — the placement the JAX package's ``NamedSharding`` tree gives
    with ``device_put``; a None leaves the leaf where ``device`` puts it.
    A leaf may also be a ``launch.shardings.Placement`` (a model mesh and
    a spec): the leaf comes back as a ``nn.collectives.Sharded``, sliced
    into its shards on their positions' devices, whatever mesh it was
    saved from (a snapshot holds whole leaves)."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    by_path = {e["path"]: e for e in meta["leaves"]}
    place = _placements(template, shardings)
    leaves = flatten_with_path(template)
    arrays = _pool_map(lambda pt: read_leaf(d, by_path[pt[0]]), leaves)
    out = {}
    for (path, tmpl), arr in zip(leaves, arrays):
        if arr.shape != tuple(tmpl.shape):
            raise ValueError(f"leaf {path}: shape {arr.shape} != template "
                             f"{tuple(tmpl.shape)}")
        if isinstance(tmpl, torch.Tensor):
            dtype = torch.empty(0, dtype=tmpl.dtype).numpy().dtype
        else:
            dtype = np.asarray(tmpl).dtype
        # a copy that keeps a 0-d leaf 0-d (np.ascontiguousarray makes it 1-d)
        arr = np.array(arr, dtype=dtype, order="C")
        if hasattr(place[path], "spec"):
            out[path] = place[path].shard(torch.from_numpy(arr))
        elif place[path] is not None:
            out[path] = torch.from_numpy(arr).to(place[path])
        elif isinstance(tmpl, torch.Tensor):
            out[path] = torch.from_numpy(arr).to(
                device if device is not None else tmpl.device)
        else:
            out[path] = arr
    return _unflatten_like(template, out), step
