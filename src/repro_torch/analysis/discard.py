"""Theorem-1/2 discard checking: no consumer may touch the dependent bits.

The paper's central caveat is *bit-level*: a recursive n-gram hash is
pairwise independent **at best**, and for CYCLIC only on ``L - n + 1``
consecutive bits — the other ``n - 1`` bits are linear functions of the kept
ones (Theorems 1–2), so any probe, bucket index, or filter position derived
from them silently loses the pairwise guarantee every false-positive bound
in this repo is priced on. The engine encodes the discard as
``HashSpec.hash_mask`` / ``DecodeSpec.hash_mask`` (low-bit keep) and every
consumer is *supposed* to route through it. The port's plain path adds a
risk of its own: it computes uint32 arithmetic on int64 lanes and masks
back to 32 bits after each step, so a raw hash and a renormalised one look
alike in the code. This module checks, two ways, that consumers route
through the discard:

**Statically** (:func:`static_findings`): an AST pass over the consumer
layers (``data/``, ``serve/``, ``kernels/decode.py``) with two rules:

* ``DS1`` — a right-shift whose amount is written in terms of ``out_bits``
  or ``L - n`` is extracting exactly the discarded high bits; the engine's
  own shifts (probe word index ``>> 5``, HLL rank split) use constants or
  unrelated widths and never match.
* ``DS2`` — the known probe-derivation entry points must receive a
  *masked* hash argument: the argument expression (or the local name it
  was assigned from, tracked to a fixpoint inside the enclosing function)
  must route through ``hash_mask``. They are ``ref.bloom_probe_hits`` and
  ``sessions._bloom_add_rows``; the reference's ``_probe_hits_tile`` lives
  inside the CUDA kernel here, so its counterparts are the ``hash_mask``
  arguments of the decode launch (``decode_masks``) and of its plain
  version (``decode_masks_ref``).

**At trace time** (:func:`trace_findings`): a mask-propagation pass over an
aten graph from ``torch.fx.experimental.proxy_tensor.make_fx``. Every
``bitwise_and`` with the ``hash_mask`` literal marks its other operand as a
*raw* window hash. The raw value may feed the rolling recursion (xor / or
/ and / not / where, views, copies — full-width state is the recursion's
contract) but never a probe-shaped consumer (multiply/add for the
double-hashing stride, shifts for word indices, gathers for filter
lookups). What only moves or renormalises a raw value stays raw: a view,
a copy, a dtype conversion, a ``where``, and an ``and`` with a literal
that keeps a discarded bit (the plain path's ``& 0xFFFFFFFF``, which
``u32.lanes`` applies on entry to every probe helper) — so a raw hash
handed to a probe helper is caught at the helper's multiply.
:func:`verify_decode_discard` drives this over the decode plane's plain
path and the session step's body, where Theorem 2 is load-bearing; the
CUDA kernel takes the mask as the launch argument that DS2 checks.

Both halves return findings (empty = the discard holds); the
``python -m repro_torch.analysis`` driver folds them into the report.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Union

__all__ = ["DiscardFinding", "scope_files", "static_findings",
           "trace_findings",
           "verify_decode_discard", "SCOPE", "PROBE_CALLEES",
           "ALLOWED_RAW_CONSUMERS", "PASS_THROUGH"]

# the consumer layers Theorems 1-2 bind (the hash *producers* in kernels/
# legitimately hold full-width state for the recursion)
SCOPE = ("src/repro_torch/data", "src/repro_torch/serve",
         "src/repro_torch/kernels/decode.py")

# probe-derivation entry points and which argument must be the masked hash:
# a positional index, or a keyword name
PROBE_CALLEES: Dict[str, Union[int, str]] = {
    "bloom_probe_hits": 0,          # ref.py: the probe's plain version
    "_bloom_add_rows": 1,           # serve/sessions.py: filter insert
    "decode_masks": 10,             # kernels/decode.py: the decode launch
    "decode_masks_ref": "hash_mask",    # ...and its plain version
}

# aten ops that only move a value: their output holds the input's bits
PASS_THROUGH = frozenset({
    "where", "view", "_unsafe_view", "reshape", "expand", "unsqueeze",
    "squeeze", "select", "slice", "permute", "transpose", "t", "alias",
    "detach", "_to_copy", "clone", "copy", "copy_", "lift_fresh_copy",
    "contiguous",
})

# aten ops a raw (pre-mask) window hash may legitimately feed: the rolling
# recursion and layout plumbing. Anything else — mul/add (the
# double-hashing stride), shifts (word/bit indices), gather/index (filter
# lookups) — is a probe derived from undiscarded bits.
ALLOWED_RAW_CONSUMERS = PASS_THROUGH | frozenset({
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
})


@dataclasses.dataclass(frozen=True)
class DiscardFinding:
    rule: str       # "DS1" | "DS2" | "trace" | "NO-FILES"
    path: str       # repo-relative file ("<...>" for trace-time)
    line: int
    message: str

    def __str__(self):
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


# ---------------------------------------------------------------------------
# static half: AST over the consumer layers
# ---------------------------------------------------------------------------


def _names_in(node) -> set:
    out = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.add(sub.id)
        elif isinstance(sub, ast.Attribute):
            out.add(sub.attr)
    return out


def _is_masked_expr(node, masked_names: set) -> bool:
    """The expression routes through the discard: it mentions ``hash_mask``
    (``spec.hash_mask``, a ``hash_mask`` parameter) or a local name that was
    assigned from such an expression."""
    return bool(_names_in(node) & ({"hash_mask"} | masked_names))


def _masked_locals(fn: ast.AST) -> set:
    """Names assigned (to a fixpoint) from hash_mask-routed expressions
    inside one function body."""
    masked: set = set()
    changed = True
    while changed:
        changed = False
        for sub in ast.walk(fn):
            if not isinstance(sub, ast.Assign):
                continue
            if not _is_masked_expr(sub.value, masked):
                continue
            for tgt in sub.targets:
                if isinstance(tgt, ast.Name) and tgt.id not in masked:
                    masked.add(tgt.id)
                    changed = True
    return masked


def _callee_name(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _probe_arg(call: ast.Call, where: Union[int, str]):
    """The argument expression at a positional index or keyword, or None
    for a call of another shape."""
    if isinstance(where, str):
        return next((kw.value for kw in call.keywords if kw.arg == where),
                    None)
    return call.args[where] if where < len(call.args) else None


def _check_function(fn, rel: str, findings: List[DiscardFinding]) -> None:
    masked = _masked_locals(fn)
    for node in ast.walk(fn):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.RShift):
            # DS1: shifting by out_bits / (L - n)-shaped amounts reads the
            # dependent high bits the theorems discard
            ln_shaped = any(
                isinstance(s, ast.BinOp) and isinstance(s.op, ast.Sub)
                and {"L", "n"} <= _names_in(s)
                for s in ast.walk(node.right))
            if "out_bits" in _names_in(node.right) or ln_shaped:
                findings.append(DiscardFinding(
                    "DS1", rel, node.lineno,
                    "right-shift by an out_bits/(L - n)-derived amount "
                    "extracts the discarded dependent high bits; derive "
                    "from `h & hash_mask` instead"))
        elif isinstance(node, ast.Call):
            name = _callee_name(node)
            if name not in PROBE_CALLEES:
                continue
            arg = _probe_arg(node, PROBE_CALLEES[name])
            if arg is not None and not _is_masked_expr(arg, masked):
                findings.append(DiscardFinding(
                    "DS2", rel, node.lineno,
                    f"{name}() probe hash argument does not route through "
                    f"spec.hash_mask — probes from undiscarded bits void "
                    f"the pairwise-independence bound (Theorems 1-2)"))


def _repo_root() -> Path:
    return Path(__file__).resolve().parents[3]


def scope_files(root: Optional[Path] = None) -> List[Path]:
    """The files of :data:`SCOPE` under ``root`` (default: the checkout
    this module lies in)."""
    root = Path(root) if root else _repo_root()
    files: List[Path] = []
    for entry in SCOPE:
        p = root / entry
        if p.is_file():
            files.append(p)
        elif p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
    return files


def static_findings(root: Optional[Path] = None) -> List[DiscardFinding]:
    """Run DS1/DS2 over every file in :data:`SCOPE`; a root that holds none
    of them is a finding, not a clean pass."""
    root = Path(root) if root else _repo_root()
    files = scope_files(root)
    if not files:
        return [DiscardFinding("NO-FILES", str(root), 0,
                               f"none of {SCOPE} lies under this root: the "
                               f"discard check read no file")]
    findings: List[DiscardFinding] = []
    for path in files:
        rel = str(path.relative_to(root))
        tree = ast.parse(path.read_text(), filename=rel)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _check_function(node, rel, findings)
    return findings


# ---------------------------------------------------------------------------
# trace-time half: mask propagation over an aten graph
# ---------------------------------------------------------------------------


def _op_name(node) -> str:
    """``aten.bitwise_and.Scalar`` -> ``bitwise_and``; a Python operator
    (``operator.getitem``) -> its name."""
    target = node.target
    packet = getattr(target, "overloadpacket", None)
    name = getattr(packet, "__name__", None) or getattr(target, "__name__",
                                                        str(target))
    return name.rsplit(".", 1)[-1]


def trace_findings(gm, hash_mask: int) -> List[str]:
    """Raw-hash escape analysis on one traced graph (a ``GraphModule`` or
    an ``fx.Graph``).

    Each ``bitwise_and`` node with the ``hash_mask`` literal is a discard
    site; its non-literal operand is a *raw* window hash, and so is what a
    :data:`PASS_THROUGH` op or an ``and`` with a literal keeping a
    discarded bit makes of it. Raw hashes may feed the recursion
    (:data:`ALLOWED_RAW_CONSUMERS`) but any probe-shaped consumer (stride
    multiply, index shift, filter gather) is a Theorem-1/2 violation."""
    graph = getattr(gm, "graph", gm)
    dropped = ~hash_mask & 0xFFFFFFFF          # the discarded bits
    calls = [n for n in graph.nodes if n.op == "call_function"]
    literals = lambda n: [a for a in n.args if type(a) is int]
    sites = {n for n in calls if _op_name(n) == "bitwise_and"
             and hash_mask in literals(n)}
    raw = {a for n in sites for a in n.all_input_nodes}
    findings = []
    for node in calls:                          # fx order is topological
        fed = [a for a in node.all_input_nodes if a in raw]
        if node in sites or not fed:
            continue
        name = _op_name(node)
        if name not in ALLOWED_RAW_CONSUMERS:
            findings.append(
                f"raw (pre-discard) hash feeds `{name}` — probe "
                f"derivation must come from the masked value "
                f"(hash_mask={hash_mask:#x})")
        elif name in PASS_THROUGH or (name == "bitwise_and" and any(
                c & dropped for c in literals(node))):
            raw.add(node)
    return findings


def verify_decode_discard(spec=None) -> List[DiscardFinding]:
    """Trace the decode plane's plain path (``api.decode(impl="ref")``) and
    the session step's body with ``make_fx`` on the CPU and run
    :func:`trace_findings` with the spec's Theorem-2 mask. Skipped for
    degraded/full-width specs (the mask covers all L bits — nothing to
    check)."""
    import numpy as np
    import torch
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.kernels import api
    from repro_torch.kernels.plan import DecodeSpec
    from repro_torch.serve import sessions

    spec = spec or DecodeSpec(n=4, log2_m=8, canary_log2_m=8)
    if spec.hash_mask == (1 << spec.L) - 1:
        return []
    rng = np.random.default_rng(3)
    B, V = 4, 64
    u32 = lambda shape: torch.from_numpy(
        rng.integers(0, 2**32, shape, dtype=np.uint32))
    logits = torch.from_numpy(rng.standard_normal((B, V)).astype(np.float32))
    prefix, bloom, h1 = u32((B,)), u32((B, spec.n_words)), u32((V,))
    ready = torch.ones((B,), dtype=torch.int32)
    cb = u32((spec.canary_words,)) if spec.has_canary else None
    noise = torch.from_numpy(rng.random((B, V)).astype(np.float32))

    findings: List[DiscardFinding] = []

    def check(tag, gm):
        for msg in trace_findings(gm, spec.hash_mask):
            findings.append(DiscardFinding("trace", f"<{tag}>", 0, msg))

    check("api.decode impl=ref", make_fx(
        lambda *a: api.decode(spec, *a, canary_bits=cb, impl="ref"))(
            logits, prefix, ready, bloom, h1))
    state = sessions.init_state(spec, B, device="cpu")
    check("SessionPool.step", make_fx(
        lambda st, lg, nz, h: sessions._step_core(
            spec, True, 0.8, 5, st, lg, nz, h, cb))(state, logits, noise,
                                                    h1))
    return findings
