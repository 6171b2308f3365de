"""The port's AST lint: the JAX package's rules, retargeted to
``src/repro_torch`` and the port's tests (``tests/test_torch_*.py``).

Every rule is a bug class that shipped (and was fixed) in the reference,
generalized so the *class* cannot come back in the port:

* ``U64-BINCOUNT`` — ``np.bincount`` refuses uint64 input (no safe cast to
  intp) and raising at count time is the *good* outcome; on some platforms
  the silent intp cast truncates. A bincount whose argument traces to a
  uint64 value must go through a cast (``.astype(np.int64)`` or
  ``.to(torch.int64)``) first.
* ``I32-COUNTER`` — an int32 counter on an unbounded stream wraps negative
  at ~2.1B tokens. Counters named like stream totals in ``data/`` and
  ``serve/`` must not be int32 zeros or fills (``torch.zeros(...,
  dtype=torch.int32)``, ``np.zeros(..., np.int32)``, a fill of 0); the
  idiom is a uint32 (lo, hi) pair with explicit carry.
* ``SHIM-IMPORT`` — the deprecation shims
  (``repro_torch.kernels.cyclic_fused``,
  ``MinHashDeduper._signature_many_bucketed``) exist only as oracles for
  the tests that certify their replacements; new call sites use the plan
  engine. Opted-in files carry a ``lint: allow-deprecated-shims`` marker
  comment.
* ``UNSEEDED-RNG`` — nondeterministic randomness in ``core/`` and
  ``kernels/`` breaks the bit-identity contracts every test asserts:
  torch draws (``torch.rand*``, ``randperm``, ``multinomial``,
  ``bernoulli``, ``normal``, ``poisson`` and the in-place
  ``Tensor.random_`` / ``uniform_`` / ``normal_`` ...) must take an
  explicit ``generator=``, and numpy's global ``np.random`` and a seedless
  ``default_rng()`` are out.
* ``SWALLOWED-FAULT`` — the fault plane's typed failures
  (``InjectedFailure`` and its subclasses) exist so every recovery path is
  *accounted*: retried, counted, queued, or re-raised. An
  ``except Exception: pass`` in ``data/`` or ``train/`` silently converts a
  worker death or corrupt payload into "fine".

The reference's ``DONATE-UNCHECKED`` has no counterpart: the port has no
``donate_argnums`` whose donation a compiler may drop. Its donation is
``sketch_plan_fused(donate=True)`` and the session pool's in-place carry,
and the contract census checks both directly
(:mod:`repro_torch.analysis.contracts`: donated launches, in-place
storage, the caller's state never written).

Findings carry file:line anchors; ``python -m repro_torch.analysis`` exits
nonzero when any rule fires. Adding a rule = one ``_rule_*`` function
appended to :data:`RULES`; each gets the parsed tree + source of every
file in its scope and appends :class:`Finding` objects.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Callable, List, Optional

__all__ = ["Finding", "lint_tree", "lint_file", "scan_files", "RULES",
           "SHIM_MARKER"]

SHIM_MARKER = "lint: allow-deprecated-shims"

PKG = "src/repro_torch"

# stream-total counter names the I32-COUNTER rule guards (bounded counters —
# ring positions, saturating warm-up counts — are deliberately not listed)
COUNTER_NAMES = frozenset({
    "steps", "tokens", "token_count", "n_tokens", "total_tokens",
    "banned", "canary", "windows_total", "symbols_total",
})

# deprecation shims and where they are allowed to live
SHIM_MODULES = ("repro_torch.kernels.cyclic_fused",)
SHIM_ATTRS = ("_signature_many_bucketed",)
SHIM_HOME = (f"{PKG}/data/dedup.py", f"{PKG}/kernels/cyclic_fused.py",
             f"{PKG}/kernels/sketch_fused.py")

# torch's sampling functions (torch.<name>) and in-place samplers
# (<tensor>.<name>), each of which takes a generator=
TORCH_DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "multinomial", "bernoulli", "normal", "poisson",
})
TENSOR_DRAWS = frozenset({
    "random_", "uniform_", "normal_", "bernoulli_", "exponential_",
    "geometric_", "cauchy_", "log_normal_",
})

_INT32_RE = re.compile(r"\bint32\b")        # \b keeps uint32 from matching
_UINT64_RE = re.compile(r"\buint64\b")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str       # repo-relative
    line: int
    message: str

    def __str__(self):
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _repo_root() -> Path:
    return Path(__file__).resolve().parents[3]


def _in(rel: str, *prefixes: str) -> bool:
    return any(rel == p or rel.startswith(p.rstrip("/") + "/")
               for p in prefixes)


def _seg(src_lines, node) -> str:
    """Source text of a node (single segment, best effort)."""
    try:
        return ast.get_source_segment("\n".join(src_lines), node) or ""
    except (TypeError, ValueError, IndexError):
        return ""


# ---------------------------------------------------------------------------
# rules — each: (tree, src, rel) -> findings appended
# ---------------------------------------------------------------------------


def _is_cast(node) -> bool:
    """``x.astype(...)`` or ``x.to(...)``: the fix shape."""
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr in ("astype", "to"))


def _rule_u64_bincount(tree, src: str, rel: str, out: List[Finding]) -> None:
    if not _in(rel, PKG):
        return
    lines = src.splitlines()

    def assigned_from_u64(fn, name: str, before: int) -> bool:
        hit = False
        for sub in ast.walk(fn):
            if (isinstance(sub, ast.Assign) and sub.lineno < before
                    and any(isinstance(t, ast.Name) and t.id == name
                            for t in sub.targets)):
                hit = bool(_UINT64_RE.search(_seg(lines, sub.value)))
        return hit

    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Module)):
            continue
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "bincount" and node.args):
                continue
            arg = node.args[0]
            if _is_cast(arg):
                continue
            flagged = bool(_UINT64_RE.search(_seg(lines, arg)))
            if (not flagged and isinstance(arg, ast.Name)
                    and not isinstance(fn, ast.Module)):
                flagged = assigned_from_u64(fn, arg.id, node.lineno)
            if flagged:
                out.append(Finding(
                    "U64-BINCOUNT", rel, node.lineno,
                    "bincount on a uint64 value (no safe intp cast) — "
                    "route through .astype(np.int64) first"))


def _rule_i32_counter(tree, src: str, rel: str, out: List[Finding]) -> None:
    if not _in(rel, f"{PKG}/data", f"{PKG}/serve"):
        return
    lines = src.splitlines()

    def is_counter_init(value) -> bool:
        # a *counter* init is a zero-valued int32 constructor (zeros(...),
        # full(..., 0), tensor(0, ...)); casting incoming token-ID arrays
        # to int32 is not a counter
        text = _seg(lines, value)
        if not _INT32_RE.search(text):
            return False
        if "zeros" in text:
            return True
        return any(isinstance(sub, ast.Constant) and sub.value == 0
                   for sub in ast.walk(value))

    def check(name: Optional[str], value, lineno: int) -> None:
        if name in COUNTER_NAMES and is_counter_init(value):
            out.append(Finding(
                "I32-COUNTER", rel, lineno,
                f"stream counter {name!r} initialized as int32 — wraps "
                f"negative at ~2.1B; use the uint32 (lo, hi) pair idiom"))

    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    check(tgt.id, node.value, node.lineno)
        elif isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    check(k.value, v, getattr(v, "lineno", node.lineno))


def _rule_shim_import(tree, src: str, rel: str, out: List[Finding]) -> None:
    if _in(rel, *SHIM_HOME) or SHIM_MARKER in src:
        return
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name in SHIM_MODULES:
                    out.append(Finding(
                        "SHIM-IMPORT", rel, node.lineno,
                        f"import of deprecation shim {alias.name} — use the "
                        f"plan engine (api.run); oracles opt in with a "
                        f"'{SHIM_MARKER}' marker"))
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if (mod in SHIM_MODULES
                    or any(f"{mod}.{a.name}" in SHIM_MODULES
                           for a in node.names)
                    or any(a.name in SHIM_ATTRS for a in node.names)):
                out.append(Finding(
                    "SHIM-IMPORT", rel, node.lineno,
                    f"import from deprecation shim ({mod or 'shim attr'}) — "
                    f"use the plan engine; oracles opt in with a "
                    f"'{SHIM_MARKER}' marker"))
        elif (isinstance(node, ast.Attribute)
              and node.attr in SHIM_ATTRS):
            out.append(Finding(
                "SHIM-IMPORT", rel, node.lineno,
                f"use of deprecated {node.attr} — a test-only oracle; "
                f"stream the documents through run_stream. Oracles opt in "
                f"with a '{SHIM_MARKER}' marker"))


def _rule_unseeded_rng(tree, src: str, rel: str, out: List[Finding]) -> None:
    if not _in(rel, f"{PKG}/core", f"{PKG}/kernels"):
        return
    SEEDLESS_OK = {"default_rng", "SeedSequence", "Generator"}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if not isinstance(f, ast.Attribute):
            continue
        base = f.value
        seeded = any(kw.arg == "generator" for kw in node.keywords)
        is_np_random = (isinstance(base, ast.Attribute)
                        and base.attr == "random"
                        and isinstance(base.value, ast.Name)
                        and base.value.id in ("np", "numpy"))
        is_torch = isinstance(base, ast.Name) and base.id == "torch"
        if is_np_random and f.attr not in SEEDLESS_OK:
            out.append(Finding(
                "UNSEEDED-RNG", rel, node.lineno,
                f"np.random.{f.attr} uses the global unseeded RNG — "
                f"bit-identity contracts require an explicit seed "
                f"(np.random.default_rng(seed) / a torch.Generator)"))
        elif (f.attr == "default_rng" and not node.args
              and not node.keywords):
            out.append(Finding(
                "UNSEEDED-RNG", rel, node.lineno,
                "default_rng() without a seed — bit-identity contracts "
                "require explicit seeding"))
        elif ((is_torch and f.attr in TORCH_DRAWS)
              or (not is_torch and f.attr in TENSOR_DRAWS)) and not seeded:
            what = f"torch.{f.attr}" if is_torch else f"Tensor.{f.attr}"
            out.append(Finding(
                "UNSEEDED-RNG", rel, node.lineno,
                f"{what} without generator= draws from torch's global "
                f"RNG — bit-identity contracts require an explicit, "
                f"seeded torch.Generator"))


# exception names whose silent swallow in the fault-bearing layers drops a
# typed failure on the floor (bare Exception catches everything, so it is
# in the set too)
FAULT_NAMES = frozenset({
    "Exception", "BaseException", "InjectedFailure", "WorkerCrash",
    "ProbeTimeout", "SnapshotInterrupt", "DataCorruption",
    "_RETRYABLE", "_FAILOVER",
})


def _rule_swallowed_fault(tree, src: str, rel: str,
                          out: List[Finding]) -> None:
    if not _in(rel, f"{PKG}/data", f"{PKG}/train"):
        return

    def names(expr) -> List[str]:
        # `except X` / `except (X, Y)` / `except mod.X` / bare `except`
        if expr is None:
            return ["Exception"]
        if isinstance(expr, ast.Tuple):
            return [n for e in expr.elts for n in names(e)]
        if isinstance(expr, ast.Name):
            return [expr.id]
        if isinstance(expr, ast.Attribute):
            return [expr.attr]
        return []

    def inert(stmt) -> bool:
        # statements that observe nothing: pass, continue, bare constants
        # (docstrings/ellipsis). `...` parses as Expr(Constant).
        if isinstance(stmt, (ast.Pass, ast.Continue)):
            return True
        return (isinstance(stmt, ast.Expr)
                and isinstance(stmt.value, ast.Constant))

    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        caught = set(names(node.type))
        if not caught & FAULT_NAMES:
            continue
        if all(inert(s) for s in node.body):
            what = ", ".join(sorted(caught & FAULT_NAMES))
            out.append(Finding(
                "SWALLOWED-FAULT", rel, node.lineno,
                f"except {what} with an inert body drops a typed failure "
                f"without counting, queueing, or re-raising — recovery "
                f"paths must be observable (bump a counter, queue a "
                f"repair, or re-raise)"))


RULES: List[Callable] = [
    _rule_u64_bincount, _rule_i32_counter, _rule_shim_import,
    _rule_unseeded_rng, _rule_swallowed_fault,
]


def lint_file(path: Path, root: Optional[Path] = None) -> List[Finding]:
    """All rules over one file (each rule applies its own scope filter)."""
    root = Path(root) if root else _repo_root()
    rel = str(Path(path).resolve().relative_to(Path(root).resolve()))
    src = Path(path).read_text()
    tree = ast.parse(src, filename=rel)
    out: List[Finding] = []
    for rule in RULES:
        rule(tree, src, rel, out)
    return out


def scan_files(root: Optional[Path] = None) -> List[Path]:
    """The port's sources and its tests under ``root`` (default: the
    checkout this module lies in)."""
    root = Path(root) if root else _repo_root()
    return (sorted((root / PKG).rglob("*.py"))
            + sorted((root / "tests").glob("test_torch_*.py")))


def lint_tree(root: Optional[Path] = None) -> List[Finding]:
    """All rules over the port (``src/repro_torch`` and
    ``tests/test_torch_*.py``); a root that holds none of them is a
    finding, not a clean pass."""
    root = Path(root) if root else _repo_root()
    files = scan_files(root)
    if not files:
        return [Finding("NO-FILES", str(root), 0,
                        f"no {PKG}/**/*.py or tests/test_torch_*.py under "
                        f"this root: the lint read nothing")]
    findings: List[Finding] = []
    for path in files:
        findings.extend(lint_file(path, root))
    return findings
