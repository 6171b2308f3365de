"""Launch and dispatch contracts: declared structural invariants, one verifier.

Every performance claim of the port's entry points is a structural
property of what one call issues, promised in a docstring:

* one plan launch per call (per group of eight sketches) — the fused
  epilogues' claim;
* one dispatch per stream for the ``scan`` executor (one CUDA-graph
  replay) and the ``grid`` executor, one per chunk for ``host``;
* one decode launch per serving step, and per shard under a mesh;
* exactly d - 1 merges of each global sketch's per-shard partials, none
  for row sketches and none in the serving plane;
* a carry updated in place where the entry says it is;
* dynamic shared memory within what the card grants a block;
* outputs in the reference's dtypes.

The JAX package declares these next to each entry point and checks them
on the traced jaxpr (``repro/analysis/contracts.py``). The port has no
jaxpr, so a contract here is checked by a **census**: the entry point runs
once and the counters the port already keeps are read before and after.
The reference's fields map as follows.

* ``pallas_calls`` -> ``launches``: launches of the wrapper named by
  ``kernel`` (``"plan"``: ``sketch_fused.LAUNCHES``; ``"decode"``:
  ``decode.LAUNCHES``) for each sketch group, shard and chunk, and no
  launch of any other wrapper. The plain path launches nothing, so
  launches are checked on the card only.
* ``scans`` / ``while_loops`` -> ``dispatches``:
  ``stream.dispatch_count()`` plus ``sessions.dispatch_count()``; an
  exact count, or ``"chunk"`` (one per chunk) or ``"block"`` (one per
  stream on the card, one per chunk through the plain loop).
* ``collectives`` -> ``merges``: ``shard.merge_count()`` by operator.
  ``"global-sketch-merge"`` means exactly d - 1 ``maximum`` merges for each
  HLL sketch and d - 1 ``add`` merges for each CountMin sketch on a mesh of
  d shards, none without a mesh; ``"none"`` means no merge at all.
* ``donated`` -> in-place identity: every leaf of a declared tree keeps
  its storage (``data_ptr``) across the call, and the caller's own state
  is never written. A plan entry that declares donation folds every
  launch after a block's first into its carry in place
  (``sketch_fused.DONATED_LAUNCHES``, checked on the card); one that does
  not declare it donates no launch.
* ``vmem_budget`` -> shared memory: each launcher caps the dynamic shared
  memory it asks for at a constant compiled into it (:data:`SMEM_CAPS`);
  on the card every cap must lie within the opt-in limit per block that
  the device reports (:func:`device_smem_limit`).
* the x64-leak check -> output dtypes: every tensor an entry returns is
  uint32, int32 or float32, and a plan's sketches have their
  ``state_struct`` dtypes; the plain path's int64 lanes never leak out.

:func:`kernel_contract` attaches the declaration to the function and
registers it; it returns the function unchanged. :func:`verify_contracts`
runs every registered entry across both hash families, no mesh and the
given shard counts, and diffs each census against its declaration. The
census runs each entry once on the card first, so a one-time graph capture
(whose warm-up launches the chunk loop once more) or a build is not
counted.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["KernelContract", "kernel_contract", "registry", "contract_for",
           "Census", "take_census", "check_census", "expected_merges",
           "verify_contracts", "Violation", "OUTPUT_DTYPES",
           "SMEM_CAPS", "device_smem_limit"]

# what the reference's entry points return: uint32 hashes and signatures,
# int32 counts and registers, float32 logits
OUTPUT_DTYPES = (torch.uint32, torch.int32, torch.float32)

# the most dynamic shared memory (bytes) each launcher asks for a block,
# fixed when it is compiled: csrc/sketch_plan.cu's kMaxHllSmem (the HLL
# register files and bitmaps of b <= kMaxSharedB = 14) and csrc/decode.cu's
# staged filter row, 4 * kStageMaxWords
SMEM_CAPS = {"plan": (4 << 14) + (1 << 14) // 8, "decode": 4 * 8192}

_MERGE_RULES = ("none", "global-sketch-merge")
_DISPATCH_RULES = ("chunk", "block")


@dataclasses.dataclass(frozen=True)
class KernelContract:
    """Declared structural invariants of one entry point (``None`` field =
    not checked for that entry)."""

    kernel: Optional[str] = None      # the wrapper the entry launches
    launches: Optional[int] = None    # per sketch group, shard and chunk
    dispatches: Union[None, int, str] = None   # exact, "chunk" or "block"
    merges: str = "none"              # "none" | "global-sketch-merge"
    donated: Tuple[str, ...] = ()     # trees updated in place
    variant: str = ""                 # e.g. the stream executor's name

    def __post_init__(self):
        if self.merges not in _MERGE_RULES:
            raise ValueError(f"unknown merge rule {self.merges!r}; expected "
                             f"one of {_MERGE_RULES}")
        if (isinstance(self.dispatches, str)
                and self.dispatches not in _DISPATCH_RULES):
            raise ValueError(f"unknown dispatch rule {self.dispatches!r}; "
                             f"expected an int or one of {_DISPATCH_RULES}")
        if (self.launches is None) != (self.kernel is None):
            raise ValueError("launches and kernel are declared together")


_REGISTRY: Dict[str, Callable] = {}


def kernel_contract(**fields):
    """Attach a :class:`KernelContract` to an entry point and register it.

    Stacks: an entry with several execution modes declares one contract per
    ``variant`` (``stream.run_stream`` does this for its scan, grid and
    host executors). The function object is returned unchanged."""
    contract = KernelContract(**fields)

    def deco(fn):
        contracts = dict(getattr(fn, "__kernel_contracts__", {}))
        if contract.variant in contracts:
            raise ValueError(
                f"{fn.__qualname__}: duplicate contract variant "
                f"{contract.variant!r}")
        contracts[contract.variant] = contract
        fn.__kernel_contracts__ = contracts
        _REGISTRY[f"{fn.__module__}.{fn.__qualname__}"] = fn
        return fn

    return deco


def registry() -> Dict[str, Dict[str, KernelContract]]:
    """``{entry_name: {variant: contract}}`` of everything registered."""
    return {name: dict(fn.__kernel_contracts__)
            for name, fn in _REGISTRY.items()}


def contract_for(fn, variant: str = "") -> KernelContract:
    """The declared contract of ``fn`` (unwrapping bound methods)."""
    fn = getattr(fn, "__func__", fn)
    contracts = getattr(fn, "__kernel_contracts__", None)
    if not contracts or variant not in contracts:
        raise KeyError(f"{getattr(fn, '__qualname__', fn)!r} declares no "
                       f"kernel contract (variant={variant!r})")
    return contracts[variant]


# ---------------------------------------------------------------------------
# the census: one call, the port's counters read around it
# ---------------------------------------------------------------------------


def _launch_counts() -> Dict[str, int]:
    from repro_torch.kernels import (bloom, cyclic, decode, general, hll,
                                     sketch_fused)
    return {"plan": sketch_fused.LAUNCHES, "decode": decode.LAUNCHES,
            "lookup": sketch_fused.LOOKUP_LAUNCHES,
            "cyclic": cyclic.LAUNCHES, "general": general.LAUNCHES,
            "bloom": bloom.LAUNCHES, "hll": hll.LAUNCHES,
            "donated": sketch_fused.DONATED_LAUNCHES}


def _dispatch_count() -> int:
    from repro_torch.kernels import stream
    from repro_torch.serve import sessions
    return stream.dispatch_count() + sessions.dispatch_count()


def _merge_count() -> Dict[str, int]:
    from repro_torch.kernels import shard
    return shard.merge_count()


def _leaves(tree, path: str = ""):
    """``(path, tensor)`` for every tensor leaf of a tree of dicts, lists
    and tuples."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


@dataclasses.dataclass(frozen=True)
class Census:
    """What one call issued and did (each count a difference of counters
    read before and after it)."""

    launches: Dict[str, int]   # kernel launches by wrapper (nonzero only)
    donated: int               # plan launches folded into their carry
    dispatches: int            # stream + session-pool dispatches
    merges: Dict[str, int]     # cross-shard merges by operator (nonzero)
    moved: Tuple[str, ...]     # in-place leaves whose storage changed
    written: Tuple[str, ...]   # caller-state leaves the call changed
    tracked: Tuple[str, ...]   # the trees watched for the two above
    result: object = None


def take_census(fn: Callable[[], object], *,
                inplace: Optional[Mapping[str, Callable[[], object]]] = None,
                kept: Optional[Mapping[str, object]] = None) -> Census:
    """Run ``fn()`` once and record what it issued.

    ``inplace``: ``{name: getter}`` of trees whose every tensor leaf must
    keep its storage across the call (the getter is read before and after,
    so an attribute the call reassigns is seen). ``kept``: ``{name: tree}``
    of the caller's own state, which the call must not write."""
    inplace, kept = dict(inplace or {}), dict(kept or {})
    ptrs0 = {name: {p: t.data_ptr() for p, t in _leaves(get())}
             for name, get in inplace.items()}
    kept0 = {name: {p: _host(t) for p, t in _leaves(tree)}
             for name, tree in kept.items()}
    l0, d0, m0 = _launch_counts(), _dispatch_count(), _merge_count()
    result = fn()
    l1, d1, m1 = _launch_counts(), _dispatch_count(), _merge_count()
    moved = []
    for name, get in inplace.items():
        now = {p: t.data_ptr() for p, t in _leaves(get())}
        moved += [f"{name}{p}" for p in sorted(set(now) | set(ptrs0[name]))
                  if now.get(p) != ptrs0[name].get(p)]
    written = [f"{name}{p}" for name, tree in kept.items()
               for p, t in _leaves(tree)
               if not np.array_equal(_host(t), kept0[name].get(p))]
    launches = {k: l1[k] - l0[k] for k in l1 if k != "donated"}
    merges = {k: m1.get(k, 0) - m0.get(k, 0) for k in m1}
    return Census(
        launches={k: v for k, v in launches.items() if v},
        donated=l1["donated"] - l0["donated"], dispatches=d1 - d0,
        merges={k: v for k, v in merges.items() if v},
        moved=tuple(moved), written=tuple(written),
        tracked=tuple(inplace) + tuple(kept), result=result)


def expected_merges(contract: KernelContract, plan=None,
                    mesh=None) -> Dict[str, int]:
    """Resolve the contract's merge rule against a plan and a mesh."""
    if contract.merges == "none" or plan is None or mesh is None:
        return {}
    from repro_torch.kernels.plan import CountMinSpec, HLLSpec
    counts = {"maximum": 0, "add": 0}
    for _, spec in plan.sketches:
        if isinstance(spec, HLLSpec):
            counts["maximum"] += mesh.size - 1
        elif isinstance(spec, CountMinSpec):
            counts["add"] += mesh.size - 1
    return {k: v for k, v in counts.items() if v}


def device_smem_limit(device) -> int:
    """The dynamic shared memory a block may opt in to on ``device``, as the
    card reports it (227 KiB on an H100)."""
    props = torch.cuda.get_device_properties(torch.device(device))
    return int(props.shared_memory_per_block_optin)


def check_census(contract: KernelContract, census: Census, *, plan=None,
                 mesh=None, chunks: int = 1,
                 card: bool = False) -> List[str]:
    """Diff one census against one declaration; returns findings (empty =
    the contract holds). ``plan``/``mesh``/``chunks``: what the call ran
    (a plan's sketch groups, the mesh's shards and the chunks each shard
    folded multiply the declared launches). ``card``: the call ran the
    kernels, so launches and donated launches are checked too."""
    from repro_torch.kernels import sketch_fused
    findings: List[str] = []
    shards = mesh.size if mesh is not None else 1
    groups = (len(sketch_fused.sketch_groups(plan.sketches))
              if plan is not None else 1)
    units = groups * shards * chunks
    if card and contract.launches is not None:
        want = {contract.kernel: contract.launches * units}
        if census.launches != want:
            findings.append(f"launches: counted {census.launches}, contract "
                            f"says {want}")
    if card and contract.kernel == "plan":
        want = units - groups * shards if contract.donated else 0
        if census.donated != want:
            findings.append(f"donated plan launches: counted "
                            f"{census.donated}, contract says {want}")
    want = contract.dispatches
    if want == "chunk" or (want == "block" and not card):
        want = chunks
    elif want == "block":
        want = 1
    if want is not None and census.dispatches != want:
        findings.append(f"dispatches: counted {census.dispatches}, contract "
                        f"says {want}")
    want = expected_merges(contract, plan, mesh)
    for op in sorted(set(want) | set(census.merges)):
        if census.merges.get(op, 0) != want.get(op, 0):
            findings.append(f"merge {op}: counted "
                            f"{census.merges.get(op, 0)}, contract says "
                            f"{want.get(op, 0)}")
    # a plan entry's donation shows in its donated launches; any other's in
    # the storage of the tree it names, which the census must watch
    for name in contract.donated if contract.kernel != "plan" else ():
        if name not in census.tracked:
            findings.append(f"contract declares {name!r} donated but the "
                            f"census watched no such tree")
    for leaf in census.moved:
        findings.append(f"{leaf} was not updated in place (its storage "
                        f"changed)")
    for leaf in census.written:
        findings.append(f"the caller's {leaf} was written (donated)")
    for path, t in _leaves(census.result):
        if t.dtype not in OUTPUT_DTYPES:
            findings.append(f"output{path} is {t.dtype}: the reference "
                            f"returns {', '.join(map(str, OUTPUT_DTYPES))}"
                            f" (x64 leak)")
    if plan is not None and isinstance(census.result, dict):
        for name, spec in plan.sketches:
            got = census.result.get(name)
            want = getattr(torch, spec.state_struct(0)[1])
            if isinstance(got, torch.Tensor) and got.dtype != want:
                findings.append(f"sketch {name!r} is {got.dtype}, its "
                                f"state_struct says {want}")
    return findings


@dataclasses.dataclass(frozen=True)
class Violation:
    entry: str      # registry name, e.g. "repro_torch.kernels.api.run"
    variant: str    # contract variant ("" for the only one)
    config: str     # which matrix cell, e.g. "family=cyclic d=4"
    message: str

    def __str__(self):
        v = f"[{self.variant}]" if self.variant else ""
        return f"{self.entry}{v} ({self.config}): {self.message}"


# ---------------------------------------------------------------------------
# the verification matrix: one harness per registered entry point
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Matrix:
    """One run of :func:`verify_contracts`: where it runs, over what."""

    device: torch.device
    families: Tuple[str, ...]
    meshes: Tuple[object, ...]      # DataMesh for each shard count
    results: List[Violation]

    @property
    def card(self) -> bool:
        return self.device.type == "cuda"

    @property
    def impl(self) -> str:
        return "kernel" if self.card else "ref"

    def census(self, fn, **kw) -> Census:
        if self.card:       # a first call captures, builds and primes
            fn()
            torch.cuda.synchronize(self.device)
        census = take_census(fn, **kw)
        if self.card:
            torch.cuda.synchronize(self.device)
        return census

    def check(self, entry, variant: str, config: str, census: Census,
              **kw) -> None:
        contract = contract_for(entry, variant)
        fn = getattr(entry, "__func__", entry)
        name = f"{fn.__module__}.{fn.__qualname__}"
        for msg in check_census(contract, census, card=self.card, **kw):
            self.results.append(Violation(name, variant, config, msg))


def _mesh(d: int, device: torch.device):
    """d shards on ``device``'s kind: the first d cards where there are
    that many, else d virtual shards of the first (on the CPU always)."""
    from repro_torch.kernels import shard
    if device.type == "cuda" and d > torch.cuda.device_count():
        return shard.DataMesh((torch.device("cuda", 0),) * d)
    return shard.data_mesh(d, device)


def _sketch_plan(family: str):
    from repro_torch.kernels.plan import (BloomSpec, CountMinSpec, HashSpec,
                                          HLLSpec, MinHashSpec, SketchPlan)
    return SketchPlan(
        HashSpec(family=family, n=8, L=32),
        (("sig", MinHashSpec(k=16)), ("card", HLLSpec(b=4)),
         ("dec", BloomSpec(k=3, log2_m=14)),
         ("freq", CountMinSpec(depth=3, log2_width=8))))


def _u32(rng, shape, device) -> torch.Tensor:
    return torch.from_numpy(
        rng.integers(0, 2**32, shape, dtype=np.uint32)).to(device)


def _sketch_args(device, B=4, S=320, seed=0):
    """(h1v, h1v_b, operands) for :func:`_sketch_plan`, from a seeded numpy
    generator."""
    rng = np.random.default_rng(seed)
    ops = {"sig": {"a": _u32(rng, (16,), device),
                   "b": _u32(rng, (16,), device)},
           "dec": {"bits": _u32(rng, (1 << 9,), device)},
           "freq": {"a": _u32(rng, (3,), device),
                    "b": _u32(rng, (3,), device)}}
    return _u32(rng, (B, S), device), _u32(rng, (B, S), device), ops


def _verify_api_run(m: _Matrix) -> None:
    from repro_torch.kernels import api
    for family in m.families:
        plan = _sketch_plan(family)
        x, xb, ops = _sketch_args(m.device)
        c = m.census(lambda: api.run(plan, x, h1v_b=xb, operands=ops,
                                     impl=m.impl))
        m.check(api.run, "", f"family={family}", c, plan=plan)


def _verify_run_stream(m: _Matrix) -> None:
    from repro_torch.kernels import stream
    chunk_s, S = 64, 512
    for family in m.families:
        plan = _sketch_plan(family)
        x, xb, ops = _sketch_args(m.device, S=S)
        for variant, chunks in (("scan", S // chunk_s), ("grid", 1),
                                ("host", S // chunk_s)):
            for mesh in (None,) + m.meshes:
                cfg = f"family={family} d={mesh.size if mesh else 'single'}"
                c = m.census(lambda: stream.run_stream(
                    plan, x, chunk_s=chunk_s, h1v_b=xb, operands=ops,
                    impl=m.impl, executor=variant, mesh=mesh))
                m.check(stream.run_stream, variant, cfg, c, plan=plan,
                        mesh=mesh, chunks=chunks)
        # the block behind "scan" never writes the caller's carry
        state = stream.init_state(plan, 4, device=m.device)
        tile = lambda t: (t.view(torch.int32).reshape(4, S // chunk_s,
                                                      chunk_s)
                          .transpose(0, 1).contiguous().view(torch.uint32))
        c = m.census(lambda: stream.update_many(
            plan, state, tile(x), chunk_b=tile(xb), operands=ops,
            impl=m.impl), kept={"state": state})
        for leaf in c.written:
            m.results.append(Violation(
                "repro_torch.kernels.stream.update_many", "scan",
                f"family={family}", f"the caller's {leaf} was written "
                f"(donated)"))


def _verify_run_sharded(m: _Matrix) -> None:
    from repro_torch.kernels import shard
    for family in m.families:
        plan = _sketch_plan(family)
        x, xb, ops = _sketch_args(m.device)
        for mesh in m.meshes:
            c = m.census(lambda: shard.run_sharded(
                plan, x, h1v_b=xb, operands=ops, impl=m.impl, mesh=mesh))
            m.check(shard.run_sharded, "", f"family={family} d={mesh.size}",
                    c, plan=plan, mesh=mesh)


def _decode_spec():
    from repro_torch.kernels.plan import DecodeSpec
    return DecodeSpec(n=4, log2_m=8, canary_log2_m=8)


def _verify_decode(m: _Matrix) -> None:
    from repro_torch.kernels import api
    spec = _decode_spec()
    rng = np.random.default_rng(2)
    B, V = 4, 128
    logits = torch.from_numpy(
        rng.standard_normal((B, V)).astype(np.float32)).to(m.device)
    prefix = _u32(rng, (B,), m.device)
    ready = torch.ones((B,), dtype=torch.int32, device=m.device)
    bloom = _u32(rng, (B, spec.n_words), m.device)
    h1 = _u32(rng, (V,), m.device)
    cb = _u32(rng, (spec.canary_words,), m.device)
    c = m.census(lambda: api.decode(spec, logits, prefix, ready, bloom, h1,
                                    canary_bits=cb, impl=m.impl))
    m.check(api.decode, "", f"spec={spec.n}-gram", c)


def _verify_session_step(m: _Matrix) -> None:
    from repro_torch.serve import sessions
    spec = _decode_spec()
    V, C = 64, 8
    rng = np.random.default_rng(15)
    h1 = _u32(rng, (V,), m.device)
    cb = _u32(rng, (spec.canary_words,), m.device)
    logits = torch.from_numpy(
        rng.standard_normal((C, V)).astype(np.float32)).to(m.device)
    prompt = torch.from_numpy(rng.integers(0, V, (C, 5))).to(m.device)
    for mesh in (None,) + tuple(d for d in m.meshes if C % d.size == 0):
        pool = sessions.SessionPool(spec, C, h1, canary_bits=cb,
                                    impl=m.impl, device=m.device, mesh=mesh)
        pool.admit(C)
        pool.prime(prompt)
        gen = torch.Generator(device=m.device).manual_seed(0)
        c = m.census(lambda: pool.step(logits, generator=gen,
                                       temperature=0.8, top_k=5),
                     inplace={"state": lambda: pool.state})
        m.check(sessions.SessionPool.step, "",
                f"d={mesh.size if mesh else 'single'}", c, mesh=mesh)


def _verify_rowwise(m: _Matrix) -> None:
    from repro_torch.kernels import shard

    def per_row(rows, scale):
        return {"y": rows["a"] * scale + rows["b"]}

    rows = {"a": torch.ones((8, 4), device=m.device),
            "b": torch.zeros((8, 4), device=m.device)}
    scale = torch.tensor(2.0, device=m.device)
    for mesh in m.meshes:
        c = m.census(lambda: shard.rowwise(per_row, mesh, n_row=1)(rows,
                                                                   scale))
        m.check(shard.rowwise, "", f"d={mesh.size}", c, mesh=mesh)


_HARNESSES = (_verify_api_run, _verify_run_stream, _verify_run_sharded,
              _verify_decode, _verify_session_step, _verify_rowwise)


def verify_contracts(device="cuda", device_counts=(1, 4),
                     families=("cyclic", "general")) -> List[Violation]:
    """Run every registered entry point across both hash families, no mesh
    and a mesh of each of ``device_counts`` shards, and diff each census
    against its declared contract. Returns the violations (empty list =
    every contract holds).

    On ``cuda`` the entries launch the kernels (``impl="kernel"``); a shard
    count above the card count is that many virtual shards of the first
    card. On ``cpu`` they take the plain path (``impl="ref"``), the shards
    are virtual, and launches and shared memory are not checked. On the
    card each launcher's :data:`SMEM_CAPS` entry is held against
    :func:`device_smem_limit`.

    The entry-point modules are imported here, not at module import, so
    the decorator stays importable from inside ``repro_torch.kernels``
    without a cycle."""
    # importing registers the decorated entry points
    from repro_torch.kernels import api, shard, stream     # noqa: F401
    from repro_torch.serve import sessions                 # noqa: F401

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("verify_contracts(device='cuda') needs a CUDA "
                           "card; pass device='cpu' for the plain path")
    m = _Matrix(device, tuple(families),
                tuple(_mesh(d, device) for d in device_counts), [])
    if m.card:
        limit = device_smem_limit(device)
        for kernel, cap in SMEM_CAPS.items():
            if cap > limit:
                m.results.append(Violation(
                    kernel, "", str(device), f"the launcher may ask for {cap}"
                    f" bytes of shared memory a block; the card grants "
                    f"{limit}"))
    for harness in _HARNESSES:
        harness(m)
    return m.results
