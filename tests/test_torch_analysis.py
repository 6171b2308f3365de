"""The port's analyzer analyzed: seeded violations MUST be flagged, the clean
port MUST be silent.

A static analyzer that never fires is indistinguishable from one that works;
every checker of ``repro_torch.analysis`` is exercised from both sides, as
``tests/test_analysis.py`` exercises the reference's:

* seeded-violation fixtures — a second dispatch, a dropped in-place carry,
  a caller's state written, an unexpected merge, an int64 output, a probe
  derived from undiscarded high bits (traced by ``make_fx``), DS1/DS2 on a
  consumer file, each lint rule on a fixture — each must produce its
  finding;
* the clean port — lint, the discard checker (both halves) and the CPU
  contract matrix must all come back empty, which is what ``python -m
  repro_torch.analysis --device cpu`` enforces;
* the lint rules the two packages share give the same rule IDs and lines
  on the same fixture source.

Launch counts and shared memory are checked on the card only
(``tests/test_torch_on_card.py``, ``chip_smoke.py`` phase 12).
"""
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro.analysis import lint as jlint
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import contracts, discard, lint
from repro_torch.kernels import api, ref, shard, stream
from repro_torch.kernels.plan import (DecodeSpec, HashSpec, HLLSpec,
                                      MinHashSpec, SketchPlan)
from repro_torch.serve import sessions

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _plan(family="cyclic"):
    return contracts._sketch_plan(family)


def _args(S=320):
    return contracts._sketch_args(CPU, B=4, S=S)


# ---------------------------------------------------------------------------
# the registry and the clean matrix
# ---------------------------------------------------------------------------


def test_registry_covers_every_entry_point():
    reg = contracts.registry()
    names = {k.rsplit(".", 1)[-1] for k in reg}
    assert {"run", "decode", "run_stream", "run_sharded", "rowwise",
            "step"} <= names
    rs = next(v for k, v in reg.items() if k.endswith("run_stream"))
    assert set(rs) == {"scan", "grid", "host"}
    assert rs["scan"].donated == ("state",)
    step = contracts.contract_for(sessions.SessionPool.step)
    assert (step.kernel, step.launches, step.donated) == ("decode", 1,
                                                          ("state",))
    # the decorator hands the function back unchanged
    assert api.run.__name__ == "run" and callable(api.run)


@pytest.mark.parametrize("family", ["cyclic", "general"])
def test_contract_matrix_cpu_clean(family):
    violations = contracts.verify_contracts(
        device="cpu", device_counts=(1, 2, 4, 8), families=(family,))
    assert violations == [], [str(v) for v in violations]


def test_contract_fields_validate():
    with pytest.raises(ValueError, match="merge rule"):
        contracts.KernelContract(merges="psum")
    with pytest.raises(ValueError, match="dispatch rule"):
        contracts.KernelContract(dispatches="scan")
    with pytest.raises(ValueError, match="together"):
        contracts.KernelContract(launches=1)
    with pytest.raises(KeyError, match="declares no kernel contract"):
        contracts.contract_for(stream.update)


# ---------------------------------------------------------------------------
# seeded contract violations
# ---------------------------------------------------------------------------


def test_second_dispatch_is_flagged():
    """The grid executor's contract pins ONE dispatch a stream; a call that
    runs the stream twice must violate it, and the true call passes."""
    plan = _plan()
    x, xb, ops = _args(S=512)
    contract = contracts.contract_for(stream.run_stream, "grid")
    run = lambda: stream.run_stream(plan, x, chunk_s=64, h1v_b=xb,
                                    operands=ops, executor="grid",
                                    device="cpu")

    def doubled():
        run()
        return run()

    findings = contracts.check_census(contract,
                                      contracts.take_census(doubled),
                                      plan=plan)
    assert any("dispatches: counted 2" in f for f in findings), findings
    assert contracts.check_census(contract, contracts.take_census(run),
                                  plan=plan) == []


def _pool(mesh=None):
    spec = DecodeSpec(n=4, log2_m=8, canary_log2_m=8)
    rng = np.random.default_rng(15)
    h1 = rng.integers(0, 2**32, 64, dtype=np.uint32)
    cb = rng.integers(0, 2**32, spec.canary_words, dtype=np.uint32)
    pool = sessions.SessionPool(spec, 8, h1, canary_bits=cb, device="cpu",
                                mesh=mesh)
    pool.admit(8)
    pool.prime(rng.integers(0, 64, (8, 5)))
    logits = torch.from_numpy(rng.standard_normal((8, 64)).astype(
        np.float32))
    return pool, logits


def test_dropped_in_place_carry_is_flagged():
    """SessionPool.step declares its state donated: a step whose carry comes
    back as fresh tensors (the reference's dropped donation) must fire."""
    pool, logits = _pool()
    contract = contracts.contract_for(sessions.SessionPool.step)
    watch = {"state": lambda: pool.state}

    def dropped():
        token = pool.step(logits, temperature=0.0)
        pool.state = {k: v.clone() for k, v in pool.state.items()}
        return token

    census = contracts.take_census(dropped, inplace=watch)
    findings = contracts.check_census(contract, census)
    assert len(findings) == len(pool.state), findings
    assert all("not updated in place" in f for f in findings)
    # the true step passes, and a census that watches nothing is refused
    census = contracts.take_census(lambda: pool.step(logits), inplace=watch)
    assert contracts.check_census(contract, census) == []
    findings = contracts.check_census(
        contract, contracts.take_census(lambda: pool.step(logits)))
    assert any("watched no such tree" in f for f in findings), findings


@pytest.mark.parametrize("d", [2, 4])
def test_session_pool_carry_stays_in_place_under_a_mesh(d):
    """Under a mesh the step's rows come back from the shards into the
    pool's own tensors, so the carry keeps its storage at any shard count
    (the rows equal a pool without a mesh)."""
    pool, logits = _pool(shard.data_mesh(d, "cpu"))
    solo, _ = _pool()
    ptrs = {k: v.data_ptr() for k, v in pool.state.items()}
    for _ in range(3):
        assert torch.equal(pool.step(logits, temperature=0.0),
                           solo.step(logits, temperature=0.0))
    assert {k: v.data_ptr() for k, v in pool.state.items()} == ptrs
    for k, v in pool.state.items():
        view = torch.int32 if v.dtype == torch.uint32 else v.dtype
        assert torch.equal(v.view(view), solo.state[k].view(view)), k


def test_caller_state_written_is_flagged():
    """The block behind the scan executor must never write the caller's
    carry; an update that folds into it in place must fire."""
    plan = _plan()
    x, xb, ops = _args(S=128)
    state = stream.init_state(plan, 4, device="cpu")
    chunks = x.view(torch.int32).reshape(4, 2, 64).transpose(0, 1)
    chunks_b = xb.view(torch.int32).reshape(4, 2, 64).transpose(0, 1)
    u = lambda t: t.contiguous().view(torch.uint32)
    ok = contracts.take_census(
        lambda: stream.update_many(plan, state, u(chunks),
                                   chunk_b=u(chunks_b), operands=ops),
        kept={"state": state})
    assert ok.written == () and ok.dispatches == 2

    def writes_back():
        new = stream.update_many(plan, state, u(chunks), chunk_b=u(chunks_b),
                                 operands=ops)
        state["seen"].copy_(new["seen"])
        return new

    census = contracts.take_census(writes_back, kept={"state": state})
    findings = contracts.check_census(
        contracts.contract_for(stream.run_stream, "scan"), census,
        plan=plan, chunks=2)
    assert findings == ["the caller's state['seen'] was written (donated)"]


def test_unexpected_merge_is_flagged():
    """api.run declares no merge: a call that merges shards' partials (a
    run_sharded at d = 2 of an HLL plan) must fire, once an operator."""
    plan = SketchPlan(HashSpec(family="cyclic", n=8),
                      (("hll", HLLSpec(b=4)),))
    x, _, _ = _args()
    census = contracts.take_census(lambda: shard.run_sharded(
        plan, x, mesh=shard.data_mesh(2, "cpu")))
    assert census.merges == {"maximum": 1}
    findings = contracts.check_census(contracts.contract_for(api.run),
                                      census, plan=plan)
    assert findings == ["merge maximum: counted 1, contract says 0"]
    # run_sharded's own rule expects exactly that merge
    assert contracts.check_census(
        contracts.contract_for(shard.run_sharded), census, plan=plan,
        mesh=shard.data_mesh(2, "cpu")) == []


def test_int64_output_is_flagged():
    """The plain path's int64 lanes must never leak out of an entry point:
    a signature left in its lanes fires as an x64 leak, and as the wrong
    dtype for its sketch."""
    plan = SketchPlan(HashSpec(family="cyclic", n=8),
                      (("sig", MinHashSpec(k=16)),))
    x, _, ops = _args()
    h, valid = ref._masked_windows(x, 8, 32, plan.hash.hash_mask,
                                   torch.full((4,), 313))
    leaky = lambda: {"sig": ref.minhash_reduce(h, valid, ops["sig"]["a"],
                                               ops["sig"]["b"])}
    findings = contracts.check_census(contracts.contract_for(api.run),
                                      contracts.take_census(leaky),
                                      plan=plan)
    assert any("x64 leak" in f for f in findings), findings
    assert any("state_struct says torch.uint32" in f for f in findings)
    good = contracts.take_census(
        lambda: api.run(plan, x, operands={"sig": ops["sig"]}))
    assert contracts.check_census(contracts.contract_for(api.run), good,
                                  plan=plan) == []


def test_merge_count_is_context_local():
    import contextvars
    plan = SketchPlan(HashSpec(family="cyclic", n=8),
                      (("hll", HLLSpec(b=4)),))
    x, _, _ = _args()
    before = shard.merge_count()
    contextvars.copy_context().run(
        lambda: shard.run_sharded(plan, x, mesh=shard.data_mesh(4, "cpu")))
    assert shard.merge_count() == before


# ---------------------------------------------------------------------------
# seeded discard violations (Theorems 1-2)
# ---------------------------------------------------------------------------


def test_probe_from_undiscarded_bits_is_flagged():
    """A probe stride derived from the raw (pre-mask) hash voids the
    pairwise-independence bound; the trace checker must catch it in the
    aten graph, and a renormalising & 0xFFFFFFFF is no discard site."""
    mask = 0x1FFFFFFF
    cand = torch.tensor([7, 1 << 31], dtype=torch.int64)

    def bad(c):
        masked = c & mask                            # the discard site
        stride = (c * 0x9E3779B1) & 0xFFFFFFFF       # ...probes from raw!
        return masked ^ stride

    findings = discard.trace_findings(make_fx(bad)(cand), mask)
    assert findings and "mul" in findings[0], findings

    def good(c):
        masked = c & mask
        stride = (masked * 0x9E3779B1) & 0xFFFFFFFF  # from masked: fine
        lanes = (c ^ 5) & 0xFFFFFFFF     # a renormalisation, no discard
        return masked ^ stride ^ (lanes * 3)

    assert discard.trace_findings(make_fx(good)(cand), mask) == []


def test_renormalised_raw_hash_reaching_a_probe_is_flagged():
    """The plain path's own risk: ``u32.lanes`` renormalises every probe
    helper's input with ``& 0xFFFFFFFF``, which must not launder a raw
    hash. The decode plane's candidates probed before the discard fire;
    probed after it, nothing does; low kept bits (``& 255``) are clean."""
    from repro_torch.core import u32
    spec = DecodeSpec(n=4, log2_m=8)
    rng = np.random.default_rng(9)
    prefix = torch.from_numpy(rng.integers(0, 2**32, 4, dtype=np.uint32))
    h1 = torch.from_numpy(rng.integers(0, 2**32, 64, dtype=np.uint32))
    words = torch.from_numpy(rng.integers(0, 2**32, (4, spec.n_words),
                                          dtype=np.uint32))

    def probes(masked_first):
        def fn(p, h, w):
            cand = (u32.rotl_const(u32.lanes(p), 1, 32)[:, None]
                    ^ u32.lanes(h)[None, :])
            hm = cand & spec.hash_mask
            return ref.bloom_probe_hits(hm if masked_first else cand, w,
                                        spec.k, spec.log2_m)
        return make_fx(fn)(prefix, h1, words)

    findings = discard.trace_findings(probes(False), spec.hash_mask)
    assert findings and any("mul" in f or "add" in f for f in findings)
    assert discard.trace_findings(probes(True), spec.hash_mask) == []
    low = make_fx(lambda c: ((c & spec.hash_mask) ^ (c & 255)) * 3)(
        torch.arange(8))
    assert discard.trace_findings(low, spec.hash_mask) == []


def test_static_discard_rules_on_fixture(tmp_path):
    """DS1 (an L - n shaped shift) and DS2 (an unmasked probe argument, by
    position and by keyword) fire on a consumer file inside the scope."""
    bad = tmp_path / "src" / "repro_torch" / "serve" / "bad_consumer.py"
    bad.parent.mkdir(parents=True)
    bad.write_text(textwrap.dedent("""
        def probe(h, spec, L, n, words):
            high = h >> (L - n)                           # DS1
            hits = bloom_probe_hits(h, words, 4, 20)      # DS2: position
            out = decode_masks_ref(h, hash_mask=0xFFFFFFFF)   # DS2: keyword
            return high ^ hits ^ out

        def ok(h, spec, words, state):
            hm = h & spec.hash_mask
            _bloom_add_rows(state, hm, 4, 20)
            return bloom_probe_hits(hm, words, 4, 20)
    """))
    findings = discard.static_findings(tmp_path)
    assert sorted(f.rule for f in findings) == ["DS1", "DS2", "DS2"], \
        findings
    assert all(f.path.endswith("bad_consumer.py") for f in findings)
    assert [f.line for f in findings if f.rule == "DS2"] == [4, 5]


def test_decode_launch_is_held_to_the_hash_mask(tmp_path):
    """DS2 reads the decode launch in the port's own kernels/decode.py: the
    file as it stands is clean, and the same file with a full-width mask in
    the launch's hash_mask slot is flagged at that call."""
    rel = "src/repro_torch/kernels/decode.py"
    src = (ROOT / rel).read_text()
    fixture = tmp_path / rel
    fixture.parent.mkdir(parents=True)
    fixture.write_text(src)
    assert discard.static_findings(tmp_path) == []
    slot = "spec.L, spec.hash_mask, spec.log2_m"
    assert src.count(slot) == 1
    fixture.write_text(src.replace(slot, "spec.L, 0xFFFFFFFF, spec.log2_m"))
    findings = discard.static_findings(tmp_path)
    assert [f.rule for f in findings] == ["DS2"], findings
    assert "decode_masks()" in findings[0].message


# ---------------------------------------------------------------------------
# seeded lint violations
# ---------------------------------------------------------------------------


def _fixture(root, rel, body):
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(body))
    return path


def test_uint64_unsafe_bincount_is_flagged(tmp_path):
    _fixture(tmp_path, "src/repro_torch/core/fix.py", """
        import numpy as np
        import torch

        def collide(keys):
            combined = keys.astype(np.uint64) << np.uint64(32)
            return np.bincount(combined)            # refuses/truncates u64

        def collide_ok(keys, t):
            combined = keys.astype(np.uint64) << np.uint64(32)
            wide = t.to(torch.uint64)
            return (np.bincount(combined.astype(np.int64)),
                    torch.bincount(wide.to(torch.int64)))
    """)
    findings = lint.lint_tree(tmp_path)
    assert [(f.rule, f.line) for f in findings] == [("U64-BINCOUNT", 7)]


def test_int32_stream_counter_is_flagged(tmp_path):
    _fixture(tmp_path, "src/repro_torch/serve/fix.py", """
        import torch

        def init(C):
            steps = torch.zeros((C,), dtype=torch.int32)   # wraps at ~2.1B
            ring = torch.zeros((C, 8), dtype=torch.int32)  # bounded
            return {"tokens": torch.full((C,), 0, dtype=torch.int32),
                    "count": torch.zeros((C,), dtype=torch.int32)}
    """)
    findings = lint.lint_tree(tmp_path)
    assert [(f.rule, f.line) for f in findings] == [("I32-COUNTER", 5),
                                                   ("I32-COUNTER", 7)]


def test_shim_import_is_flagged(tmp_path):
    _fixture(tmp_path, "src/repro_torch/data/fix.py", """
        from repro_torch.kernels import cyclic_fused
        import repro_torch.kernels.cyclic_fused

        def sign(dd, docs):
            return dd._signature_many_bucketed(docs)
    """)
    _fixture(tmp_path, "tests/test_torch_fix.py", """
        from repro_torch.kernels.cyclic_fused import cyclic_rolling_fused
    """)
    findings = lint.lint_tree(tmp_path)
    assert [(f.path, f.line) for f in findings] == [
        ("src/repro_torch/data/fix.py", 2), ("src/repro_torch/data/fix.py", 3),
        ("src/repro_torch/data/fix.py", 6), ("tests/test_torch_fix.py", 2)]
    assert {f.rule for f in findings} == {"SHIM-IMPORT"}
    ok = tmp_path / "ok"
    _fixture(ok, "tests/test_torch_fix.py", """
        # lint: allow-deprecated-shims — certification oracle
        import repro_torch.kernels.cyclic_fused
    """)
    _fixture(ok, "src/repro_torch/kernels/sketch_fused.py", """
        import repro_torch.kernels.cyclic_fused     # the shim's home
    """)
    _fixture(ok, "tests/test_other.py", """
        import repro_torch.kernels.cyclic_fused     # not a port test file
    """)
    assert lint.lint_tree(ok) == []


def test_swallowed_fault_is_flagged(tmp_path):
    _fixture(tmp_path, "src/repro_torch/data/fix.py", """
        from repro_torch.train.fault import WorkerCrash, ProbeTimeout

        def probe(worker):
            try:
                return worker.call()
            except WorkerCrash:
                pass                        # typed failure dropped silently
            try:
                return worker.call()
            except (ProbeTimeout, ValueError):
                '''even a docstring body observes nothing'''
            try:
                return worker.call()
            except Exception:
                ...
    """)
    findings = lint.lint_tree(tmp_path)
    assert [f.rule for f in findings] == ["SWALLOWED-FAULT"] * 3, findings
    ok = tmp_path / "ok"
    _fixture(ok, "src/repro_torch/train/fix.py", """
        from repro_torch.train.fault import WorkerCrash

        def probe(worker, t):
            try:
                return worker.call()
            except WorkerCrash:
                t["failed"] += 1            # observable: counted
            try:
                return worker.call()
            except KeyError:
                pass                        # not a fault-plane type
    """)
    assert lint.lint_tree(ok) == []


def test_unseeded_rng_is_flagged(tmp_path):
    _fixture(tmp_path, "src/repro_torch/kernels/fix.py", """
        import numpy as np
        import torch

        def tabulate(t, gen):
            a = np.random.randint(0, 2**32, 256)          # global numpy RNG
            rng = np.random.default_rng()                 # seedless
            b = torch.randint(0, 1 << 32, (256,))          # global torch RNG
            c = torch.randperm(256)
            t.uniform_()                                  # in place, global
            ok = (np.random.default_rng(7),
                  torch.randint(0, 9, (4,), generator=gen),
                  torch.rand((4,), generator=gen), t.normal_(generator=gen),
                  torch.zeros(4))
            return a, rng, b, c, ok
    """)
    findings = lint.lint_tree(tmp_path)
    assert [(f.rule, f.line) for f in findings] == [
        ("UNSEEDED-RNG", line) for line in (6, 7, 8, 9, 10)], findings


# the fixture body of each rule both packages have, and the layer it needs
_SHARED = {
    "U64-BINCOUNT": ("core", """
        import numpy as np

        def collide(keys):
            combined = keys.astype(np.uint64) << np.uint64(32)
            a = np.bincount(combined)
            return a, np.bincount(combined.astype(np.int64))
    """),
    "I32-COUNTER": ("data", """
        import numpy as np

        def init():
            tokens = np.zeros((), np.int32)
            return {"steps": np.zeros((4,), np.int32), "ring": tokens}
    """),
    "SHIM-IMPORT": ("data", """
        def sign(dd, docs):
            return dd._signature_many_bucketed(docs)
    """),
    "UNSEEDED-RNG": ("kernels", """
        import numpy as np

        def draw():
            t = np.random.randint(0, 2**32, 256)
            return t, np.random.default_rng(), np.random.default_rng(3)
    """),
    "SWALLOWED-FAULT": ("data", """
        def probe(worker):
            try:
                return worker.call()
            except WorkerCrash:
                pass
            except Exception:
                ...
    """),
}


@pytest.mark.parametrize("rule", sorted(_SHARED))
def test_lint_matches_reference_on_shared_rules(rule, tmp_path):
    """The same fixture source through the reference's lint_file and the
    port's (each in its own package's scope) gives the same rule IDs and
    lines."""
    layer, body = _SHARED[rule]
    mine = _fixture(tmp_path, f"src/repro_torch/{layer}/fix.py", body)
    theirs = _fixture(tmp_path, f"src/repro/{layer}/fix.py", body)
    got = [(f.rule, f.line) for f in lint.lint_file(mine, tmp_path)]
    want = [(f.rule, f.line) for f in jlint.lint_file(theirs, tmp_path)]
    assert got == want and got and {r for r, _ in got} == {rule}, (got,
                                                                   want)


# ---------------------------------------------------------------------------
# the clean port is silent (the CLI's exact condition)
# ---------------------------------------------------------------------------


def test_clean_tree_zero_lint_findings():
    assert lint.lint_tree() == []
    files = {str(p.relative_to(ROOT)) for p in lint.scan_files()}
    assert {"src/repro_torch/kernels/api.py",
            "tests/test_torch_analysis.py"} <= files


def test_clean_tree_zero_discard_findings():
    assert discard.static_findings() == []
    assert discard.verify_decode_discard() == []
    files = {str(p.relative_to(ROOT)) for p in discard.scope_files()}
    assert {"src/repro_torch/serve/sessions.py",
            "src/repro_torch/kernels/decode.py"} <= files


@pytest.mark.parametrize("checker", ["lint", "discard"])
def test_a_root_without_the_port_is_a_finding(checker, tmp_path):
    """A checker that reads no file must not pass as clean."""
    findings = (lint.lint_tree(tmp_path) if checker == "lint"
                else discard.static_findings(tmp_path))
    assert [f.rule for f in findings] == ["NO-FILES"]


def test_smem_caps_match_the_launchers():
    """contracts.SMEM_CAPS restates the compile-time caps of the two
    launchers that take dynamic shared memory a plan: csrc/sketch_plan.cu's
    kMaxHllSmem and csrc/decode.cu's staged row of kStageMaxWords words."""
    csrc = ROOT / "src/repro_torch/kernels/csrc"
    plan = (csrc / "sketch_plan.cu").read_text()
    b = int(re.search(r"constexpr int kMaxSharedB = (\d+);", plan)[1])
    cap = re.search(r"constexpr int kMaxHllSmem = ([^;]+);", plan)[1]
    assert cap == "(4 << kMaxSharedB) + (1 << kMaxSharedB) / 8"
    assert contracts.SMEM_CAPS["plan"] == (4 << b) + (1 << b) // 8 == 67584
    dec = (csrc / "decode.cu").read_text()
    words = int(re.search(r"constexpr int kStageMaxWords = (\d+);", dec)[1])
    assert contracts.SMEM_CAPS["decode"] == 4 * words


def test_cli_cpu_reports_ok(capsys):
    assert cli.main(["--device", "cpu", "--devices", "1", "2"]) == 0
    out = capsys.readouterr().out
    assert "analysis: OK — 0 total finding(s)" in out
    assert "contracts: " in out and "0 violation(s)" in out


def test_cli_needs_a_card_for_its_contracts(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the contracts run there")
    assert cli.main([]) != 0
    assert "none is available" in capsys.readouterr().err
    assert cli.main(["--lint"]) == 0      # the lint needs no device


def test_analysis_imports_without_jax():
    """The analyzer and the shims import, and the CPU pass runs, with JAX
    and the reference package unavailable."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import repro_torch.kernels.cyclic_fused\n"
            "from repro_torch.analysis import __main__ as cli\n"
            "sys.exit(cli.main(['--device', 'cpu', '--devices', '2']))\n")
    proc = subprocess.run([sys.executable, "-W", "ignore", "-c", code],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=300,
                          env={**os.environ,
                               "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "analysis: OK — 0 total finding(s)" in proc.stdout
