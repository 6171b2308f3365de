"""The port's kernels on the card past the limits they once had, the
decode kernel's ready flags of every type, ``bloom_probe`` through each of
its filter routes, ``general_rolling`` through each of its product routes
and ``hll_update`` in shared and in global registers, each against its plain
version on the same card; and the streaming executor's CUDA-graph replay
against its eager loop and the plain versions: one dispatch a block, the
caller's state unchanged, a restore after a capture bit-identical; and the
multi-device layer (``kernels/shard.py``) on four virtual shards of the
one card, each shard's graph replayed, equal to the one-device calls (a
further case holds the distinct-device path and runs only where there is
more than one card); and the analyzer's contract census with the kernels
(every entry point's launches, dispatches, merges, in-place carries,
dtypes and shared memory) with its negative control, and the deprecated
single-sketch shims through the plan kernel; and the LM's train step on the
card against the CPU (a dense, an MoE and a Mamba model), and a full-width
loss and backward over a batch of the data plane; and the model mesh's
sharded step on four virtual shards against the CPU's (a further case
holds the mesh on distinct cards and runs only where there is more than
one card); and the dry run's census of a step on the card against the
same step on ``meta``.

Every test takes the ``cuda`` fixture and skips without a card. The file
imports no JAX, so it runs on a machine with a card and no JAX:
``PYTHONPATH=src python -m pytest -q tests/test_torch_on_card.py``.
tests/test_torch_card_limits.py holds the same plain paths against the JAX
package on the CPU; ``chip_smoke.py`` makes the same checks at its sizes.
"""
import pytest
import torch

import numpy as np

from repro_torch.core import gf2
from repro_torch.data import stats
from repro_torch.kernels import (api, bloom, general, hll, ops, ref, shard,
                                 sketch_fused, stream)
from repro_torch.kernels import plan as tplan

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)

GRID_DIM = 65535   # blocks a grid's y or z dimension holds
# a dense modulus of degree 32, which the fold takes at no n: the
# irreducible one of weight 9 with the smallest low part (chip_smoke.py's
# DENSE_P32)
DENSE_P32 = 0x10000033F


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py checks the kernels "
                    "there)")
    return torch.device("cuda")


def _words(gen, dev, *shape, dense=False):
    draw = lambda: torch.randint(0, 1 << 32, shape, generator=gen,
                                 device=dev, dtype=torch.int64)
    return (draw() | draw() if dense else draw()).to(torch.uint32)


def test_plan_more_than_8_sketches_on_card(cuda):
    """Ten sketches, two or three of each kind: one launch a group of
    eight, every output equal to the plain version's."""
    gen = torch.Generator(device=cuda).manual_seed(19)
    B, S = 16, 700
    for family in ("cyclic", "general"):
        tp = tplan.SketchPlan(tplan.HashSpec(family=family, n=5, L=32), (
            ("sig_a", tplan.MinHashSpec(k=8)), ("hll_a", tplan.HLLSpec(b=6)),
            ("cms_a", tplan.CountMinSpec(depth=3, log2_width=8)),
            ("bl_a", tplan.BloomSpec(k=3, log2_m=12)),
            ("sig_b", tplan.MinHashSpec(k=5)),
            ("hll_b", tplan.HLLSpec(b=15)),
            ("cms_b", tplan.CountMinSpec(depth=2, log2_width=13)),
            ("bl_b", tplan.BloomSpec(k=2, log2_m=22)),
            ("sig_c", tplan.MinHashSpec(k=3)), ("hll_c", tplan.HLLSpec(b=4))))
        ops_ = {}
        for name, spec in tp.sketches:
            if isinstance(spec, tplan.MinHashSpec):
                ops_[name] = {"a": _words(gen, cuda, spec.k),
                              "b": _words(gen, cuda, spec.k),
                              "init": _words(gen, cuda, B, spec.k)}
            elif isinstance(spec, tplan.HLLSpec):
                ops_[name] = {"init": torch.randint(
                    0, 3, (1 << spec.b,), generator=gen, device=cuda,
                    dtype=torch.int32)}
            elif isinstance(spec, tplan.CountMinSpec):
                ops_[name] = {"a": _words(gen, cuda, spec.depth),
                              "b": _words(gen, cuda, spec.depth)}
            else:
                ops_[name] = {"bits": _words(gen, cuda, spec.n_words,
                                             dense=True)}
        nw = torch.tensor([S - 4] * (B - 1) + [0], dtype=torch.int32,
                          device=cuda)
        ws = torch.randint(0, 6, (B,), generator=gen, device=cuda,
                           dtype=torch.int32)
        kw = dict(h1v_b=_words(gen, cuda, B, S), n_windows=nw, w_start=ws,
                  operands=ops_)
        x = _words(gen, cuda, B, S)
        before = sketch_fused.LAUNCHES
        got = api.run(tp, x, impl="kernel", **kw)
        assert sketch_fused.LAUNCHES - before == len(
            sketch_fused.sketch_groups(tp.sketches)) == 2
        want = api.run(tp, x, impl="ref", **kw)
        for name in want:
            assert torch.equal(got[name], want[name]), (family, name)


def test_rolling_row_past_65535_segments_on_card(cuda):
    """One row of GRID_DIM + 1 segments of the launcher's own size; the
    windows of the first 6 and the last 6 segments against the plain
    version of their slice with its n-1 halo (a window depends on its own
    n symbols alone)."""
    from repro_torch.kernels import _build
    seg = _build.load("rolling").rolling_block_windows()
    n, L = 8, 32
    segs = GRID_DIM + 1
    S = segs * seg + n - 1
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = _words(gen, cuda, 1, S)
    toks = (x.view(torch.int32) & 255).contiguous()
    table = _words(gen, cuda, 256)
    p = gf2.find_irreducible_host(L)
    calls = {"cyclic": (x, lambda v, impl: ops.cyclic(v, n=n, L=L,
                                                      impl=impl)),
             "general": (x, lambda v, impl: ops.general(v, n=n, p=p, L=L,
                                                        impl=impl)),
             "cyclic_fused": (toks, lambda v, impl: ops.cyclic_fused(
                 v, table, n=n, L=L, impl=impl))}
    for name, (src, call) in calls.items():
        got = call(src, "kernel")
        assert got.shape == (1, segs * seg)
        for lo, hi in ((0, 6 * seg), ((GRID_DIM - 5) * seg, segs * seg)):
            want = call(src[:, lo : hi + n - 1].contiguous(), "ref")
            assert torch.equal(got[:, lo:hi], want), (name, lo)
        del got


def test_decode_rows_past_65535_on_card(cuda):
    B, V = GRID_DIM + 65, 96
    spec = tplan.DecodeSpec(n=4, L=32, log2_m=10, k=2, canary_log2_m=12,
                            canary_k=3)
    gen = torch.Generator(device=cuda).manual_seed(4)
    args = (torch.randn((B, V), generator=gen, device=cuda),
            _words(gen, cuda, B),
            torch.rand((B,), generator=gen, device=cuda) < 0.8,
            _words(gen, cuda, B, spec.n_words, dense=True),
            _words(gen, cuda, V))
    cb = _words(gen, cuda, spec.canary_words, dense=True)
    got = api.decode(spec, *args, canary_bits=cb, impl="kernel")
    want = api.decode(spec, *args, canary_bits=cb, impl="ref")
    assert bool((want["banned"][GRID_DIM:] != 0).any())   # the far rows ban
    for key in want:
        a, b = got[key], want[key]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), key


@pytest.mark.parametrize("ready_dtype", [torch.bool, torch.int32,
                                         torch.int64, torch.float32])
def test_decode_ready_flags_of_any_type_on_card(cuda, ready_dtype):
    """The kernel reads bool and integer flags as they are and any other
    type after a conversion; each gives the plain version's bits."""
    spec = tplan.DecodeSpec(n=3, L=32, log2_m=14, k=2, canary_log2_m=20,
                            canary_k=4)
    gen = torch.Generator(device=cuda).manual_seed(5)
    B, V = 16, 152064
    on = torch.arange(B, device=cuda) % 3 != 1
    ready = (on if ready_dtype == torch.bool else
             torch.where(on, 2.0, -0.0) if ready_dtype == torch.float32 else
             on.to(ready_dtype) * 2)             # -0.0 is not ready
    args = (torch.randn((B, V), generator=gen, device=cuda),
            _words(gen, cuda, B), ready,
            _words(gen, cuda, B, spec.n_words, dense=True),
            _words(gen, cuda, V))
    cb = _words(gen, cuda, spec.canary_words, dense=True)
    got = api.decode(spec, *args, canary_bits=cb, impl="kernel")
    want = api.decode(spec, *args, canary_bits=cb, impl="ref")
    for key in want:
        a, b = got[key], want[key]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), key


@pytest.mark.parametrize("log2_m,route", [(18, 1), (22, 2), (26, 0)])
def test_bloom_probe_routes_on_card(cuda, log2_m, route):
    """bloom_probe with its filter whole in each block's shared memory (1),
    its first 224 KiB there and the rest through the read-only cache (2),
    and all through the read-only cache (0)."""
    assert bloom.route(log2_m) == route
    gen = torch.Generator(device=cuda).manual_seed(log2_m)
    bits = _words(gen, cuda, 1 << (log2_m - 5), dense=True)
    for B, S in ((3, 300), (2, 500_001)):
        ha, hb = _words(gen, cuda, B, S), _words(gen, cuda, B, S)
        for k in (0, 1, 4, 8):
            got = bloom.bloom_probe(ha, hb, bits, k=k, log2_m=log2_m)
            want = bloom.bloom_probe(ha.cpu(), hb.cpu(), bits.cpu(), k=k,
                                     log2_m=log2_m)
            assert torch.equal(got.cpu(), want), (B, S, k)


@pytest.mark.parametrize("kind", ["default", "dense", "fold 1 term",
                                  "fold 3 terms", "L=19", "L=20"])
def test_general_routes_on_card(cuda, kind):
    """ops.general bit-equal to its plain version on each route and each
    count of fold terms and chunk tables the kernel has: find_irreducible_
    host's p at L = 32 (the fold to n = 25, then 4 tables), a dense p (the
    tables at every n), x^32 + 1 and x^32 + x^3 + x + 1 (a fold of one
    and of three terms: any p of degree L is taken), and L in {19, 20}."""
    L = {"L=19": 19, "L=20": 20}.get(kind, 32)
    p = {"dense": DENSE_P32,
         "fold 1 term": (1 << 32) | 1,
         "fold 3 terms": (1 << 32) | 0b1011}.get(
             kind, gf2.find_irreducible_host(L))
    if kind == "dense":
        assert gf2.is_irreducible_host(p) and bin(p).count("1") == 9
    ns = (1, 8, 12, 20, 25, 26, 32, 33, 40) if L == 32 else (1, 8, L, 25)
    gen = torch.Generator(device=cuda).manual_seed(L)
    for n in ns:
        r = general.route(n, p, L)
        for B, S in ((1024, 8192), (3, 300)):
            x = _words(gen, cuda, B, S)
            before = general.LAUNCHES
            got = ops.general(x, n=n, p=p, L=L, impl="kernel")
            assert general.LAUNCHES == before + 1
            assert torch.equal(got, ops.general(x, n=n, p=p, L=L,
                                                impl="ref")), (n, r, B)


@pytest.mark.parametrize("b", [1, 4, 12, 14, 15, 17, 23, 31])
def test_hll_update_on_card(cuda, b):
    """hll_update bit-equal to the plain version from one hash to the byte
    path's 4,299,996, and just past one and two blocks' first sweep (1,024
    threads x 4 loads); b <= 14 keeps a register file a block in shared
    memory, above it the global registers are raised directly."""
    gen = torch.Generator(device=cuda).manual_seed(b)
    for N in (1, 7, 300, 4097, 8193, 4_299_996):
        h = _words(gen, cuda, N)
        for rb in (32 - b, 32):
            got = hll.hll_update(h, b=b, rank_bits=rb)
            assert torch.equal(got, ref.hll_update_ref(h, b=b,
                                                       rank_bits=rb)), (N, rb)
            del got


def _stream_plans():
    hs = tplan.HashSpec(family="cyclic", n=8, L=32, discard=True)
    return (tplan.SketchPlan(hs, (("hll", tplan.HLLSpec(b=12)),
                                  ("cms", tplan.CountMinSpec(
                                      depth=4, log2_width=16)))),
            tplan.SketchPlan(hs, (("sig", tplan.MinHashSpec(k=16)),
                                  ("bl", tplan.BloomSpec(k=4, log2_m=20)))))


def _stream_ops(plan, gen, dev):
    ops_ = {}
    for name, spec in plan.sketches:
        ops_[name] = {k: _words(gen, dev, *shape) for k, shape in
                      sketch_fused.operand_shapes(spec).items()}
    return ops_


def test_update_many_graph_replay_on_card(cuda):
    """The replay equals the eager loop and the plain version, is one
    dispatch and T plan launches, and leaves the caller's state and every
    state it returned unchanged by later replays."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    T, B, C = 4, 64, 96
    for plan in _stream_plans():
        ops_ = _stream_ops(plan, gen, cuda)
        chunks = [_words(gen, cuda, T, B, C) for _ in range(3)]
        second = ([_words(gen, cuda, T, B, C) for _ in range(3)]
                  if plan.needs_second_stream else [None] * 3)
        lens = np.random.default_rng(0).integers(0, C + 1, (T, B))
        lens[:, :3] = 0                              # idle rows
        s0 = stream.init_state(plan, B, device=cuda)
        states, plain = [s0], [s0]
        for t in range(3):
            before = (stream.dispatch_count(), sketch_fused.LAUNCHES)
            states.append(stream.update_many(plan, states[-1], chunks[t],
                                             chunk_b=second[t], lengths=lens,
                                             operands=ops_))
            assert stream.dispatch_count() == before[0] + 1
            # the first call warms up (T launches) and captures the graph
            # (none) before its replay
            assert sketch_fused.LAUNCHES == before[1] + T * (1 + (t == 0))
            plain.append(stream.update_many(plan, plain[-1], chunks[t],
                                            chunk_b=second[t], lengths=lens,
                                            operands=ops_, impl="ref"))
        snaps = [stream.export_state(plan, st) for st in states]
        # a fourth replay of the same graph changes none of them
        stream.update_many(plan, states[-1], chunks[0], chunk_b=second[0],
                           lengths=lens, operands=ops_)
        for st, snap, want in zip(states, snaps, plain):
            again = stream.export_state(plan, st)
            expect = stream.export_state(plan, want)
            for key in ("tail", "seen"):
                assert np.array_equal(again[key], snap[key])
                assert np.array_equal(again[key], expect[key])
            for name in snap["sketch"]:
                assert np.array_equal(again["sketch"][name],
                                      snap["sketch"][name])
                assert np.array_equal(again["sketch"][name],
                                      expect["sketch"][name])


def test_run_stream_executors_on_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(6)
    B, S = 32, 1000
    for plan in _stream_plans():
        ops_ = _stream_ops(plan, gen, cuda)
        x = _words(gen, cuda, B, S)
        xb = _words(gen, cuda, B, S) if plan.needs_second_stream else None
        nw = torch.randint(0, S - 7, (B,), generator=gen, device=cuda)
        nw[:2] = 0
        want = api.run(plan, x, h1v_b=xb, n_windows=nw, operands=ops_,
                       impl="ref")
        for executor, chunk_s, n_chunks, dispatches in (
                ("host", 128, None, 8), ("grid", 128, None, 1),
                ("scan", 128, None, 1), ("scan", 128, 10, 1),
                ("scan", 8, None, 1)):
            before = stream.dispatch_count()
            got = stream.run_stream(plan, x, h1v_b=xb, n_windows=nw,
                                    operands=ops_, chunk_s=chunk_s,
                                    executor=executor, n_chunks=n_chunks)
            assert stream.dispatch_count() - before == dispatches, executor
            for name in want:
                assert torch.equal(got[name], want[name]), (executor, name)


def test_restore_after_capture_on_card(cuda, tmp_path):
    """A stream captured and replayed, exported, imported into a fresh
    NgramStats of another seed (its params re-bound: new addresses, a new
    capture) and continued equals the uninterrupted run; re-binding the
    running instance to another draw is never served the old one."""
    from repro_torch.data import durable
    cfg = dict(hll_b=12, cms_log2_width=16, vocab=8192)
    ng = stats.NgramStats(stats.StatsConfig(device="cuda", **cfg))
    rng = np.random.default_rng(1)
    blocks = [rng.integers(0, 8192, (4, 128, 256)) for _ in range(4)]
    whole = ng.init_stream(128)
    for blk in blocks:
        whole = ng.update_stream_many(whole, blk)
    half = ng.init_stream(128)
    for blk in blocks[:2]:
        half = ng.update_stream_many(half, blk)
    durable.save_stats_stream(ng, half, str(tmp_path), 2)
    fresh = stats.NgramStats(stats.StatsConfig(device="cuda", seed=77, **cfg))
    fresh.update_stream_many(fresh.init_stream(128), blocks[0])  # a capture
    resumed, _ = durable.restore_stats_stream(fresh, str(tmp_path))
    for blk in blocks[2:]:
        resumed = fresh.update_stream_many(resumed, blk)
    for key in ("hll", "cms"):
        assert torch.equal(fresh.finalize_stream(resumed)[key],
                           ng.finalize_stream(whole)[key]), key
    # the same instance re-bound to another draw gives that draw's bits
    other = stats.NgramStats(stats.StatsConfig(device="cuda", seed=78, **cfg))
    ng.rebind_params(other.export_params())
    got = ng.update_stream_many(ng.init_stream(128), blocks[0])
    plain = stats.NgramStats(stats.StatsConfig(device="cuda", impl="ref",
                                               **cfg))
    plain.rebind_params(other.export_params())
    want = plain.update_stream_many(plain.init_stream(128), blocks[0])
    for key in ("hll", "cms"):
        assert torch.equal(ng.finalize_stream(got)[key],
                           plain.finalize_stream(want)[key]), key


def _sharded_checks(plan, mesh, gen, dev):
    """``run_sharded`` and sharded ``update_many`` blocks on ``mesh`` equal
    the one-device calls: outputs and carries bit for bit, one dispatch a
    block and the shards' T launches each."""
    B, S, T, C = 37, 700, 3, 96             # B divides no d > 1
    ops_ = _stream_ops(plan, gen, dev)
    x = _words(gen, dev, B, S)
    xb = _words(gen, dev, B, S) if plan.needs_second_stream else None
    nw = torch.randint(0, S - 7, (B,), generator=gen, device=dev)
    want = api.run(plan, x, h1v_b=xb, n_windows=nw, operands=ops_)
    got = shard.run_sharded(plan, x, h1v_b=xb, n_windows=nw, operands=ops_,
                            mesh=mesh)
    for name in want:
        assert torch.equal(got[name], want[name].to(mesh.home)), name
    chunks = _words(gen, dev, T, B, C)
    second = (_words(gen, dev, T, B, C) if plan.needs_second_stream
              else None)
    lens = np.random.default_rng(2).integers(0, C + 1, (T, B))
    one = stream.init_state(plan, B, device=dev)
    many = stream.init_state(plan, B, device=dev, mesh=mesh)
    for t in range(3):
        one = stream.update_many(plan, one, chunks, chunk_b=second,
                                 lengths=lens, operands=ops_)
        before = (stream.dispatch_count(), sketch_fused.LAUNCHES)
        many = stream.update_many(plan, many, chunks, chunk_b=second,
                                  lengths=lens, operands=ops_)
        assert stream.dispatch_count() == before[0] + 1
        # each shard warms up (T launches) and captures before its first
        # replay
        assert (sketch_fused.LAUNCHES - before[1]
                == mesh.size * T * (1 + (t == 0)))
    a = stream.export_state(plan, one)
    b = stream.export_state(plan, many, batch=B)
    for key in ("tail", "seen"):
        assert np.array_equal(a[key], b[key]), key
    for name in a["sketch"]:
        assert np.array_equal(a["sketch"][name], b["sketch"][name]), name


def test_sharded_plans_and_blocks_on_virtual_shards_on_card(cuda):
    """Four virtual shards of the one card: every shard's kernel launches
    and its own graph replays on this card."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    mesh = shard.DataMesh((torch.device("cuda", 0),) * 4)
    for plan in _stream_plans():
        _sharded_checks(plan, mesh, gen, cuda)


def test_sharded_plans_and_blocks_on_distinct_cards(cuda):
    """The distinct-device path: shards on every card, operands copied to
    each, outputs merged on the first."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs more than one CUDA card (the distinct-device "
                    "path; one card runs the virtual-shard case)")
    gen = torch.Generator(device=cuda).manual_seed(9)
    mesh = shard.data_mesh()
    for plan in _stream_plans():
        _sharded_checks(plan, mesh, gen, cuda)


def test_contract_census_on_card(cuda):
    """The analyzer's contract matrix with the kernels: every entry point's
    launches, dispatches, merges, in-place carries, output dtypes and
    shared memory as declared, on no mesh, one shard and four virtual
    shards."""
    from repro_torch.analysis import contracts
    violations = contracts.verify_contracts(device="cuda",
                                            device_counts=(1, 4))
    assert violations == [], [str(v) for v in violations]
    limit = contracts.device_smem_limit(cuda)
    assert 0 < limit <= 228 * 1024
    assert max(contracts.SMEM_CAPS.values()) <= limit


def test_contract_census_flags_a_second_launch_on_card(cuda):
    """The negative control: api.run's contract pins one plan launch a
    call; a body that runs the plan twice must be flagged."""
    from repro_torch.analysis import contracts
    plan = contracts._sketch_plan("cyclic")
    x, xb, ops_ = contracts._sketch_args(cuda)
    run = lambda: api.run(plan, x, h1v_b=xb, operands=ops_, impl="kernel")

    def doubled():
        run()
        return run()

    contract = contracts.contract_for(api.run)
    findings = contracts.check_census(
        contract, contracts.take_census(doubled), plan=plan, card=True)
    assert findings == ["launches: counted {'plan': 2}, contract says "
                        "{'plan': 1}"]
    assert contracts.check_census(
        contract, contracts.take_census(run), plan=plan, card=True) == []


@pytest.mark.filterwarnings("ignore:ops.cyclic_:DeprecationWarning")
@pytest.mark.parametrize("discard", [True, False])
def test_legacy_shims_on_card(cuda, discard):
    """The deprecated single-sketch shims through the plan kernel, one
    launch a call, each equal to its plain version on the card."""
    gen = torch.Generator(device=cuda).manual_seed(21)
    B, S, n = 8, 520, 8
    x, xb = _words(gen, cuda, B, S), _words(gen, cuda, B, S)
    a, b = _words(gen, cuda, 64), _words(gen, cuda, 64)
    bits = _words(gen, cuda, 1 << 17, dense=True)
    nw = torch.randint(0, S - n + 2, (B,), generator=gen, device=cuda,
                       dtype=torch.int32)
    hm = (1 << (32 - n + 1)) - 1 if discard else 0xFFFFFFFF
    calls = {
        "minhash": lambda impl: ops.cyclic_minhash(
            x, a, b, n=n, n_windows=nw, discard=discard, impl=impl),
        "hll": lambda impl: ops.cyclic_hll(x, n=n, b=12, n_windows=nw,
                                           discard=discard, impl=impl),
        "bloom": lambda impl: ops.cyclic_bloom(
            x, xb, bits, n=n, k=4, log2_m=22, n_windows=nw,
            discard=discard, impl=impl)}
    fused = {
        "minhash_fused": (
            lambda: sketch_fused.cyclic_minhash_fused(x, nw, a, b, n=n,
                                                      hash_mask=hm),
            lambda: ref.minhash_fused_ref(x, nw, a, b, n=n, hash_mask=hm)),
        "hll_fused": (
            lambda: sketch_fused.cyclic_hll_fused(
                x, nw, n=n, b=12, rank_bits=20, hash_mask=hm),
            lambda: ref.hll_fused_ref(x, nw, n=n, b=12, rank_bits=20,
                                      hash_mask=hm)),
        "bloom_fused": (
            lambda: sketch_fused.cyclic_bloom_fused(
                x, xb, nw, bits, n=n, k=4, log2_m=22, hash_mask=hm),
            lambda: ref.bloom_fused_ref(x, xb, nw, bits, n=n, k=4,
                                        log2_m=22, hash_mask=hm))}
    for name, call in calls.items():
        before = sketch_fused.LAUNCHES
        got = call("kernel")
        assert sketch_fused.LAUNCHES - before == 1, name
        assert torch.equal(got, call("ref")), name
    for name, (kern, plain) in fused.items():
        before = sketch_fused.LAUNCHES
        got = kern()
        assert sketch_fused.LAUNCHES - before == 1, name
        assert torch.equal(got, plain()), name


def _step_card_vs_cpu(cuda, arch):
    """One ``make_train_step`` step at ``arch``'s ``.smoke()`` on the card
    and on the CPU from the state after two CPU steps (so the compared
    update is lr * m / sqrt(v), not lr * sign(g)): (the card's metrics,
    the CPU's, {name: (card parameter, CPU parameter, carried one)})."""
    from repro_torch.configs import registry
    from repro_torch.train import optim, step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = registry.get_config(arch).smoke()
    sched = optim.Schedule(peak_lr=1e-2, warmup_steps=2, decay_steps=10)
    fn = step.make_train_step(cfg, sched)
    rng = np.random.default_rng(21)
    batches = [{"tokens": rng.integers(0, cfg.vocab, size=(4, 64)).astype(
        np.int32)} for _ in range(3)]
    cpu = step.init_state(0, cfg, sched, device="cpu")
    for b in batches[:2]:
        cpu, _ = fn(cpu, b)
    start = {n: p.detach().clone() for n, p in
             cpu["params"].named_parameters()}
    card = step.init_state(0, cfg, sched, device=cuda)
    step.load_state(card, {"params": cpu["params"].state_dict(),
                           "opt": cpu["opt"], "step": cpu["step"]})
    card, mc = fn(card, batches[2])
    cpu, mp = fn(cpu, batches[2])
    return mc, mp, {n: (a.detach().cpu(), b.detach(), start[n])
                    for (n, a), (_, b) in zip(
                        card["params"].named_parameters(),
                        cpu["params"].named_parameters())}


def test_train_step_on_card_matches_cpu(cuda):
    """One ``make_train_step`` step at ``paper-tiny`` ``.smoke()`` on the
    card against the same step on the CPU, from a state carried after two
    CPU steps: loss and grad norm within rtol 1e-4, every parameter within
    2e-6 (float32 sums in another order; TF32 off)."""
    mc, mp, params = _step_card_vs_cpu(cuda, "paper-tiny")
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(mc[k]), float(mp[k]), rtol=1e-4)
    for n, (a, b, _) in params.items():
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-6, rtol=0,
                                   err_msg=n)


def test_full_width_loss_and_backward_on_card(cuda):
    """qwen1.5-0.5b (recommended: causal skip, chunked CE, remat dots) at
    its published widths, one (1, 128) batch from the data plane on the
    plan kernel: a finite loss and finite gradients for every parameter."""
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataPlane, PipelineConfig
    from repro_torch.nn import lm

    cfg = registry.get_recommended_config("qwen1.5-0.5b")
    data = DataPlane(PipelineConfig(seq_len=128, batch_size=1,
                                    vocab=cfg.vocab, impl="kernel",
                                    device="cuda"))
    params = lm.init(0, cfg, device=cuda)
    before = sketch_fused.LAUNCHES
    batch = data.next_batch(0)
    assert sketch_fused.LAUNCHES - before == 1
    loss, metrics = lm.loss(params, cfg, batch)
    grads = torch.autograd.grad(loss, list(params.parameters()))
    assert torch.isfinite(loss) and float(metrics["ce"]) > 0
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert len(grads) == len(list(params.parameters()))


@pytest.mark.parametrize("arch", ["dbrx-132b", "mamba2-2.7b"])
def test_moe_and_mamba_step_on_card_matches_cpu(cuda, arch):
    """An MoE model (dbrx, AdamW) and a Mamba model (mamba2) at smoke
    size: one step on the card against the CPU from one carried state.
    Loss, grad norm and the MoE's aux within rtol 1e-4; each parameter
    leaf's update within 1e-3 of its norm, in norm (TF32 off; an element
    whose gradient is near 0 has no relative bound through m / sqrt(v))."""
    mc, mp, params = _step_card_vs_cpu(cuda, arch)
    for k in ("loss", "grad_norm", "load_balance"):
        np.testing.assert_allclose(float(mc[k]), float(mp[k]), rtol=1e-4)
    assert float(mc["dropped_frac"]) == float(mp["dropped_frac"])
    for n, (a, b, s) in params.items():
        assert float(torch.linalg.vector_norm(a - b)) <= 1e-3 * float(
            torch.linalg.vector_norm(b - s)), n


def _mesh_step(mesh, cpu_state, cfg, sched, batch):
    from repro_torch.train import step
    sharded = step.shard_state(cpu_state, cfg, mesh, sched)
    fn = step.make_train_step(cfg, sched)
    sharded, m = fn(sharded, batch)
    return m, {n: t.detach().cpu() for n, t in sharded["params"].full(
        torch.device("cpu")).items()}


def _mesh_state(arch="paper-tiny"):
    """A CPU state after two steps at ``arch``'s ``.smoke()``, its config,
    schedule and a third batch."""
    from repro_torch.configs import registry
    from repro_torch.train import optim, step
    cfg = registry.get_config(arch).smoke()
    sched = optim.Schedule(peak_lr=1e-2, warmup_steps=2, decay_steps=10)
    fn = step.make_train_step(cfg, sched)
    rng = np.random.default_rng(24)
    batches = [{"tokens": rng.integers(0, cfg.vocab, size=(4, 64)).astype(
        np.int32)} for _ in range(3)]
    cpu = step.init_state(0, cfg, sched, device="cpu")
    for b in batches[:2]:
        cpu, _ = fn(cpu, b)
    return cpu, cfg, sched, batches[2]


def test_model_mesh_step_on_card_matches_cpu(cuda):
    """The (2, 2) sharded step on four virtual shards of the card against
    the same sharded step on the CPU from one carried state: loss and grad
    norm within rtol 1e-4, every parameter within 2e-6 (TF32 off)."""
    from repro_torch.launch.mesh import make_debug_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu, cfg, sched, batch = _mesh_state()
    mc, pc = _mesh_step(make_debug_mesh(2, 2, device=cuda), cpu, cfg, sched,
                        batch)
    mp, pp = _mesh_step(make_debug_mesh(2, 2, device="cpu"), cpu, cfg, sched,
                        batch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(mc[k]), float(mp[k]), rtol=1e-4)
    for n in pp:
        np.testing.assert_allclose(pc[n].numpy(), pp[n].numpy(), atol=2e-6,
                                   rtol=0, err_msg=n)


def test_model_mesh_on_distinct_cards(cuda):
    """The model mesh with one card a position ((2, 2) over four cards,
    else (1, 2) over two): the sharded step equal to the one-device step
    within the reference test's tolerances, and prefill and decode equal
    to one device's within 1e-4."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs more than one CUDA card (the distinct-device "
                    "model mesh; one card runs the virtual-shard case)")
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.nn import lm
    from repro_torch.train import step
    torch.backends.cuda.matmul.allow_tf32 = False
    shape = (2, 2) if torch.cuda.device_count() >= 4 else (1, 2)
    n = shape[0] * shape[1]
    mesh = make_mesh([torch.device("cuda", i) for i in range(n)], *shape)
    cpu, cfg, sched, batch = _mesh_state()
    params = {k: v.detach().clone() for k, v in
              cpu["params"].named_parameters()}
    mc, pc = _mesh_step(mesh, cpu, cfg, sched, batch)
    one, mo = step.make_train_step(cfg, sched)(cpu, batch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(mc[k]), float(mo[k]), rtol=1e-4)
    for name, p in one["params"].named_parameters():
        np.testing.assert_allclose(pc[name].numpy(), p.detach().numpy(),
                                   rtol=2e-3, atol=2e-4, err_msg=name)
    ref = lm.init(0, cfg, device=cuda)
    ref.load_state_dict(params)
    sp = lm.shard(ref, cfg, mesh)
    toks = torch.from_numpy(np.random.default_rng(25).integers(
        0, cfg.vocab, size=(4, 12))).to(cuda)
    outs = []
    for p in (ref, sp):
        logits, caches = lm.prefill(p, cfg, toks, 16,
                                    cache_dtype=torch.float32)
        got = [logits]
        for _ in range(4):
            nxt = got[-1].argmax(-1)[:, None]
            logits, caches = lm.decode_step(p, cfg, nxt, caches)
            got.append(logits)
        outs.append(got)
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch,kind,mesh", [
    ("paper-tiny", "train", None), ("paper-tiny", "train", (2, 2)),
    ("dbrx-132b", "decode", (2, 2)), ("mamba2-2.7b", "prefill", None)])
def test_dryrun_census_on_card_equals_meta(cuda, arch, kind, mesh):
    """The dry run's census of a step run on the card (real tensors, the
    kernels' device) against the same step on ``meta``: every count equal
    (FLOPs, bytes by op, collectives, ops, the temporaries' peak) and the
    same in-place verdict."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    cfg = registry.get_config(arch).smoke()
    shape = ShapeConfig("t", 64, 4, kind)
    got = {}
    for dev in ("meta", cuda):
        m = make_debug_mesh(*mesh, device=dev) if mesh else None
        rec, donated = dryrun.census_cell(cfg, shape, m, dev)
        rec.pop("census_s")
        got[str(dev)] = (rec, donated)
    assert got["meta"] == got[str(cuda)]
