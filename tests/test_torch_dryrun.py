"""The dry run (``launch/op_census.py``, ``launch/dryrun.py``,
``launch/roofline.py``, ``configs.base.HardwareConfig``) against the JAX
package's, on ``meta`` tensors: nothing is computed, so every count is
exact.

The reference's dot FLOPs come from its compiled one-device program
(``hlo_analysis.dot_flops`` of ``jax.jit(...).lower(...).compile()``, the
layer scan unrolled). Its own dry run on a mesh does not run under this
JAX (``tests/test_distributed.py::test_dryrun_cell_on_debug_mesh``), so
the port is held to that program. Two gaps are exact and asserted with
their causes (see each test): the reference's HLO counts the body of its
attention's KV-chunk scan once, and the port's sharded loss drops the
last position before the unembedding product.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from repro.configs import base as jbase
from repro.configs.registry import get_config as jget_config
from repro.launch import hlo_analysis
from repro.launch import mesh as jmesh
from repro.launch import roofline as jroofline
from repro.launch import shardings as jshardings
from repro.nn import lm as jlm
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.configs import base, registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, op_census, roofline
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.nn import lm

torch.set_num_threads(1)

B, S = 4, 256                   # two KV chunks of paper-tiny's 128


def _tiny(**kw):
    return dataclasses.replace(registry.get_config("paper-tiny"),
                               n_layers=2, **kw)


def _jtiny(**kw):
    return dataclasses.replace(jget_config("paper-tiny"), n_layers=2,
                               scan_unroll=True, **kw)


def _ref_dot_flops(cfg, kind) -> float:
    """``dot_flops`` of the reference's compiled one-device step."""
    p_shapes, _ = jshardings.shapes_and_axes_params(cfg)
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    if kind == "train":
        st, _ = jshardings.shapes_and_axes_state(cfg)
        lowered = jax.jit(jmake_train_step(cfg)).lower(st, {"tokens": tok})
    elif kind == "prefill":
        lowered = jax.jit(lambda p, t: jlm.prefill(p, cfg, t, S)).lower(
            p_shapes, tok)
    else:
        caches = jax.eval_shape(lambda: jlm.init_caches(cfg, B, S))
        lowered = jax.jit(lambda p, t, c: jlm.decode_step(p, cfg, t, c)
                          ).lower(p_shapes, jax.ShapeDtypeStruct(
                              (B, 1), jnp.int32), caches)
    return hlo_analysis.dot_flops(lowered.compile().as_text())


def _attention_flops(cfg, kind) -> int:
    """The attention products (scores and values) the port's step runs:
    once a forward, twice more in the backward, once more in the
    recompute of remat ``full``; decode's one query against S keys."""
    hd = cfg.resolved_head_dim
    q = 1 if kind == "decode" else S
    fwd = cfg.n_layers * 2 * (2 * B * cfg.n_heads * q * S * hd)
    if kind != "train":
        return fwd
    return fwd * (4 if cfg.remat == "full" else 3)


@pytest.mark.parametrize("kind,remat", [("train", "nothing"),
                                        ("train", "dots"), ("train", "full"),
                                        ("prefill", "dots"),
                                        ("decode", "dots")])
def test_dot_flops_match_the_reference_compiled_step(kind, remat):
    """The port's census against the reference's compiled step (75.70e9
    at remat nothing and dots, 88.05e9 at full for the train step). The
    gap is the reference's count, not the port's work: XLA keeps the
    attention's scan over KV chunks a while loop (``scan_unroll`` unrolls
    only the layer scan), and ``dot_flops`` counts a loop body once, so
    with S / kv_chunk = 2 chunks the reference counts half the attention
    products the step runs. What is left equals exactly."""
    cfg = _tiny(remat=remat)
    rec, _ = dryrun.census_cell(cfg, ShapeConfig("t", S, B, kind))
    ref = _ref_dot_flops(_jtiny(remat=remat), kind)
    chunks = S // cfg.kv_chunk
    attn = _attention_flops(cfg, kind)
    assert rec["dot_flops"] == ref + attn * (chunks - 1) // chunks
    if kind == "train":
        want = {"nothing": 75_698_798_592, "dots": 75_698_798_592,
                "full": 88_046_829_568}[remat]
        assert ref == want


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_mesh_dot_flops_against_one_device(kind):
    """On a (2, 2) mesh the sharded steps run the one-device products in
    parts; the sharded loss alone runs fewer: it drops the last position
    (which has no label) before the unembedding product, where one device
    computes all S positions' logits and drops the last after, so the
    mesh skips 2 B D V_padded FLOPs in the forward and twice that in the
    backward."""
    cfg = _tiny()
    shape = ShapeConfig("t", S, B, kind)
    one, _ = dryrun.census_cell(cfg, shape)
    mesh, _ = dryrun.census_cell(cfg, shape,
                                 make_debug_mesh(2, 2, device="meta"))
    skipped = 3 * 2 * B * cfg.d_model * lm.padded_vocab(cfg) \
        if kind == "train" else 0
    assert mesh["dot_flops"] == one["dot_flops"] - skipped


@pytest.mark.parametrize("arch,kind,mesh", [
    ("paper-tiny", "train", None), ("paper-tiny", "train", (2, 2)),
    ("dbrx-132b", "train", (2, 2)), ("dbrx-132b", "decode", None),
    ("mamba2-2.7b", "train", (2, 2)), ("mamba2-2.7b", "decode", (2, 2)),
    ("jamba-1.5-large-398b", "prefill", (2, 2))])
def test_census_is_the_same_on_meta_and_on_the_cpu(arch, kind, mesh):
    """Every count of the census (FLOPs, bytes by op, collectives, the
    temporaries' peak, ops) and the in-place verdict, on ``meta`` and on
    CPU tensors that hold values."""
    cfg = registry.get_config(arch).smoke()
    shape = ShapeConfig("t", 32, 4, kind)
    got = {}
    for dev in ("meta", "cpu"):
        m = make_debug_mesh(*mesh, device=dev) if mesh else None
        rec, donated = dryrun.census_cell(cfg, shape, m, dev)
        rec.pop("census_s")
        got[dev] = (rec, donated)
    assert got["meta"] == got["cpu"]
    assert got["meta"][1] is (None if kind == "prefill" else True)


def test_depth_extrapolation_equals_the_full_census():
    """From repeats 2 and 4 to 8: FLOPs and collective operand bytes and
    counts equal a direct census at 8 layers (every repeat runs the same
    ops)."""
    smoke = registry.get_config("paper-tiny").smoke()
    ov = {k: getattr(smoke, k) for k in (
        "d_model", "vocab", "n_heads", "n_kv_heads", "head_dim", "d_ff",
        "q_chunk", "kv_chunk")}
    ov.update(n_layers=8, remat="nothing")
    shape = ShapeConfig("t", 64, 8, "train")
    mesh = make_debug_mesh(2, 2, device="meta")
    ext = dryrun.depth_extrapolated_costs("paper-tiny", shape,
                                          cfg_overrides=ov, mesh=mesh)
    rec, _ = dryrun.lower_cell("paper-tiny", shape, cfg_overrides=ov,
                               mesh=mesh)
    assert ext["flops"] == op_census.dot_flops(rec)
    assert ext["coll"] == pytest.approx(op_census.collective_bytes(rec),
                                        rel=1e-12)
    assert ext["counts"] == pytest.approx(op_census.count_collectives(rec),
                                          rel=1e-12)
    assert ext["coll"]["total"] > 0


def test_hardware_config_matches_the_reference_formula():
    hw = base.HardwareConfig(197e12, 819e9, 50e9, 16e9)
    for args in ((1e15, 3e12, 2e11, 256), (5e12, 1e9, 0.0, 1),
                 (7.3e18, 4.1e15, 9e13, 512)):
        assert hw.roofline_seconds(*args) == jbase.V5E.roofline_seconds(
            *args)
    assert (base.H100.peak_flops, base.H100.hbm_bw, base.H100.link_bw,
            base.H100.hbm_bytes) == (989e12, 3.35e12, 450e9, 80e9)


def _records():
    rng = np.random.default_rng(7)
    out = []
    for i, (arch, shape, mesh) in enumerate([
            ("qwen3-4b", "train_4k", "16x16"),
            ("dbrx-132b", "decode_32k", "2x16x16"),
            ("mamba2-2.7b", "long_500k", "16x16")]):
        t = {k: float(rng.uniform(1e-4, 1.0)) for k in
             ("compute_s", "memory_s", "collective_s")}
        counts = {k: float(rng.integers(0, 90)) for k in
                  hlo_analysis.COLLECTIVES}
        out.append({"arch": arch, "shape": shape, "mesh": mesh, "ok": True,
                    "chips": 256 if mesh == "16x16" else 512,
                    "compile_s": 3.25 + i, "census_s": 3.25 + i,
                    "flops_per_device": float(rng.uniform(1e12, 1e15)),
                    "bytes_per_device": float(rng.uniform(1e9, 1e12)),
                    "collective_bytes_per_device": float(rng.uniform(1e8,
                                                                     1e11)),
                    "collective_counts": counts, "roofline": t,
                    "dominant": max(t, key=t.get),
                    "model_flops": float(rng.uniform(1e14, 1e17)),
                    "useful_flops_ratio": 0.5, "hbm_per_device_gb": 12.5})
    out.append({"arch": "kimi-k2-1t-a32b", "shape": "train_4k",
                "mesh": "16x16", "ok": False, "error": "RuntimeError: x"})
    return out


def test_roofline_report_matches_the_reference():
    """The same records give the reference's dry-run table, the one
    column's name ``census_s`` in place of ``compile_s``, and the same
    fraction times each package's peak."""
    recs = _records()
    assert roofline.fmt_dryrun_table(recs) == jroofline.fmt_dryrun_table(
        recs).replace("| compile_s |", "| census_s |")
    for r in recs:
        a, b = roofline.roofline_fraction(r), jroofline.roofline_fraction(r)
        if not r["ok"]:
            assert a is None and b is None
            continue
        assert a * base.H100.peak_flops == pytest.approx(
            b * jbase.V5E.peak_flops, rel=1e-12)
    assert roofline.fmt_table(recs, "16x16").count("\n") == 4
    assert len(roofline.pick_hillclimb_targets(recs)) == 2


@pytest.mark.parametrize("arch,shape", [
    ("paper-tiny", "train_4k"), ("paper-tiny", "prefill_32k"),
    ("mamba2-2.7b", "decode_32k"), ("jamba-1.5-large-398b", "decode_32k")])
def test_argument_bytes_match_the_reference_shard_shapes(arch, shape):
    """On (4, 2): the per-device bytes of the state, the batch and the
    caches from the port's specs against the reference's
    ``NamedSharding(mesh, spec).shard_shape`` of every leaf on its 8
    virtual devices. The reference's caches also hold each layer's length
    (an int32 on the device); the port keeps it on the host, so those
    leaves are left out."""
    cfg = registry.get_config(arch).smoke()
    jcfg = jget_config(arch).smoke()
    shp = base.SHAPES[shape]
    jmsh = jmesh.make_debug_mesh(4, 2)

    def nbytes(tree, shardings):
        total = 0
        for path, s in jax.tree_util.tree_leaves_with_path(tree):
            if "length" in jax.tree_util.keystr(path):
                continue
            sh = _at(shardings, path)
            total += int(np.prod(sh.shard_shape(s.shape))) * \
                np.dtype(s.dtype).itemsize
        return total

    specs = jshardings.input_specs(jcfg, jbase.SHAPES[shape], jmsh)
    if shp.kind == "train":
        st, ax = jshardings.shapes_and_axes_state(jcfg)
        want = nbytes(st, jshardings.tree_shardings(st, ax, jmsh)) + \
            nbytes(specs["batch"], specs["batch_sharding"])
    else:
        ps, ax = jshardings.shapes_and_axes_params(jcfg)
        want = nbytes(ps, jshardings.tree_shardings(ps, ax, jmsh))
        if shp.kind == "prefill":
            want += nbytes(specs["batch"], specs["batch_sharding"])
        else:
            want += nbytes(specs["caches"], specs["cache_sharding"]) + \
                nbytes(specs["token"], specs["token_sharding"])
    got, _ = dryrun.spec_bytes(cfg, shp, make_debug_mesh(4, 2,
                                                         device="meta"))
    assert got == want


def _at(tree, path):
    for k in path:
        if isinstance(k, jax.tree_util.DictKey):
            tree = tree[k.key]
        elif isinstance(k, jax.tree_util.GetAttrKey):
            tree = getattr(tree, k.name)
        else:
            tree = tree[k.idx]
    assert isinstance(tree, NamedSharding)
    return tree


SMOKE = ("n_layers", "d_model", "vocab", "n_heads", "n_kv_heads",
         "head_dim", "d_ff", "n_experts", "top_k", "expert_d_ff",
         "q_chunk", "kv_chunk", "param_dtype", "activation_dtype")


@pytest.fixture(scope="module")
def smoke_records(tmp_path_factory):
    """paper-tiny and dbrx ``.smoke()`` cells on (2, 2) and (2, 2, 2)
    ``meta`` meshes, written as the CLI writes them."""
    out = tmp_path_factory.mktemp("dryrun")
    recs = {}
    train = ShapeConfig("train_s", 256, 8, "train")
    decode = ShapeConfig("decode_s", 512, 8, "decode")
    cells = {0: [("paper-tiny", train), ("paper-tiny", decode),
                 ("dbrx-132b", train)],
             2: [("paper-tiny", train), ("paper-tiny", decode),
                 ("dbrx-132b", decode)]}
    for pod, todo in cells.items():
        mesh = make_debug_mesh(2, 2, pod, device="meta")
        for arch, shape in todo:
            smoke = registry.get_config(arch).smoke()
            # remat "nothing": "dots"'s selective checkpoint doubles the
            # census's time, and no check here depends on it
            ov = dict({k: getattr(smoke, k) for k in SMOKE},
                      remat="nothing")
            rec = dryrun.run_cell(arch, shape, out_dir=str(out),
                                  verbose=False, cfg_overrides=ov,
                                  mesh=mesh)
            recs[(arch, shape.name, rec["mesh"])] = rec
    loaded = roofline.load(str(out))
    assert len(loaded) == len(recs) == 6
    return recs


def test_smoke_records_are_sane(smoke_records):
    """The counterparts of ``tests/test_dryrun_artifacts.py``'s checks."""
    keys = ("arch", "shape", "mesh", "chips", "kind", "census_s",
            "donation_lowered", "flops_per_device", "xla_flops_per_device",
            "bytes_per_device", "collective_bytes_per_device",
            "collective_breakdown", "collective_counts", "memory_analysis",
            "hbm_per_device_gb", "roofline", "dominant", "model_flops",
            "useful_flops_ratio", "ok")
    for key, r in smoke_records.items():
        assert r["ok"], (key, r.get("error"))
        assert set(keys) <= set(r)
        assert all(v >= 0 for v in r["roofline"].values()), key
        assert r["flops_per_device"] > 0 and \
            r["collective_bytes_per_device"] > 0, key
        frac = roofline.roofline_fraction(r)
        assert frac is not None and 0 < frac <= 1.5, (key, frac)
        assert 0.05 <= r["useful_flops_ratio"] <= 1.4, key
        if r["kind"] in ("train", "decode"):
            assert r["donation_lowered"] is True, key
        mem = r["memory_analysis"]
        assert mem["argument_size_in_bytes"] > 0 and \
            mem["temp_size_in_bytes"] > 0, key
        json.dumps(r)


def test_smoke_records_shard_the_pod_axis_and_gather_experts(smoke_records):
    a = smoke_records[("paper-tiny", "train_s", "2x2")]
    b = smoke_records[("paper-tiny", "train_s", "2x2x2")]
    assert 0.35 <= b["flops_per_device"] / a["flops_per_device"] <= 0.75
    for key in (("dbrx-132b", "train_s", "2x2"),
                ("dbrx-132b", "decode_s", "2x2x2")):
        assert smoke_records[key]["collective_breakdown"]["all-gather"] > 0
