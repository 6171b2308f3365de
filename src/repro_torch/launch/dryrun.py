"""The multi-pod dry run: what each (architecture x input shape) cell's step
costs a device, as the JAX package's ``repro/launch/dryrun.py`` computes.

For a cell, build the production mesh with every position a virtual shard
of the ``meta`` device, the state and inputs from their shapes and specs
(nothing allocated, no value drawn), run the train, prefill or decode step
once under the op census (:mod:`repro_torch.launch.op_census`) and record
the matrix-product FLOPs, the computed bytes and the collectives a device,
the per-device bytes of the arguments and outputs from the specs, the
census's estimate of the temporaries, whether the step updates its state
in place, and the roofline terms at the H100's data-sheet peaks
(``configs.base.H100``) into ``artifacts/dryrun_torch/<arch>__<shape>__
<mesh>.json``.

The reference lowers and compiles the step (XLA); the census runs it, one
local program a position. Costs come from two shallow probes
(:data:`PROBE_RS` repeats of the block unit, one microbatch), extrapolated
linearly to the full depth (:func:`depth_extrapolated_costs`): every
repeat is the same program. A decode cell attends over a full cache
(length ``seq_len - 1``), as the reference's decode reads every cache
position and masks the ones past its length.

Nothing runs on a device, so a cell's record is the same on any machine.
``--device cuda`` runs the cell's steps on the card instead, with real
tensors, and fails without one.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--both-meshes] [--skip-existing]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import H100, SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.registry import ASSIGNED, get_config, shape_applicable
from repro_torch.launch import op_census
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shardings import (Placement, cache_axes,
                                          input_specs,
                                          shapes_and_axes_params,
                                          shapes_and_axes_state,
                                          tree_shardings)
from repro_torch.nn import lm
from repro_torch.nn.collectives import Sharded
from repro_torch.nn.layers import DTYPES
from repro_torch.nn.sharding import shard_shape
from repro_torch.train import step as tstep

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__),
                            "../../../artifacts/dryrun_torch")
PROBE_RS = (2, 4)
XLA_FLOPS_NULL = ("no XLA program: the port runs eagerly; flops_per_device "
                  "is the census's matrix-product count")
CODE_SIZE_NULL = "no compiled program"


def shape_of(shape) -> ShapeConfig:
    """A cell's input shape: a ``SHAPES`` name, or a ShapeConfig."""
    return shape if isinstance(shape, ShapeConfig) else SHAPES[shape]


def _mesh_tag(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def mesh_tag(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape) if mesh is not None else "1"


def tensors_of(tree) -> List[torch.Tensor]:
    """Every tensor of a tree, each distinct shard of a Sharded."""
    if isinstance(tree, Sharded):
        return list(tree.shards.values())
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, lm.ShardedLM):
        return tree.parameters()
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors_of(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors_of(v)]
    return []


def _leaves(tree) -> List:
    """The leaves of a tree: tensors, Shardeds and Placements, a module's
    parameters (an LM's) or leaves (a ShardedLM's)."""
    if isinstance(tree, (torch.Tensor, Sharded, Placement)):
        return [tree]
    if isinstance(tree, lm.ShardedLM):
        return list(tree.leaves.values())
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def device_bytes(shapes, placements, mesh) -> int:
    """The bytes one mesh position holds of a tree of (meta) tensors laid
    out by a tree of placements (every leaf whole without a mesh)."""
    flat = _leaves(shapes)
    places = _leaves(placements) if mesh is not None else [None] * len(flat)
    return sum(math.prod(tuple(t.shape) if pl is None else
                         shard_shape(tuple(t.shape), pl.spec, mesh))
               * t.element_size() for t, pl in zip(flat, places))


def _build(shapes, placements, mesh, param: bool = False):
    """A tree of Shardeds laid out by ``placements`` over ``mesh``, each
    shard zeros of its shard shape (on ``meta``: shapes only)."""
    if isinstance(shapes, torch.Tensor):
        spec = placements.spec

        def make(coord, box, pos):
            t = torch.zeros(shard_shape(tuple(shapes.shape), spec, mesh),
                            dtype=shapes.dtype, device=mesh.device(pos))
            return torch.nn.Parameter(t) if param else t
        return Sharded.build(tuple(shapes.shape), spec, mesh, make)
    return {k: _build(v, placements[k], mesh, param)
            for k, v in shapes.items()}


def _batch(specs, device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
            for k, v in specs.items()}


def _caches_bytes(cfg, caches, mesh) -> int:
    """Per-device bytes of a cache tree (each repeat laid out alike)."""
    if mesh is None:
        return device_bytes(caches, None, None)
    ax = cache_axes(cfg, mesh)
    return sum(device_bytes(unit, tree_shardings(unit, ax, mesh), mesh)
               for unit in caches)


def spec_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh=None):
    """(argument bytes, output bytes) a device of a cell's step, from the
    shapes and specs alone (``mesh`` None: one device holds everything).
    Arguments: the train state (parameters, optimizer state, step) and the
    batch; the parameters and the batch for prefill; the parameters, the
    caches and the token for decode. Outputs: the train state; the last
    logits (vocab over ``model``) and the caches. A cache's length is a
    Python int on the host, not a device tensor."""
    B, S = shape.global_batch, shape.seq_len
    specs = input_specs(cfg, shape, mesh if mesh is not None
                        else make_production_mesh())
    pl = ((lambda shapes, axes: tree_shardings(shapes, axes, mesh))
          if mesh is not None else (lambda shapes, axes: None))
    inputs = ("batch", "batch_sharding") if shape.kind != "decode" else \
        ("token", "token_sharding")
    in_b = device_bytes(specs[inputs[0]], specs[inputs[1]] if mesh
                        is not None else None, mesh)
    if shape.kind == "train":
        shapes, axes = shapes_and_axes_state(cfg)
        state_b = device_bytes(shapes, pl(shapes, axes), mesh)
        return state_b + in_b, state_b
    p_shapes, p_axes = shapes_and_axes_params(cfg)
    params_b = device_bytes(p_shapes, pl(p_shapes, p_axes), mesh)
    vp = lm.padded_vocab(cfg)
    logits = torch.empty((B, vp), dtype=DTYPES[cfg.activation_dtype],
                         device="meta")
    logits_b = device_bytes(logits, pl(logits, (None, "vocab")), mesh)
    max_len = S + cfg.prefix_len if shape.kind == "prefill" else S
    cache_b = _caches_bytes(cfg, lm.init_caches(cfg, B, max_len,
                                                device="meta"), mesh)
    if shape.kind == "prefill":
        return params_b + in_b, logits_b + cache_b
    return params_b + cache_b + in_b, logits_b + cache_b


@dataclasses.dataclass
class Cell:
    """A cell's step, ready to run: ``fn()`` runs it once; ``state`` is
    what it must update in place (None for prefill), ``inputs`` the batch
    or token it reads."""
    fn: object
    state: object
    inputs: object
    positions: int


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
               device="meta") -> Cell:
    """The step of one cell on ``mesh`` (None: one device, ``device``). On
    a mesh the state is built from its shapes and specs, each shard zeros
    (on ``meta``: a shape, nothing drawn); on one device by the
    initialisers (on ``meta`` they draw nothing)."""
    home = mesh.home if mesh is not None else torch.device(device)
    B, S = shape.global_batch, shape.seq_len
    specs = input_specs(cfg, shape, mesh if mesh is not None
                        else make_production_mesh())
    positions = mesh.size if mesh is not None else 1
    if shape.kind == "train":
        if mesh is None:
            state = tstep.init_state(0, cfg, device=device)
        else:
            shapes, axes = shapes_and_axes_state(cfg)
            places = tree_shardings(shapes, axes, mesh)
            state = {"params": lm.ShardedLM(cfg, mesh, _build(
                         shapes["params"], places["params"], mesh,
                         param=True)),
                     "opt": _build(shapes["opt"], places["opt"], mesh),
                     "step": torch.zeros((), dtype=torch.int32)}
        batch = _batch(specs["batch"], home)
        step = tstep.make_train_step(cfg,
                                     num_microbatches=cfg.num_microbatches)
        return Cell(lambda: step(state, batch), state, batch, positions)
    if mesh is None:
        params = lm.init(0, cfg, device)
    else:
        p_shapes, p_axes = shapes_and_axes_params(cfg)
        params = lm.ShardedLM(cfg, mesh, _build(
            p_shapes, tree_shardings(p_shapes, p_axes, mesh), mesh,
            param=True))
    if shape.kind == "prefill":
        max_len = S + cfg.prefix_len
        batch = _batch(specs["batch"], home)
        return Cell(lambda: lm.prefill(params, cfg, batch["tokens"],
                                       max_len, batch.get("prefix")),
                    None, batch, positions)
    # decode: one step at the last position of a full cache
    caches = lm.init_caches(cfg, B, S, device=device, mesh=mesh)
    caches = [{k: c._replace(length=S - 1) for k, c in unit.items()}
              for unit in caches]
    token = torch.zeros((B, 1), dtype=torch.int32, device=home)
    return Cell(lambda: lm.decode_step(params, cfg, token, caches), caches,
                token, positions)


def in_place(before: List, after) -> bool:
    """Whether a step kept every state tensor (the same objects) and wrote
    each leaf in place (a version counter moved): the port's counterpart
    of a donated argument. On ``meta`` there are no data pointers, so
    identity and ``_version`` are what can be checked."""
    now = tensors_of(after)
    if len(now) != len(before) or any(a is not b for (a, _), b in
                                      zip(before, now)):
        return False
    moved = {id(t) for t, v in before if t._version > v}
    return all(any(id(t) in moved for t in tensors_of(leaf))
               for leaf in _leaves(after))


def run_census(cell: Cell, kind: str):
    """Run a built cell's step once under the census. Returns (census
    record, whether the step updated its state in place: None for
    prefill)."""
    before = [(t, t._version) for t in tensors_of(cell.state)]
    out, rec = op_census.census(cell.fn, positions=cell.positions)
    if kind == "prefill":
        return rec, None
    return rec, in_place(before, out[0] if kind == "train" else out[1])


def census_cell(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                device="meta"):
    """Build one cell's step on ``mesh`` (None: one device, ``device``)
    and run it once under the census: (record, in place)."""
    return run_census(build_cell(cfg, shape, mesh, device), shape.kind)


def lower_cell(arch: str, shape, *, multi_pod: bool = False,
               cfg_overrides: Optional[dict] = None, mesh=None,
               device="meta"):
    """The census of one cell (``shape`` a ``SHAPES`` name or a
    ShapeConfig) on ``mesh`` (default the production mesh of ``device``
    positions). Returns (census record, meta)."""
    cfg = config_of(arch, cfg_overrides)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    rec, donated = census_cell(cfg, shape_of(shape), mesh, device)
    return rec, {"census_s": rec["census_s"], "mesh": mesh_tag(mesh),
                 "chips": mesh.size, "donation_lowered": donated}


def config_of(arch: str, cfg_overrides: Optional[dict] = None):
    cfg = get_config(arch)
    return dataclasses.replace(cfg, **cfg_overrides) if cfg_overrides \
        else cfg


def _probe_costs(rec: Dict) -> Dict:
    return {"flops": op_census.dot_flops(rec),
            "bytes": op_census.bytes_accessed(rec),
            "temp": op_census.temp_bytes(rec),
            "coll": op_census.collective_bytes(rec),
            "counts": op_census.count_collectives(rec)}


def depth_extrapolated_costs(arch: str, shape, *, multi_pod: bool = False,
                             cfg_overrides: Optional[dict] = None,
                             mesh=None, device="meta") -> Dict:
    """Full-depth per-device costs from two shallow probes (:data:`PROBE_RS`
    repeats, one microbatch), extrapolated linearly in the repeats: every
    repeat runs the same ops, so FLOPs, bytes and collectives are linear
    in depth (``tests/test_torch_dryrun.py`` holds the extrapolation to a
    full-depth census). The temporaries' peak is extrapolated the same
    way: an estimate. The probes run at one microbatch, as the
    reference's do: the per-step math is the same, and the gradient sum's
    re-reads of its buffer are not counted."""
    cfg = config_of(arch, cfg_overrides)
    R, unit = cfg.repeats, len(cfg.unit)
    r_lo, r_hi = PROBE_RS
    probes, meta = {}, {}
    for r in (r_lo, r_hi):
        ov = dict(cfg_overrides or {})
        ov.update(n_layers=unit * r, num_microbatches=1)
        rec, meta[r] = lower_cell(arch, shape, multi_pod=multi_pod,
                                  cfg_overrides=ov, mesh=mesh, device=device)
        probes[r] = _probe_costs(rec)

    def extrap(v_lo, v_hi):
        b = (v_hi - v_lo) / (r_hi - r_lo)
        return v_lo - b * r_lo + b * R

    lo, hi = probes[r_lo], probes[r_hi]
    out = {k: extrap(lo[k], hi[k]) for k in ("flops", "bytes", "temp")}
    for k in ("coll", "counts"):
        out[k] = {kk: extrap(lo[k][kk], hi[k][kk]) for kk in lo[k]}
    out["census_s"] = sum(m["census_s"] for m in meta.values())
    donated = [m["donation_lowered"] for m in meta.values()]
    out["donation_lowered"] = None if donated[0] is None else all(donated)
    return out


def cell_meta(arch: str, shape, costs: Dict, *, multi_pod: bool = False,
              cfg_overrides: Optional[dict] = None, mesh=None) -> Dict:
    """What :func:`analyze` needs beside the costs: the mesh's tag and
    size, the full-depth argument and output bytes from the specs."""
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    arg_b, out_b = spec_bytes(config_of(arch, cfg_overrides),
                              shape_of(shape), mesh)
    donated = costs["donation_lowered"]
    return {"mesh": mesh_tag(mesh), "chips": mesh.size,
            "census_s": costs["census_s"], "donation_lowered": donated,
            "argument_bytes": arg_b, "output_bytes": out_b,
            "alias_bytes": out_b if donated else 0}


def memory_analysis(meta: Dict, temp: float) -> Dict:
    """The reference's ``memory_analysis`` keys: exact argument, output and
    alias bytes a device from the specs, the census's temporaries."""
    return {"generated_code_size_in_bytes": None,
            "argument_size_in_bytes": meta["argument_bytes"],
            "output_size_in_bytes": meta["output_bytes"],
            "temp_size_in_bytes": int(temp),
            "alias_size_in_bytes": meta["alias_bytes"],
            "notes": {"generated_code_size_in_bytes": CODE_SIZE_NULL,
                      "temp_size_in_bytes": "an estimate: the census's "
                      "peak of the storages a step makes, a device, "
                      "extrapolated in depth"}}


def analyze(arch: str, shape, meta: Dict, costs: Dict,
            cfg_overrides: Optional[dict] = None) -> Dict:
    """The cell's record: every key of the reference's, ``census_s`` in
    place of ``lower_s``/``compile_s``."""
    cfg = config_of(arch, cfg_overrides)
    shape = shape_of(shape)
    chips = meta["chips"]
    flops_dev, bytes_dev = costs["flops"], costs["bytes"]
    coll, counts = costs["coll"], costs["counts"]
    mem_d = memory_analysis(meta, costs["temp"])
    flops_total = flops_dev * chips
    terms = H100.roofline_seconds(flops_total, bytes_dev * chips,
                                  coll["total"] * chips, chips)
    dominant = max(terms, key=terms.get)
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        model_flops = 6.0 * n_active * shape.tokens
    elif shape.kind == "prefill":
        model_flops = 2.0 * n_active * shape.tokens
    else:
        model_flops = 2.0 * n_active * shape.global_batch
    arg_b = mem_d["argument_size_in_bytes"] or 0
    return {
        "arch": arch, "shape": shape.name, "mesh": meta["mesh"],
        "chips": chips, "kind": shape.kind,
        "census_s": round(meta["census_s"], 2),
        "donation_lowered": meta["donation_lowered"],
        "flops_per_device": flops_dev,
        "xla_flops_per_device": None,
        "xla_flops_null": XLA_FLOPS_NULL,
        "bytes_per_device": bytes_dev,
        "bytes_kind": "computed: every non-view op's inputs and outputs",
        "collective_bytes_per_device": coll["total"],
        "collective_breakdown": {k: v for k, v in coll.items()
                                 if k != "total"},
        "collective_counts": counts,
        "memory_analysis": mem_d,
        "hbm_per_device_gb": round((arg_b + costs["temp"]) / 1e9, 3),
        "roofline": dict(terms),
        "dominant": dominant,
        "model_flops": model_flops,
        "useful_flops_ratio": (model_flops / flops_total) if flops_total
        else None,
        "ok": True,
    }


def run_cell(arch: str, shape, *, multi_pod: bool = False,
             out_dir: str = ARTIFACT_DIR, verbose: bool = True,
             cfg_overrides: Optional[dict] = None, variant: str = "",
             mesh=None, device="meta") -> Dict:
    """Census one cell (two probes; ``shape`` a ``SHAPES`` name or a
    ShapeConfig), write its record to ``<arch>__<shape>__<mesh>.json``
    under ``out_dir`` and return it; a failure is recorded as the
    reference records it."""
    os.makedirs(out_dir, exist_ok=True)
    shape_name = shape_of(shape).name
    tag_mesh = mesh_tag(mesh) if mesh is not None else _mesh_tag(multi_pod)
    tag = f"{arch}__{shape_name}__{tag_mesh}"
    if variant:
        tag += f"__{variant}"
    t0 = time.perf_counter()
    try:
        costs = depth_extrapolated_costs(
            arch, shape, multi_pod=multi_pod, cfg_overrides=cfg_overrides,
            mesh=mesh, device=device)
        meta = cell_meta(arch, shape, costs, multi_pod=multi_pod,
                         cfg_overrides=cfg_overrides, mesh=mesh)
        rec = analyze(arch, shape, meta, costs, cfg_overrides)
        rec["variant"] = variant
        rec["cfg_overrides"] = cfg_overrides or {}
        rec["wall_s"] = round(time.perf_counter() - t0, 2)
        if verbose:
            print(f"[dryrun] {tag}: census={rec['census_s']}s "
                  f"flops/dev={rec['flops_per_device']:.3e} "
                  f"coll/dev={rec['collective_bytes_per_device']:.3e} "
                  f"dominant={rec['dominant']} "
                  f"useful={rec['useful_flops_ratio'] and round(rec['useful_flops_ratio'], 3)}",
                  flush=True)
    except Exception as e:  # noqa: BLE001 - record failures as artifacts
        rec = {"arch": arch, "shape": shape_name, "mesh": tag_mesh,
               "ok": False, "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        if verbose:
            print(f"[dryrun] {tag}: FAILED {rec['error']}", flush=True)
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def cells_of(all_cells: bool, arch: Optional[str], shape: Optional[str]):
    """The (arch, shape) cells to run: every applicable cell of the
    assigned archs, smallest first, or the one named."""
    if not all_cells:
        if not (arch and shape):
            raise SystemExit("--arch and --shape, or --all")
        return [(arch, shape)]
    cells = [(a, s) for a in ASSIGNED for s, shp in SHAPES.items()
             if shape_applicable(get_config(a), shp)]
    # smallest first: fastest feedback, earliest records
    cells.sort(key=lambda c: get_config(c[0]).param_count())
    return cells


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out-dir", default=ARTIFACT_DIR)
    ap.add_argument("--device", default="meta", choices=("meta", "cuda"),
                    help="meta: the census alone, on any machine; cuda: "
                         "the steps on the card")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    for multi_pod in meshes:
        for arch, sname in cells_of(args.all, args.arch, args.shape):
            tag = f"{arch}__{sname}__{_mesh_tag(multi_pod)}"
            path = os.path.join(args.out_dir, tag + ".json")
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("ok", False):
                        print(f"[dryrun] {tag}: cached")
                        continue
            rec = run_cell(arch, sname, multi_pod=multi_pod,
                           out_dir=args.out_dir, device=args.device)
            failures += 0 if rec.get("ok") else 1
    print(f"[dryrun] done, failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
