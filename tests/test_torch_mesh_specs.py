"""The model mesh's placements against the JAX package's: for every
registered config, the spec of every parameter, every AdamW and Adafactor
state leaf and every cache tensor from the port's ``launch.shardings``
equals the reference's ``repro.nn.sharding.spec_for`` over
``repro.launch.shardings.shapes_and_axes_state`` (``jax.eval_shape``, no
allocation), with the reference's stacked ``stack`` axis dropped (the port
holds one module a layer), on (2, 4), (4, 2), (1, 3), the pod mesh
(2, 2, 2) and the production (16, 16) and (2, 16, 16). The reference's
``spec_for`` and ``kv_cache_axes`` read only ``axis_names`` and
``devices.shape``, so a stand-in object serves and no virtual JAX devices
are needed. Exact."""
import dataclasses
import functools
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.launch import shardings as jshardings
from repro.nn import lm as jlm
from repro.nn import sharding as jsharding
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import shardings
from repro_torch.nn import lm
from repro_torch.nn import sharding

torch.set_num_threads(1)

MESHES = [((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
          ((1, 3), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _meshes():
    for shape, names in MESHES:
        ref = types.SimpleNamespace(axis_names=names,
                                    devices=np.empty(shape))
        port = pmesh.ModelMesh(np.full(shape, None, dtype=object), names)
        yield shape, ref, port


def _spec(ref_spec, ndim):
    t = tuple(ref_spec)
    return t + (None,) * (ndim - len(t))


@functools.lru_cache(maxsize=None)
def _ref_state(arch, optimizer):
    cfg = dataclasses.replace(jget_config(arch), optimizer=optimizer)
    shapes, axes = jshardings.shapes_and_axes_state(cfg)
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    out = []
    for path, leaf in flat:
        keys = tuple(k.key for k in path)
        ax = axes
        for k in keys:
            ax = ax[k]
        out.append((keys, tuple(leaf.shape), tuple(ax)))
    return out


def _port_name(keys, optimizer):
    """A reference state path -> (port path prefix, parameter path, the
    key after it)."""
    if keys[0] == "step":
        return None
    if keys[0] == "params":
        return ("params",), keys[1:], ()
    if optimizer == "adamw":
        return ("opt", keys[1]), keys[2:], ()
    return ("opt",), keys[1:-1], (keys[-1],)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_state_specs_equal_reference(arch):
    for optimizer in ("adamw", "adafactor"):
        cfg = dataclasses.replace(get_config(arch), optimizer=optimizer)
        state, axes = shardings.shapes_and_axes_state(cfg)
        ref = _ref_state(arch, optimizer)
        n_port = sum(1 for _ in shardings._map(lambda t, a: t, state, axes)
                     ["params"].values())
        assert n_port == sum(
            cfg.repeats if k[1] == "blocks" else 1
            for k, _, _ in ref if k[0] == "params")
        for shape, rmesh, mesh in _meshes():
            placed = shardings.tree_shardings(state, axes, mesh)
            for keys, rshape, rax in ref:
                got = _port_name(keys, optimizer)
                if got is None:
                    continue
                prefix, ppath, suffix = got
                want = _spec(jsharding.spec_for(rshape, rax, rmesh),
                             len(rshape))
                stacked = ppath[0] == "blocks"
                names = ([f"blocks.{r}." + ".".join(ppath[1:])
                          for r in range(cfg.repeats)] if stacked
                         else [".".join(ppath)])
                for name in names:
                    node = placed
                    for k in prefix + (name,) + suffix:
                        node = node[k]
                    exp = want[1:] if stacked else want
                    assert tuple(node.spec) == exp, (arch, optimizer, shape,
                                                     keys, node.spec, want)
                    t = state
                    for k in prefix + (name,) + suffix:
                        t = t[k]
                    assert tuple(t.shape) == (rshape[1:] if stacked
                                              else rshape), keys


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_equal_reference(arch):
    B, S = 16, 96
    jcfg, cfg = jget_config(arch), get_config(arch)
    jcaches = jax.eval_shape(functools.partial(jlm.init_caches, jcfg, B, S))
    caches = lm.init_caches(cfg, B, S, device="meta")
    for shape, rmesh, mesh in _meshes():
        rax = jshardings.cache_axes(jcfg, rmesh)
        pax = shardings.cache_axes(cfg, mesh)
        assert sharding.kv_cache_axes(cfg, mesh) == \
            jsharding.kv_cache_axes(jcfg, rmesh)
        placed = shardings.tree_shardings(caches[0], pax, mesh)
        for u in rax:
            for field in jcaches[u]._fields:
                if field == "length":
                    continue
                leaf = getattr(jcaches[u], field)
                want = _spec(jsharding.spec_for(
                    leaf.shape, getattr(rax[u], field), rmesh),
                    len(leaf.shape))
                got = getattr(placed[u], field).spec
                assert tuple(got) == want[1:], (arch, shape, u, field)
                assert tuple(getattr(caches[0][u], field).shape) == \
                    tuple(leaf.shape[1:])


def test_spec_for_matches_reference_on_random_cases():
    rng = np.random.default_rng(0)
    names = list(jsharding.RULES)
    for _ in range(400):
        nd = int(rng.integers(1, 5))
        shape = tuple(int(rng.choice([1, 2, 3, 4, 6, 8, 12, 16, 48, 50281]))
                      for _ in range(nd))
        axes = tuple(names[int(rng.integers(len(names)))] for _ in range(nd))
        for _, rmesh, mesh in _meshes():
            want = _spec(jsharding.spec_for(shape, axes, rmesh), nd)
            assert tuple(sharding.spec_for(shape, axes, mesh)) == want
            assert tuple(sharding.logical_to_spec(axes, mesh)) == _spec(
                jsharding.logical_to_spec(axes, rmesh), nd)


def test_spec_resolution_rules():
    """The cases of the reference's ``test_spec_resolution_rules``."""
    P = sharding.PartitionSpec
    mesh = pmesh.make_debug_mesh(2, 4, device="cpu")
    assert sharding.spec_for((64, 8, 16), ("embed", "heads", "head_dim"),
                             mesh) == P("data", "model", None)
    assert sharding.spec_for((64, 1, 16), ("embed", "kv_heads", "head_dim"),
                             mesh) == P("data", None, "model")
    assert sharding.spec_for((50281, 64), ("vocab", "embed"), mesh) == \
        P(None, "data")
    mesh3 = pmesh.make_debug_mesh(2, 2, pod=2, device="cpu")
    assert sharding.spec_for((8, 128), ("batch", "seq"), mesh3) == \
        P(("pod", "data"), None)
    assert sharding.kv_cache_axes(get_config("phi3-mini-3.8b"), mesh) == \
        ("batch", None, "kv_heads", None)
    assert sharding.kv_cache_axes(get_config("paligemma-3b"),
                                  mesh)[1] == "kv_seq_model"
    # the largest dividing prefix of (pod, data): 2 rows take the pod only
    assert sharding.spec_for((2, 4), ("batch", "seq"), mesh3) == \
        P("pod", None)


def test_production_mesh_is_shape_only():
    mesh = pmesh.make_production_mesh(multi_pod=True)
    assert mesh.shape == (2, 16, 16) and mesh.size == 512
    with pytest.raises(ValueError, match="no devices"):
        mesh.device((0, 0, 0))


def test_input_specs_place_every_input():
    """A train cell's tokens split over (pod, data); a decode cell's caches
    laid out by ``cache_axes`` (paligemma's one kv head: the sequence over
    ``model``), on meta tensors."""
    from repro_torch.configs.base import SHAPES
    mesh = pmesh.make_production_mesh(multi_pod=True)
    got = shardings.input_specs(get_config("paper-tiny"),
                                SHAPES["train_4k"], mesh)
    assert got["batch"]["tokens"].device.type == "meta"
    assert tuple(got["batch_sharding"]["tokens"].spec) == (
        ("pod", "data"), None)
    cfg = get_config("paligemma-3b")
    got = shardings.input_specs(cfg, SHAPES["decode_32k"], mesh)
    assert tuple(got["token_sharding"].spec) == (("pod", "data"), None)
    kv = got["cache_sharding"][0]["u0"].k
    assert tuple(kv.spec) == (("pod", "data"), "model", None, None)
    assert len(got["caches"]) == cfg.repeats


def test_constrain_checks_the_local_shape():
    mesh = pmesh.make_debug_mesh(2, 4, device="cpu")
    x = torch.zeros(32, 2, 16)
    assert sharding.constrain(x, ("embed", "heads", "head_dim"), (64, 8, 16),
                              mesh) is x
    with pytest.raises(ValueError, match="local shape"):
        sharding.constrain(x, ("embed", "heads", "head_dim"), (64, 16, 16),
                           mesh)
