"""The port's LM serving entry points (prefill and decode) against the
JAX package's, with the reference's random weights carried across by
``convert.lm_params_from_jax``; tests/test_torch_train.py holds the
training half (forward, loss, gradients) the same way.

At ``paper-tiny`` and ``qwen1.5-0.5b`` (``.smoke()``: float32 parameters
and activations; qwen keeps its QKV bias and RoPE theta 1e6), the prefill
logits and four ``decode_step`` logits lie within atol 1e-4 / rtol 1e-4 of
the reference's; so do ``qwen3-4b`` (qk-norm, GQA; here with a logit soft
cap of 30) and ``musicgen-large`` (GELU MLP, untied unembedding, no RoPE,
a prefix of embeddings under prefix-LM attention), which reach the
attention and MLP branches the first two do not. The tolerance covers
float32 sums taken in another order (both prefill with an online softmax
over KV chunks and decode with one softmax; the matmuls come from
different libraries); both keep the KV cache in bfloat16, as the serving
default does.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.nn import lm as jlm
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.base import LayerSpec
from repro_torch.nn import lm

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)


def _carried(arch: str, **overrides):
    jcfg = dataclasses.replace(jget_config(arch).smoke(), **overrides)
    cfg = dataclasses.replace(registry.get_config(arch).smoke(), **overrides)
    values, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
    params = lm.init(0, cfg, device="cpu")
    params.load_state_dict(convert.lm_params_from_jax(values, "cpu"))
    return jcfg, values, cfg, params


@pytest.mark.parametrize("arch,overrides", [
    ("paper-tiny", {}), ("qwen1.5-0.5b", {}),
    ("qwen3-4b", {"attn_logit_softcap": 30.0}), ("musicgen-large", {})])
def test_prefill_and_decode_logits_match(arch, overrides):
    jcfg, values, cfg, params = _carried(arch, **overrides)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, size=(2, 9)).astype(np.int32)
    pe = (rng.standard_normal((2, cfg.prefix_len, cfg.d_model)).astype(
        np.float32) if cfg.prefix_len else None)
    want, jcache = jlm.prefill(values, jcfg, toks, 20, pe)
    got, cache = lm.prefill(params, cfg, toks, 20,
                            None if pe is None else torch.from_numpy(pe))
    assert got.shape == (2, lm.padded_vocab(cfg)) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for _ in range(4):
        tok = rng.integers(0, cfg.vocab, size=(2, 1)).astype(np.int32)
        want, jcache = jlm.decode_step(values, jcfg, tok, jcache)
        got, cache = lm.decode_step(params, cfg, torch.from_numpy(tok), cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert cache[0]["u0"].length == 9 + cfg.prefix_len + 4


def test_configs_match_reference():
    from repro.configs.registry import ARCHS as JARCHS
    assert set(registry.ARCHS) == set(JARCHS)
    for name, cfg in registry.ARCHS.items():
        jcfg = JARCHS[name]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), name
        assert (dataclasses.asdict(cfg.smoke())
                == dataclasses.asdict(jcfg.smoke())), name
        assert cfg.param_count() == jcfg.param_count(), name
        assert lm.padded_vocab(cfg) == jlm.padded_vocab(jcfg)


def test_state_dict_layout_follows_reference_tree():
    """The carried state dict covers every parameter of the port's model
    (strict load), with the einsum layouts (d, h, q) and (h, q, d)."""
    _, values, cfg, params = _carried("qwen1.5-0.5b")
    sd = params.state_dict()
    assert sd["blocks.1.u0.attn.wq.w"].shape == (64, 4, 16)
    assert sd["blocks.1.u0.attn.wq.b"].shape == (4, 16)
    assert sd["blocks.1.u0.attn.wo.w"].shape == (4, 16, 64)
    np.testing.assert_array_equal(
        sd["blocks.1.u0.ffn.w_gate.w"].numpy(),
        np.asarray(values["blocks"]["u0"]["ffn"]["w_gate"]["w"][1]))
    assert len(params.blocks) == cfg.repeats


def test_mask_pad_logits_matches_reference():
    cfg = registry.get_config("qwen1.5-0.5b").smoke()
    jcfg = jget_config("qwen1.5-0.5b").smoke()
    x = np.random.default_rng(2).standard_normal(
        (3, lm.padded_vocab(cfg) + 256)).astype(np.float32)
    np.testing.assert_array_equal(
        lm.mask_pad_logits(cfg, torch.from_numpy(x)).numpy(),
        np.asarray(jlm.mask_pad_logits(jcfg, x)))


@pytest.mark.parametrize("unit,what", [
    ((LayerSpec("mamba", "none"),), "'mamba' mixer"),
    ((LayerSpec("attn", "moe"),), "MoE feed-forward")])
def test_unported_units_raise(unit, what):
    cfg = dataclasses.replace(registry.get_config("paper-tiny").smoke(),
                              unit=unit, n_layers=2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        lm.init(0, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=what):
        lm.init_caches(cfg, 1, 4, device="cpu")
