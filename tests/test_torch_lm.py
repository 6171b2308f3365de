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
attention and MLP branches the first two do not; and the four
architectures with MoE and Mamba-2 units (``dbrx-132b``, ``kimi-k2-1t-a32b``,
``mamba2-2.7b``, ``jamba-1.5-large-398b``), whose Mamba members carry a
conv history and an SSM state from prefill into decode. The tolerance covers
float32 sums taken in another order (both prefill with an online softmax
over KV chunks and decode with one softmax; the matmuls come from
different libraries); both keep the KV cache in bfloat16, as the serving
default does, but for the MoE and Mamba archs (float32, see MOE_MAMBA).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.nn import lm as jlm
from repro_torch import convert
from repro_torch.configs import registry
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


# the MoE and Mamba archs keep float32 KV caches here: a key one float32
# step apart on the two sides may round to neighbouring bfloat16 values,
# which moved dbrx's next logits by 5.7e-4 at this seed (its Mamba caches
# are float32 either way)
MOE_MAMBA = ("dbrx-132b", "kimi-k2-1t-a32b", "mamba2-2.7b",
             "jamba-1.5-large-398b")


@pytest.mark.parametrize("arch,overrides", [
    ("paper-tiny", {}), ("qwen1.5-0.5b", {}),
    ("qwen3-4b", {"attn_logit_softcap": 30.0}), ("musicgen-large", {})]
    + [(a, {}) for a in MOE_MAMBA])
def test_prefill_and_decode_logits_match(arch, overrides):
    jcfg, values, cfg, params = _carried(arch, **overrides)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, size=(2, 9)).astype(np.int32)
    pe = (rng.standard_normal((2, cfg.prefix_len, cfg.d_model)).astype(
        np.float32) if cfg.prefix_len else None)
    f32 = arch in MOE_MAMBA
    want, jcache = jlm.prefill(values, jcfg, toks, 20, pe,
                               cache_dtype=jnp.float32 if f32
                               else jnp.bfloat16)
    got, cache = lm.prefill(params, cfg, toks, 20,
                            None if pe is None else torch.from_numpy(pe),
                            cache_dtype=torch.float32 if f32
                            else torch.bfloat16)
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


def test_mamba_caches_and_short_prompts():
    """A Mamba member's cache is the reference's: float32 conv history
    and state, length 0; prefill fills it in place. A prompt shorter than
    ssm_conv - 1 has no conv history to keep: prefill raises (the
    reference slices the wrong rows and its decode fails on the shape)."""
    jcfg, _, cfg, params = _carried("jamba-1.5-large-398b")
    caches = lm.init_caches(cfg, 2, 8, device="cpu")
    want = jlm.init_caches(jcfg, 2, 8)
    for u, spec in enumerate(cfg.unit):
        c, w = caches[0][f"u{u}"], want[f"u{u}"]
        if spec.kind == "mamba":
            assert c.conv.shape == w.conv.shape[1:]
            assert c.state.shape == w.state.shape[1:]
            assert c.conv.dtype == c.state.dtype == torch.float32
            assert c.length == 0
        else:
            assert c.k.shape == w.k.shape[1:]
    toks = torch.zeros((1, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="at least 3 tokens"):
        lm.prefill(params, cfg, toks, 8)
