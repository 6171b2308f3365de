"""The port's LM training half against the JAX package's: the flash
attention (with and without the causal skip), the chunked softmax
statistics, the forward logits, and the loss with every gradient leaf
against ``jax.value_and_grad(repro.nn.lm.loss)``; the remat modes against
each other; serving under no-grad; and the reference's model smoke checks
on the port (a forward and an SGD step for every arch, prefill and
decode against the forward, the recommended config's step).
tests/test_torch_moe_mamba_lm.py holds the MoE and Mamba-2 architectures
against the reference the same way.

Weights are the reference's ``lm.init`` carried across by
``convert.lm_params_from_jax`` at ``.smoke()`` sizes (float32 parameters
and activations); inputs are drawn from seeded numpy generators. Each arch
reaches a branch: ``paper-tiny`` GQA, ``qwen1.5-0.5b`` QKV bias,
``qwen3-4b`` qk-norm with a logit soft cap of 30, ``musicgen-large`` a
GELU MLP, an untied unembedding, no RoPE and a prefix under prefix-LM
attention.

Tolerances. Float32 paths: atol/rtol 1e-5 for attention, 1e-4 for
logits (as in serving), a gradient leaf within 1e-4 of its largest
magnitude; they cover float32 sums taken in another order. The chunked
CE rounds each vocab slab's logits to bfloat16, as the reference does, so
an order difference can move a logit by one bfloat16 step (2^-8
relative): with ``ce_chunk_vocab`` set, the loss is held to 1e-4 and a
gradient leaf to 5e-3 of its largest magnitude.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.nn import attention as jattn
from repro.nn import lm as jlm
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.nn import attention, lm

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)

ARCHS = [("paper-tiny", {}), ("qwen1.5-0.5b", {}),
         ("qwen3-4b", {"attn_logit_softcap": 30.0}), ("musicgen-large", {})]
# chunk sizes below the sequence length, so every chunked path runs
CHUNKS = dict(q_chunk=8, kv_chunk=16)


def _carried(arch: str, **overrides):
    jcfg = dataclasses.replace(jget_config(arch).smoke(), **overrides)
    cfg = dataclasses.replace(registry.get_config(arch).smoke(), **overrides)
    values, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
    params = lm.init(0, cfg, device="cpu")
    params.load_state_dict(convert.lm_params_from_jax(values, "cpu"))
    return jcfg, values, cfg, params


def _batch(cfg, rng, B=2, S=24):
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, S)).astype(
        np.int32)}
    if cfg.prefix_len:
        batch["prefix"] = rng.standard_normal(
            (B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    return batch


def _qkv(cfg, rng, B, Sq, Sk):
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, D)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("bf16_probs", [False, True])
@pytest.mark.parametrize("arch,overrides", ARCHS)
def test_flash_attention_matches_reference(arch, overrides, bf16_probs):
    """Sk = 29 keys in chunks of 8 (a padded tail), a random kv_valid, the
    arch's prefix and soft cap, query positions after the keys'."""
    cfg = dataclasses.replace(registry.get_config(arch).smoke(), **overrides)
    rng = np.random.default_rng(3)
    q, k, v = _qkv(cfg, rng, 2, 13, 29)
    k_pos = np.broadcast_to(np.arange(29, dtype=np.int32), (2, 29))
    q_pos = np.broadcast_to(np.arange(16, 29, dtype=np.int32), (2, 13))
    valid = rng.random((2, 29)) < 0.8
    valid[:, 0] = True
    kw = dict(kv_chunk=8, prefix_len=cfg.prefix_len,
              softcap=cfg.attn_logit_softcap, bf16_probs=bf16_probs)
    want = jattn.flash_attention(q, k, v, q_pos, k_pos, kv_valid=valid, **kw)
    got = attention.flash_attention(*_t(q, k, v, q_pos, k_pos),
                                    kv_valid=torch.from_numpy(valid), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("arch,overrides", ARCHS)
def test_flash_attention_causal_skip_matches_reference(arch, overrides):
    """29 aligned positions: q chunks of 8 (a padded last chunk), KV
    chunks of 12 that do not divide the visited ranges."""
    cfg = dataclasses.replace(registry.get_config(arch).smoke(), **overrides)
    rng = np.random.default_rng(4)
    q, k, v = _qkv(cfg, rng, 2, 29, 29)
    pos = np.broadcast_to(np.arange(29, dtype=np.int32), (2, 29))
    for bf16_probs in (False, True):
        kw = dict(q_chunk=8, kv_chunk=12, prefix_len=cfg.prefix_len,
                  softcap=cfg.attn_logit_softcap, bf16_probs=bf16_probs)
        want = jattn.flash_attention_causal_skip(q, k, v, pos, pos, **kw)
        got = attention.flash_attention_causal_skip(*_t(q, k, v, pos, pos),
                                                    **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
        # the skip only leaves out masked blocks: it equals the full flash
        full = attention.flash_attention(
            *_t(q, k, v, pos, pos), kv_chunk=12, prefix_len=cfg.prefix_len,
            softcap=cfg.attn_logit_softcap, bf16_probs=bf16_probs)
        np.testing.assert_allclose(got.numpy(), full.numpy(), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("arch,overrides", ARCHS)
def test_chunked_softmax_stats_matches_reference(arch, overrides):
    cfg = dataclasses.replace(registry.get_config(arch).smoke(), **overrides)
    rng = np.random.default_rng(5)
    V = lm.padded_vocab(cfg)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    table = (rng.standard_normal((V, cfg.d_model)) / 8).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, size=(2, 9)).astype(np.int32)
    want = jlm.chunked_softmax_stats(x, table, labels, 128)
    got = lm.chunked_softmax_stats(*_t(x, table), torch.from_numpy(
        labels).long(), 128)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-5)
    with pytest.raises(ValueError, match="does not divide"):
        lm.chunked_softmax_stats(*_t(x, table), torch.from_numpy(labels),
                                 100)


@pytest.mark.parametrize("arch,overrides", ARCHS)
def test_forward_logits_match_reference(arch, overrides):
    jcfg, values, cfg, params = _carried(arch, **overrides, **CHUNKS)
    batch = _batch(cfg, np.random.default_rng(6))
    with jax.disable_jit():
        want, want_aux = jlm.forward(values, jcfg, batch["tokens"],
                                     batch.get("prefix"))
    with torch.no_grad():
        got, aux = lm.forward(params, cfg, *_t(*batch.values()))
    assert got.shape == (2, 24, lm.padded_vocab(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_array_equal(aux.numpy(), np.asarray(want_aux))


def _grads(params, cfg, batch):
    loss, metrics = lm.loss(params, cfg, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       params.named_parameters()])
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(names, grads)))


@pytest.mark.parametrize("ce_chunk,skip", [(0, False), (0, True),
                                           (128, False), (128, True)])
@pytest.mark.parametrize("arch,overrides", ARCHS)
def test_loss_and_grads_match_reference(arch, overrides, ce_chunk, skip):
    jcfg, values, cfg, params = _carried(
        arch, **overrides, **CHUNKS, ce_chunk_vocab=ce_chunk,
        attn_causal_skip=skip)
    batch = _batch(cfg, np.random.default_rng(7))
    with jax.disable_jit():     # op by op: no scan compiled per config
        (jl, jm), jg = jax.value_and_grad(jlm.loss, has_aux=True)(
            values, jcfg, batch)
    loss, metrics, grads = _grads(params, cfg, batch)
    rel = 1e-4
    np.testing.assert_allclose(float(loss), float(jl), rtol=rel)
    np.testing.assert_allclose(float(metrics["ce"]), float(jm["ce"]),
                               rtol=rel)
    for k in ("load_balance", "dropped_frac"):
        assert float(metrics[k]) == float(jm[k]) == 0.0
    want = convert.lm_params_from_jax(jg, "cpu")
    assert set(want) == set(grads)
    frac = 5e-3 if ce_chunk else 1e-4
    for name, g in grads.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3,
                                   atol=frac * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("arch,overrides", [
    ARCHS[1], ARCHS[3], ("jamba-1.5-large-398b", {}),
    ("dbrx-132b", {"moe_dispatch": "grouped", "capacity_factor": 0.1})])
def test_remat_modes_give_equal_grads(arch, overrides):
    """``nothing``, ``dots`` and ``full`` recompute the same float ops on
    the CPU: bit-equal loss and gradients. With MoE units (jamba; dbrx's
    grouped dispatch at a capacity factor that drops) the recompute routes
    and drops as the first pass did, and the aux leaves the checkpointed
    unit: the load-balance term and the drop share are bit-equal too."""
    base = dict(**overrides, **CHUNKS, ce_chunk_vocab=128,
                attn_causal_skip=True)
    _, values, _, _ = _carried(arch, **base)
    batch = _batch(registry.get_config(arch).smoke(),
                   np.random.default_rng(8))
    runs = []
    for remat in ("nothing", "dots", "full"):
        cfg = dataclasses.replace(registry.get_config(arch).smoke(), **base,
                                  remat=remat)
        params = lm.init(0, cfg, device="cpu")
        params.load_state_dict(convert.lm_params_from_jax(values, "cpu"))
        runs.append(_grads(params, cfg, batch))
    for loss, metrics, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for k in ("load_balance", "dropped_frac"):
            assert torch.equal(metrics[k], runs[0][1][k])
        for name, g in grads.items():
            assert torch.equal(g, runs[0][2][name]), name


def test_serving_records_no_graph():
    """The parameters take gradients; prefill and decode run under
    no-grad, so their outputs and caches hold no graph."""
    _, _, cfg, params = _carried("qwen1.5-0.5b")
    assert all(p.requires_grad for p in params.parameters())
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, size=(2, 5)))
    logits, caches = lm.prefill(params, cfg, toks, 8)
    assert not logits.requires_grad and logits.grad_fn is None
    logits, caches = lm.decode_step(params, cfg, toks[:, :1], caches)
    assert not logits.requires_grad
    assert not caches[0]["u0"].k.requires_grad


@pytest.mark.parametrize("arch", list(registry.ARCHS))
def test_smoke_forward_and_sgd_step(arch):
    """The reference's ``test_smoke_forward_and_train_step`` on the port,
    for every arch, MoE and Mamba units included: logits of the right
    shape and finite, a finite positive gradient norm, and one large SGD
    step that lowers the loss."""
    cfg = registry.get_config(arch).smoke()
    params = lm.init(0, cfg, device="cpu")
    batch = _batch(cfg, np.random.default_rng(10), S=64)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, _ = lm.forward(params, cfg, tb["tokens"], tb.get("prefix"))
    assert logits.shape == (2, 64, lm.padded_vocab(cfg))
    assert bool(torch.isfinite(logits).all())
    l0, _, grads = _grads(params, cfg, batch)
    gnorm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
    assert bool(torch.isfinite(gnorm)) and float(gnorm) > 0
    with torch.no_grad():
        for n, p in params.named_parameters():
            p.sub_(0.5 * grads[n])
        l1, _ = lm.loss(params, cfg, tb)
    assert bool(torch.isfinite(l1)) and float(l1) < float(l0)


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen1.5-0.5b",
                                  "musicgen-large", "mamba2-2.7b",
                                  "jamba-1.5-large-398b", "dbrx-132b"])
def test_prefill_decode_matches_forward(arch):
    """The reference's autoregressive check on the port: prefill of 16
    tokens then decode steps give the training forward's logits (float32
    caches), within its 2e-2, and the same argmax. At its no-drop capacity
    factor of 16: decode (T = 1) never drops, so the forward must not
    either."""
    cfg = dataclasses.replace(registry.get_config(arch).smoke(),
                              capacity_factor=16.0)
    params = lm.init(0, cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab, size=(1, 24)))
    with torch.no_grad():
        full, _ = lm.forward(params, cfg, toks)
    full = lm.mask_pad_logits(cfg, full.float()[0])
    last, caches = lm.prefill(params, cfg, toks[:, :16], max_len=24,
                              cache_dtype=torch.float32)
    outs = [last]
    for t in range(16, 24):
        step_logits, caches = lm.decode_step(params, cfg, toks[:, t:t + 1],
                                             caches)
        outs.append(step_logits)
    for i, got in enumerate(outs[:-1]):
        got = lm.mask_pad_logits(cfg, got.float())[0]
        want = full[15 + i]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-2,
                                   atol=2e-2)
        assert int(got.argmax()) == int(want.argmax()), (arch, i)


def test_recommended_config_smoke_step():
    """The reference's recommended-config step, on a dense arch: causal
    skip, the chunked CE (128 columns at smoke size) and two microbatches
    give a finite loss and advance the step."""
    from repro_torch.train import step
    cfg = dataclasses.replace(
        registry.get_recommended_config("qwen1.5-0.5b").smoke(),
        ce_chunk_vocab=128, num_microbatches=2)
    state = step.init_state(0, cfg, device="cpu")
    toks = np.random.default_rng(12).integers(0, cfg.vocab, size=(4, 64))
    fn = step.make_train_step(cfg, num_microbatches=cfg.num_microbatches)
    state, metrics = fn(state, {"tokens": toks})
    assert bool(torch.isfinite(metrics["loss"]))
    assert int(state["step"]) == 1
