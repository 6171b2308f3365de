"""The port's serving engine against the JAX package's.

With the reference's weights (``convert.lm_params_from_jax``) and its
symbol table (``convert.norepeat_params_from_jax``) carried across, greedy
``generate`` gives the reference's tokens, bit for bit, at ``paper-tiny``
and ``qwen1.5-0.5b`` (``.smoke()``), for no_repeat_ngram in {0, 3, 4}, on
both of the port's planes (fused and legacy; the reference's own tests
hold its planes equal, tests/test_serve_plane.py:470); the banned counts
and the fused plane's telemetry agree too. A sampled run draws from a
``torch.Generator``, not threefry, so it is not bit-equal to the
reference's: it is held to the distribution's support — every token in the
vocabulary, within its row's top-k, never a banned one — and to
reproducibility under one seed.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.nn import lm as jlm
from repro.serve.engine import SamplerConfig as JSamplerConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.kernels import api
from repro_torch.nn import lm
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import SamplerConfig, ServeEngine

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)

_MODELS = {}


def _model(arch):
    """(reference config, values, port config, port params), built once."""
    if arch not in _MODELS:
        jcfg = jget_config(arch).smoke()
        cfg = registry.get_config(arch).smoke()
        values, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
        params = lm.init(0, cfg, device="cpu")
        params.load_state_dict(convert.lm_params_from_jax(values, "cpu"))
        _MODELS[arch] = (jcfg, values, cfg, params)
    return _MODELS[arch]


def _engines(arch, **sampler):
    jcfg, values, cfg, params = _model(arch)
    jeng = JServeEngine(jcfg, values, JSamplerConfig(**sampler))
    engs = {}
    for plane in ("fused", "legacy"):
        engs[plane] = ServeEngine(cfg, params, SamplerConfig(
            **sampler, ngram_plane=plane))
        if jeng.nrn is not None:
            engs[plane].nrn.rebind_params(
                convert.norepeat_params_from_jax(jeng.nrn.params, "cpu"))
    return cfg, jeng, engs


@pytest.mark.parametrize("arch", ["paper-tiny", "qwen1.5-0.5b"])
@pytest.mark.parametrize("n", [0, 3, 4])
def test_greedy_tokens_match_reference_on_both_planes(arch, n):
    cfg, jeng, engs = _engines(arch, temperature=0.0, no_repeat_ngram=n,
                               seed=3)
    prompts = np.random.default_rng(n).integers(
        0, cfg.vocab, size=(3, 6)).astype(np.int32)
    want, jstats = jeng.generate(prompts, 10)
    stats = {}
    for plane, eng in engs.items():
        got, stats[plane] = eng.generate(prompts, 10)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=plane)
        assert (stats[plane]["banned_candidates"]
                == jstats["banned_candidates"]), plane
    if n:
        tele, jtele = stats["fused"]["telemetry"], jstats["telemetry"]
        tele.pop("dispatches"), jtele.pop("dispatches")   # per process
        assert tele == jtele


def test_sampled_run_stays_in_vocab_and_top_k():
    """Sampled generate: every token in the vocab (never the padded tail),
    within top-k of the masked logits at its step, never banned; the same
    seed repeats the run. The masked logits of each step are read from the
    decode plane as the engine calls it."""
    cfg, params = _model("paper-tiny")[2:]
    K = 7
    eng = ServeEngine(cfg, params, SamplerConfig(
        temperature=0.8, top_k=K, no_repeat_ngram=2, seed=5))
    seen = []
    real_decode = api.decode

    def spy(spec, logits, *args, **kw):
        out = real_decode(spec, logits, *args, **kw)
        seen.append(out)
        return out

    prompts = np.random.default_rng(9).integers(0, cfg.vocab, size=(4, 5))
    api.decode = spy
    try:
        toks, stats = eng.generate(prompts, 12)
    finally:
        api.decode = real_decode
    assert len(seen) == 12 and toks.shape == (4, 12)
    assert ((toks >= 0) & (toks < cfg.vocab)).all()
    rows = torch.arange(4)
    for step, out in enumerate(seen):
        t = torch.from_numpy(toks[:, step]).to(torch.int64)
        kth = torch.topk(out["logits"], K, dim=-1).values[:, -1]
        assert (out["logits"][rows, t] >= kth).all()
        words = out["banned"].to(torch.int64)[rows, t // 32]
        assert ((words >> (t % 32)) & 1 == 0).all()
    again, _ = eng.generate(prompts, 12)
    np.testing.assert_array_equal(toks, again)
    assert stats["telemetry"]["decode_steps"] == 4 * 12


def test_engine_rejects_misuse():
    cfg, params = _model("paper-tiny")[2:]
    with pytest.raises(ValueError, match="ngram_plane"):
        ServeEngine(cfg, params, SamplerConfig(no_repeat_ngram=3,
                                               ngram_plane="nope"))
    with pytest.raises(ValueError, match="pass canary_bits"):
        ServeEngine(cfg, params, SamplerConfig(no_repeat_ngram=3,
                                               canary_log2_m=8))
    with pytest.raises(ValueError, match="canary_bits needs"):
        ServeEngine(cfg, params, SamplerConfig(),
                    canary_bits=np.zeros(8, np.uint32))
    # the multi-device pool is ported: at two shards a batch of 3 (the
    # pool rounded up to 4) gives the one-device tokens, sampled too
    scfg = SamplerConfig(temperature=0.8, top_k=5, no_repeat_ngram=3, seed=2)
    prompts = np.random.default_rng(4).integers(0, cfg.vocab, size=(3, 5))
    want, wstats = ServeEngine(cfg, params, scfg).generate(prompts, 6)
    got, stats = ServeEngine(cfg, params, scfg,
                             data_shards=2).generate(prompts, 6)
    np.testing.assert_array_equal(got, want)
    assert stats["banned_candidates"] == wstats["banned_candidates"]
    with pytest.warns(UserWarning, match="exceeds the hash width"):
        engine_mod.NoRepeatNgram(cfg, SamplerConfig(no_repeat_ngram=33),
                                 device="cpu")


def test_serve_cli_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--batch", "2", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "paper-tiny on cpu: generated 8 tokens" in out
