"""Batched serving engine: prefill + decode with hash-based no-repeat-ngram.

``no_repeat_ngram`` is the paper's rolling hash at serving time: per
sequence a tiny Bloom filter of the n-grams generated so far. At each step
the *recursive* structure of CYCLIC gives the hash of every candidate
continuation in O(vocab) bitwise ops — h_cand = rotl(h_prefix, 1) XOR
h1[v] for all v at once — so banning repeats costs one rotate, one
XOR-broadcast and one Bloom probe per candidate, not a re-hash of the
window. (Bloom false positives over-ban slightly; log2_m/bloom_k set the
rate.)

Two implementations of that epilogue, as in the reference
(``repro/serve/engine.py``):

* the **fused plane** (default, ``ngram_plane="auto"``): a
  :class:`~repro_torch.serve.sessions.SessionPool` runs the decode kernel
  (hash + probe + mask), sampling and the state advance each step, with
  the per-session state updated in place and telemetry kept on the device;
* the **legacy path** (``ngram_plane="legacy"``): the readable per-step
  chain, kept as the oracle for the fused plane — its probes are
  ``ref.bloom_probe_hits``, the helper behind the kernel's plain version.

Both apply the paper's Theorem-2 discard: probes (adds AND lookups) derive
from ``h & spec.hash_mask``, never from the n-1 dependent high bits.
``n > L`` is accepted but warns (``DecodeSpec.degraded``).

Sampling draws from a ``torch.Generator`` seeded from
``SamplerConfig.seed`` (Gumbel-max, as ``jax.random.categorical``), so
sampled tokens are reproducible within the port but are not the
reference's threefry draws; greedy tokens equal the reference's.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import families, u32
from repro_torch.kernels import api, shard
from repro_torch.kernels import ref as _kref
from repro_torch.kernels.plan import DecodeSpec
from repro_torch.nn import lm
from repro_torch.serve import sessions, telemetry
from repro_torch.serve.sessions import SessionPool, _bloom_add_rows

_PLANES = ("auto", "fused", "legacy")


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 1.0
    top_k: int = 0                   # 0 = full softmax
    no_repeat_ngram: int = 0         # 0 = disabled
    bloom_log2_m: int = 14
    bloom_k: int = 2                 # double-hashed probes per candidate
    hash_bits: int = 32              # CYCLIC hash width L
    ngram_plane: str = "auto"        # auto | fused | legacy
    canary_log2_m: int = 0           # decontam canary filter (fused plane)
    canary_k: int = 4
    seed: int = 0


class NoRepeatNgram:
    """Per-sequence Bloom state over generated n-gram fingerprints.

    The readable per-step implementation — and the oracle the fused decode
    plane (:mod:`repro_torch.serve.sessions`) is tested against. State is a
    dict of tensors: ``prefix_hash`` (B,), ``window`` (B, n-1) and
    ``bloom`` (B, m/32) uint32, ``count`` (B,) int32; ``update`` returns a
    new dict.
    """

    def __init__(self, cfg: ModelConfig, scfg: SamplerConfig,
                 device="cuda"):
        self.n = scfg.no_repeat_ngram
        # DecodeSpec centralizes validation and the Theorem-2 discard mask;
        # n > L is the degraded regime — legal, exact on true repeats, no
        # pairwise FP bound
        self.spec = DecodeSpec(n=self.n, L=scfg.hash_bits,
                               log2_m=scfg.bloom_log2_m, k=scfg.bloom_k)
        self.device = torch.device(device)
        if self.spec.degraded:
            warnings.warn(
                f"no_repeat_ngram n={self.n} exceeds the hash width "
                f"L={self.spec.L}: rotations alias mod L, so the pairwise-"
                f"independence FP bound is void (banning stays exact on "
                f"true repeats). Prefer n <= L.", UserWarning, stacklevel=2)
        # the symbol table alone is family-independent: one draw of V
        # uniform uint32 (the reference's family gate L >= n does not apply)
        gen = torch.Generator().manual_seed(scfg.seed + 99)
        self.rebind_params({"h1": families.init_h1(
            gen, lm.padded_vocab(cfg), self.device)})

    def rebind_params(self, params: Dict) -> None:
        """Adopt another symbol-table draw, ``{"h1": (padded vocab,)}`` as a
        tensor (:func:`repro_torch.convert.norepeat_params_from_jax`) or an
        array. Do it before generating: a state built under one table is
        meaningless under another."""
        h1 = api.as_u32(params["h1"], self.device).contiguous()
        self.params = {"h1": h1}
        self.h1 = u32.keep_low(h1, self.spec.L)

    def init_state(self, batch: int) -> Dict[str, torch.Tensor]:
        z = lambda shape: api.full_u32(shape, 0, self.device)
        return {
            # rolling hash of the last n-1 tokens, advanced recursively
            "prefix_hash": z((batch,)),
            # h1 values of the last n-1 tokens (to expire the oldest term)
            "window": z((batch, self.n - 1)),
            "bloom": z((batch, self.spec.n_words)),
            "count": torch.zeros((batch,), dtype=torch.int32,
                                 device=self.device),
        }

    def banned(self, state) -> torch.Tensor:
        """(B, V) bool: would token v complete an already-seen n-gram?"""
        spec = self.spec
        cand = (u32.rotl_const(u32.lanes(state["prefix_hash"]), 1,
                               spec.L)[:, None]
                ^ u32.lanes(self.h1)[None, :])
        hits = _kref.bloom_probe_hits(cand & spec.hash_mask, state["bloom"],
                                      spec.k, spec.log2_m)
        return hits & (state["count"] >= spec.n - 1)[:, None]

    def update(self, state, token) -> Dict[str, torch.Tensor]:
        """Advance the rolling window with the sampled tokens (B,)."""
        spec = self.spec
        token = torch.as_tensor(token, device=self.device).to(torch.int64)
        h1v = u32.lanes(self.h1.view(torch.int32)[token])
        new_hash = u32.rotl_const(u32.lanes(state["prefix_hash"]), 1,
                                  spec.L) ^ h1v
        count = state["count"] + 1
        # when the window is full, new_hash is a complete n-gram hash:
        # record it (discarded to the pairwise-independent bits, matching
        # the probe side), then expire the oldest symbol from the prefix;
        # the rotation is (n-1) mod L, exact because rotl is L-periodic
        full = count >= spec.n
        bloom = _bloom_add_rows(state["bloom"].clone(),
                                new_hash & spec.hash_mask, spec.k,
                                spec.log2_m, rows=full)
        oldest = u32.lanes(state["window"][:, 0])
        expired = new_hash ^ u32.rotl_const(oldest, (spec.n - 1) % spec.L,
                                            spec.L)
        prefix = torch.where(full, expired, new_hash)
        window = torch.cat([u32.lanes(state["window"][:, 1:]), h1v[:, None]],
                           dim=1)
        return {"prefix_hash": prefix.to(torch.uint32),
                "window": window.to(torch.uint32), "bloom": bloom,
                "count": count}


class ServeEngine:
    """Prefill + decode with the decode-time n-gram plane.

    ``params`` is the LM module of :func:`repro_torch.nn.lm.init`; the
    engine runs on its device. ``scfg.ngram_plane`` picks the epilogue:
    ``"auto"``/``"fused"`` run the :class:`SessionPool` step;
    ``"legacy"`` runs the readable chain. Greedy (temperature=0) outputs
    are identical between the planes; sampled runs draw from the same
    masked distribution with different streams (one uniform a candidate
    from the pool's step on the fused plane, from the engine's loop on the
    legacy one). With ``mesh`` / ``data_shards`` the fused plane's pool
    runs row by row over a data mesh (:class:`SessionPool`): its capacity
    is the batch rounded up to the shard count (pad rows stay inactive),
    the model's logits stay on the model's device and the pool splits them
    by rows; tokens and telemetry are the same at any shard count.
    """

    def __init__(self, cfg: ModelConfig, params,
                 scfg: SamplerConfig = SamplerConfig(), *,
                 canary_bits=None, impl: str = "auto",
                 mesh=None, data_shards: Optional[int] = None):
        if scfg.ngram_plane not in _PLANES:
            raise ValueError(f"ngram_plane must be one of {_PLANES}, got "
                             f"{scfg.ngram_plane!r}")
        self.cfg, self.params, self.scfg = cfg, params, scfg
        self.device = lm.device_of(params)
        self.mesh = shard.resolve(mesh, data_shards, self.device)
        self.plane = ("fused" if scfg.ngram_plane == "auto"
                      else scfg.ngram_plane)
        self.impl = impl
        self.nrn = (NoRepeatNgram(cfg, scfg, self.device)
                    if scfg.no_repeat_ngram >= 2 else None)
        self.decode_spec = None
        self.canary_bits = None
        if self.nrn is not None and self.plane == "fused":
            self.decode_spec = dataclasses.replace(
                self.nrn.spec, canary_log2_m=scfg.canary_log2_m,
                canary_k=scfg.canary_k)
            if self.decode_spec.has_canary:
                if canary_bits is None:
                    raise ValueError("canary_log2_m set: pass canary_bits")
                self.canary_bits = api.as_u32(canary_bits, self.device)
        elif canary_bits is not None:
            raise ValueError("canary_bits needs no_repeat_ngram >= 2 and "
                             "the fused plane (plus canary_log2_m)")

    @torch.no_grad()
    def generate(self, prompts, max_new_tokens: int,
                 prefix_embeds=None) -> Tuple[np.ndarray, Dict]:
        """prompts (B, P) token ids -> ((B, max_new_tokens) int32 tokens,
        stats). Runs under no-grad: the model's parameters take gradients,
        serving records no graph."""
        cfg, scfg = self.cfg, self.scfg
        prompts = torch.as_tensor(prompts, device=self.device).to(torch.int64)
        B, P = prompts.shape
        pfx = cfg.prefix_len if prefix_embeds is not None else 0
        max_len = P + pfx + max_new_tokens
        last_logits, caches = lm.prefill(self.params, cfg, prompts, max_len,
                                         prefix_embeds)
        gen = torch.Generator(device=self.device).manual_seed(scfg.seed)
        if self.nrn is not None and self.plane == "fused":
            return self._generate_fused(prompts, max_new_tokens, last_logits,
                                        caches, gen)
        nrn_state = None
        if self.nrn is not None:
            nrn_state = self.nrn.init_state(B)
            for t in range(P):   # charge the filter with the prompt
                nrn_state = self.nrn.update(nrn_state, prompts[:, t])
        out = []
        banned_count = 0
        logits = last_logits
        for _ in range(max_new_tokens):
            logits = lm.mask_pad_logits(cfg, logits.to(torch.float32))
            if self.nrn is not None:
                banned = self.nrn.banned(nrn_state)[:, : logits.shape[-1]]
                banned_count += int(banned.sum())
                logits = logits.masked_fill(banned, _kref.NEG_LOGIT)
            token = sessions.sample(logits, scfg.temperature, scfg.top_k, gen)
            out.append(token)
            if self.nrn is not None:
                nrn_state = self.nrn.update(nrn_state, token)
            logits, caches = lm.decode_step(self.params, cfg, token[:, None],
                                            caches)
        tokens = torch.stack(out, dim=1).to(torch.int32)
        return tokens.cpu().numpy(), {"banned_candidates": banned_count}

    def _generate_fused(self, prompts, max_new_tokens, last_logits, caches,
                        gen):
        """The decode loop on the fused plane: per step, one pool step
        (decode kernel + sample + state advance, telemetry kept on the
        device) plus the model's own decode step — no per-step host
        syncs."""
        cfg, scfg = self.cfg, self.scfg
        B, P = prompts.shape
        d = self.mesh.size if self.mesh is not None else 1
        C = -(-B // d) * d         # inactive pad rows: mesh divisibility
        pool = SessionPool(self.decode_spec, C, self.nrn.h1,
                           canary_bits=self.canary_bits, impl=self.impl,
                           device=self.device, mesh=self.mesh)
        pool.admit(B)
        pad = lambda t: shard.pad_rows(t, C - B)
        pool.prime(pad(prompts))   # charge the filters with the prompt
        out = []
        logits = last_logits
        for _ in range(max_new_tokens):
            logits = lm.mask_pad_logits(cfg, logits.to(torch.float32))
            # the batch's own uniforms, as without a mesh, padded to C
            noise = sessions.draw_noise(logits.shape, scfg.temperature, gen,
                                        self.device)
            token = pool.step(pad(logits), temperature=scfg.temperature,
                              top_k=scfg.top_k,
                              noise=None if noise is None else pad(noise))
            token = token[:B]
            out.append(token)
            logits, caches = lm.decode_step(self.params, cfg, token[:, None],
                                            caches)
        tokens = torch.stack(out, dim=1)
        snap = telemetry.snapshot(pool)
        # prompt charging advances no decode step, so rates cover exactly
        # the generated tokens
        return tokens.cpu().numpy(), {
            "banned_candidates": snap["banned_candidates"],
            "telemetry": snap}
