"""The hash->sketch data-plane and its hand-written CUDA kernels.

- plan.py          declarative SketchPlan (a copy of the JAX package's)
- api.py           the plan engine: api.run(plan, h1v, ...) validates,
                   dispatches (kernel on CUDA, plain version on CPU) and
                   runs every sketch in ONE rolling-hash pass
- stream.py        chunked streaming executor with a carried state
- shard.py         the multi-device layer: run_sharded, rowwise and the
                   DataMesh every mesh/data_shards knob takes
- decode.py        the decode plane's wrapper (launch count in LAUNCHES):
                   no-repeat and canary probes, logit masking
- sketch_fused.py  the plan kernel's wrapper (launch count in LAUNCHES):
                   MinHash, HLL, CountMin and Bloom epilogues, one launch
                   for any plan, and the deprecated single-sketch wrappers
                   cyclic_{minhash,hll,bloom}_fused over it; and the byte
                   path's cyclic_rolling_fused (h1 lookup + CYCLIC, launch
                   count in LOOKUP_LAUNCHES)
- ops.py           ops.cyclic / ops.general: the plain window hashes;
                   ops.cyclic_fused: the byte path; and the deprecated
                   single-sketch shims ops.cyclic_{minhash,hll,bloom}
- cyclic_fused.py  deprecated module shim re-exporting
                   cyclic_rolling_fused (warns once a process)
- cyclic.py,       the window-hash kernels' wrappers (launch counts in
  general.py       LAUNCHES)
- bloom.py         standalone decontamination scan: Bloom membership of
                   hash pairs (launch count in LAUNCHES)
- hll.py           standalone telemetry: HLL registers of a hash stream
                   (launch count in LAUNCHES)
- csrc/            CUDA C++ sources for sm_90a, built by _build.py at
                   first use with nvcc and loaded with ctypes
- ref.py           plain PyTorch versions of every kernel

The entry points api.run, api.decode, stream.run_stream, shard.run_sharded
and shard.rowwise (and serve.sessions.SessionPool.step) declare their
launch and dispatch contracts with ``@kernel_contract``;
``python -m repro_torch.analysis`` checks them (repro_torch.analysis).
"""
