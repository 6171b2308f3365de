"""The hash->sketch data-plane and its hand-written CUDA kernels.

- plan.py          declarative SketchPlan (a copy of the JAX package's)
- api.py           the plan engine: api.run(plan, h1v, ...) validates,
                   dispatches (kernel on CUDA, plain version on CPU) and
                   runs every sketch in ONE rolling-hash pass
- stream.py        chunked streaming executor with a carried state
- decode.py        the decode plane's wrapper (launch count in LAUNCHES):
                   no-repeat and canary probes, logit masking
- sketch_fused.py  the plan kernel's wrapper (launch count in LAUNCHES):
                   MinHash, HLL, CountMin and Bloom epilogues, one launch
                   for any plan
- ops.py           ops.cyclic / ops.general: the plain window hashes
- cyclic.py,       their kernels' wrappers (launch counts in LAUNCHES)
  general.py
- csrc/            CUDA C++ sources for sm_90a, built by _build.py at
                   first use with nvcc and loaded with ctypes
- ref.py           plain PyTorch versions of every kernel
"""
