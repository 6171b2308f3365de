"""The hash->sketch data-plane and its hand-written CUDA kernel.

- plan.py          declarative SketchPlan (a copy of the JAX package's)
- api.py           the plan engine: api.run(plan, h1v, ...) validates,
                   dispatches (kernel on CUDA, plain version on CPU) and
                   runs every sketch in ONE rolling-hash pass
- stream.py        chunked streaming executor with a carried state
- sketch_fused.py  the plan kernel's wrapper (launch count in LAUNCHES)
- csrc/            CUDA C++ sources for sm_90a, built by _build.py at
                   first use with nvcc and loaded with ctypes
- ref.py           plain PyTorch versions of every kernel
"""
