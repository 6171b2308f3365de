"""Static analysis of the port: launch and dispatch contracts, the
Theorem-1/2 discard checker, and the lint.

- contracts.py @kernel_contract declarations next to every entry point +
               verify_contracts(): run each registered entry across both
               hash families and the shard counts, read the port's launch,
               dispatch and merge counters around the call, and diff the
               census against its declaration (plus in-place storage,
               output dtypes and the launches' shared memory)
- discard.py   Theorem-1/2 discard checking — statically (AST: probes must
               route through spec.hash_mask) and at trace time (mask
               propagation over make_fx aten graphs of the decode plane)
- lint.py      AST lint of src/repro_torch and tests/test_torch_*.py,
               distilled from real past bugs; findings with file:line
               anchors, nonzero exit for CI

Run the whole pass: ``python -m repro_torch.analysis`` (``--lint`` /
``--discard`` / ``--contracts`` select layers; default runs everything;
contracts run on ``cuda`` unless ``--device cpu``).

The JAX package's ``analysis/jaxpr.py`` (its jaxpr walker and HLO parsers)
has no counterpart: the port has no jaxpr, and its contracts read the
counters instead.

This package imports no kernel module at import time — the entry points
import ``analysis.contracts`` for the decorator, and ``verify_contracts``
imports them back lazily, so the dependency stays one-way at import time.
"""
