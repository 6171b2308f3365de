"""Serving: prefill/decode engine + the decode-time n-gram plane.

`engine.ServeEngine` drives generation; `sessions.SessionPool` holds the
per-session sketch state (rolling prefix hash, h1 ring, no-repeat Bloom)
and runs the decode kernel (`kernels/csrc/decode.cu` via `api.decode`)
once per step; `telemetry` reads the counters (banned rate, Bloom fill,
decontam-canary hits, pool operations).
"""
