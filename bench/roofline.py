"""The bound of a call's hashing work on one H100: the least time the card
could take for it.

A frozen copy of ``chip_smoke.py``'s ``hash_ops``, ``window_ops``,
``roofline`` and ``bound`` (CYCLIC only), with the H100 SXM data sheet's
peaks written out here instead of read from the program. A plan is given
as a plain description, ``(family, n, L, sketches)`` with ``sketches`` a
tuple of ``(kind, size)``: ``("minhash", k)``, ``("hll", b)``,
``("cms", depth)`` or ``("bloom", k)``, so the yardstick depends on no
class of the program.

The bound of a call is the larger of its bytes at HBM's rate and its
instructions at their issue rates. Bytes count each input read once and
each output written once: the call's token ids, its symbol tables, its
operands, and the sketch state it takes in and gives back. Instructions
count the fewest a valid window needs: the h1 lookup (one load a token a
stream), the rolling hash, the discard, and each sketch's epilogue; a
Bloom epilogue counts the probes this call's data needs (a window stops at
its first miss).
"""
from __future__ import annotations

from typing import Sequence, Tuple

# H100 SXM: 132 SMs at the 1.98 GHz boost clock (NVIDIA's Hopper white
# paper), and 3.35 TB/s of HBM3 (the data sheet). Each SM issues integer
# instructions to two pipes of 64 lanes a clock: the INT32 (ALU) pipe, which
# runs logic, shifts and min/max, and the FMA pipe, which also runs IMAD.
# Loads and atomics issue to the SM's 32 load/store units: 32 lanes a clock.
SMS, CLOCK_HZ = 132, 1.98e9
LANES_PER_S = SMS * 64 * CLOCK_HZ
LSU_LANES_PER_S = SMS * 32 * CLOCK_HZ
HBM_BYTES_PER_S = 3.35e12

Plan = Tuple[str, int, int, Sequence[Tuple[str, int]]]


def hash_ops(family: str, n: int, L: int) -> int:
    """Fewest ALU-pipe instructions for one CYCLIC window hash in its
    rolling form, one step a window: h' = rotl(h, 1) ^ rotl(out, n) ^ in is
    two rotations (one funnel shift each at L = 32; two shifts below it,
    with the OR and the mask folded into the XORs) and the XORs (one
    three-input LOP3 at L = 32, two below)."""
    if family != "cyclic":
        raise ValueError(f"the frozen bound covers CYCLIC only, not {family!r}")
    full = L == 32
    rots = sum(1 for r in (1 % L, n % L) if r)
    return rots * (1 if full else 2) + (1 if full else 2)


def window_ops(plan: Plan, probes: float = 0.0) -> Tuple[float, float, float]:
    """Fewest instructions a valid window needs, as (ALU-pipe, FMA-pipe,
    load/store) counts: per stream the h1 lookup (one load), the hash and one
    AND for the discard mask, then per sketch
      minhash  per lane one IMAD (a*h + b, FMA) and one IMNMX (ALU);
      hll      AND for the index, shift, BREV + FLO for ctz, min with
               rank_bits, +1 (ALU), one register update (load/store);
      cms      per row one IMAD (FMA), one shift for the column (ALU) and
               one atomic add (load/store);
      bloom    OR for the odd stride (ALU), then per probe one IMAD
               (h + i*stride, FMA), the mask AND, the word shift and the bit
               test (three ALU) and one filter load; ``probes`` is the mean
               number of probes a window needs on this data."""
    family, n, L, sketches = plan
    streams = 2 if any(kind == "bloom" for kind, _ in sketches) else 1
    alu = float(streams * (hash_ops(family, n, L) + 1))
    fma, lsu = 0.0, float(streams)
    for kind, size in sketches:
        if kind == "minhash":
            alu, fma = alu + size, fma + size
        elif kind == "hll":
            alu, lsu = alu + 6, lsu + 1
        elif kind == "cms":
            alu, fma, lsu = alu + size, fma + size, lsu + size
        elif kind == "bloom":
            alu, fma, lsu = alu + 1 + 3 * probes, fma + probes, lsu + probes
        else:
            raise ValueError(f"unknown sketch kind {kind!r}")
    return alu, fma, lsu


def roofline(items: float, nbytes: float, alu: float, fma: float,
             lsu: float) -> Tuple[float, str]:
    """(bound seconds, "bytes" | "operations") for ``items`` windows of
    ``alu`` ALU-pipe, ``fma`` FMA-pipe and ``lsu`` load/store instructions
    each, moving ``nbytes``: the larger of the bytes at HBM's rate and the
    instructions at their issue rates (the ALU pipe's own at one pipe's
    rate, all integer instructions over both pipes, or the loads and
    atomics at the load/store units' rate, whichever is longest)."""
    t_ops = max(items * alu / LANES_PER_S,
                items * (alu + fma) / 2 / LANES_PER_S,
                items * lsu / LSU_LANES_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bound(plan: Plan, windows: float, nbytes: float,
          probes: float = 0.0) -> Tuple[float, str]:
    """The bound of ``windows`` valid windows of ``plan`` moving ``nbytes``."""
    return roofline(windows, nbytes, *window_ops(plan, probes))


def device_share(m: dict):
    """The window's hashing work at the bound (``m["bound_s"]``) over the
    device time of every operation the calls into the program put on the
    card in the traced window, in percent; None without device time. Both
    work and time are counted from the work, not from a kernel's name."""
    t = m.get("trace")
    if not t or not t["device_s"]:
        return None
    return 100.0 * m["bound_s"] / t["device_s"]
