#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and ``nvidia-smi``, and no network. In order it

1. prints the card's name and power limit;
2. builds every kernel under ``src/repro_torch/kernels/csrc`` with nvcc,
   and the measurement kernels ``tools/countmin_red_floor.cu``,
   ``tools/decode_stream_floor.cu`` and ``tools/hll_split.cu``, one process
   per source, all started together;
3. holds every kernel bit-exact against its plain PyTorch version on the
   card: the plan kernel (``api.run(impl="kernel")`` against
   ``impl="ref"``) for MinHash, HLL (b in {4, 12, 14} in shared memory,
   {15, 16} in global memory, an explicit rank_bits), CountMin (w in
   {12, 16}), Bloom (log2_m in {20, 22}), the stats plan (HLL + CountMin)
   and a plan of all four, both families, B in {8, 64, 1024} (B=8: fewer
   tiles than blocks fit on the card; B=1024 at S=8192: 8 to 16 tiles a
   block), S in {7, 520, 1024, 8192} (B=64, S=1024 is the ``DataPlane``
   launch), random ``n_windows``, ``w_start`` and
   ``init``, plus the CYCLIC stats plan over one row of 65,600 x 1,024
   windows (more segments than a grid dimension once took) and a plan of
   ten sketches, two or three of each kind, both families (one launch a
   group of eight); ``ops.cyclic``
   / ``ops.general`` at n in {1, 8, 25, 32}, L in {16, 32}, among other
   shapes at (1024, 64), the heavy-hitter query's,
   and (1024, 8192), the Fig. 1 pair's (GENERAL's there with the route
   cases below), and at n > L, (n, L) in {(9, 8),
   (20, 16), (33, 32)}; ``ops.general`` on each of its product routes,
   each printed by ``general.route`` (the fold and the chunk tables, every
   count of terms and tables the kernel has), at (1024, 8192) and (3, 300):
   n in {1, 8, 25, 26, 32, 33, 40} at L = 32 with find_irreducible_host's
   p and with a dense one (``DENSE_P32``, weight 9, also n in {12, 20}),
   L in {19, 20}, and n in {1, 8, 25, 32} at L = 16; and ``ops.cyclic``,
   ``ops.general`` and
   ``ops.cyclic_fused`` over one row of 65,536 segments of the rolling
   launcher's own size (``rolling_block_windows``), the windows of the
   first 6 and of the last 6 segments against the plain version of their
   slice; at the stats launch's shape (1024 x 519) the plan
   kernel again with warm and zeroed registers, its carry copied and
   donated (then its profile must hold no copy or fill);
4. drives the dedup path (``MinHashDeduper.add_batch``) over a 100,000
   document corpus with planted near-duplicates (CYCLIC) and over 20,000 of
   them (GENERAL), at the reference's published widths (n=8, L=32, k=64,
   16 bands): the kernel's launch count must rise, recall and precision
   against the planted truth must exceed 0.9, and 2,000 documents re-signed
   through the plain version on the card must give the same signatures;
5. drives the data-plane path at the defaults of ``StatsConfig`` and
   ``DecontamConfig`` (n=8, L=32, HLL b=12, CountMin 4 x 2^16, Bloom 2^22
   bits with k=4): ``NgramStats.update_stream_many`` over the deduplicated
   corpus packed with EOS, in (8, 1024, 512) blocks, for CYCLIC and GENERAL,
   with heavy-hitter queries through ``ops.cyclic`` / ``ops.general``, whose
   counts must equal a plain-version twin's on the same state;
   ``Decontaminator.flag`` over the packed stream in 512 x 1024 batches with
   rows of a 500-document eval set planted; ``DataPlane.next_batch`` for 100
   steps. Every kernel's launch count must rise. Then: the HLL estimate over
   a 2 M-token prefix is within 0.1 of the exact distinct 8-gram count and
   its registers and table equal a plain-version run on the card; every
   planted row flags, other rows flag below 0.01, and the counts equal the
   plain version's;
6. holds the decode kernel (``api.decode(impl="kernel")``) bit-equal to
   its plain version on the card — masked logits, banned words and canary
   words — at B in {1, 16, 256} x V in {152064, 151936, 1000} x n in {2, 4,
   8, 33} x L in {32, 20} x log2_m in {14, 20, 24} (the session filter in
   shared memory, and in global memory) x canary off or at canary_log2_m
   in {20, 24} x ready all set or mixed, and at 65,600 rows (more than a
   grid dimension holds) x V = 96; in the serve phase, at (16, 152064) and
   (256, 152064) with the pool's real state, the decode split: the launch,
   the same launch with the canary filter off, and the stream floor
   (``tools/decode_stream_floor.cu``, no probe at all, on the kernel's grid
   and on the first version's grid);
7. drives the serve path (``ServeEngine.generate``) on qwen1.5-0.5b at its
   published widths with random weights, 16 prompts of 128 tokens, 64 new
   tokens, ``no_repeat_ngram=4`` with the shared canary filter (2^20 bits,
   k=4), 4 prompts ending in the first 3 tokens of a canary 4-gram. Gates:
   (a) every step of a greedy call, the kernel's outputs equal the plain
   version's on the same inputs; (b) ``impl="kernel"`` and ``impl="ref"``
   give the same greedy tokens and telemetry counts; (c) the fused and the
   legacy plane give the same greedy tokens; (d) no generated token
   completes a 4-gram already in its row; (e) every planted row registers
   a canary hit; (f) every token of a sampled call (temperature 0.8, top-k
   50) lies within its row's top 50 and was not banned; (g) the decode
   kernel launched once per decode step;
8. drives the paper's byte-level path over ``bench_corpus(4_300_000)``
   (the King-James-sized English-byte stream) through ``ops.cyclic_fused``
   (the h1 lookup fused into the CYCLIC kernel), ``hll_update`` and
   ``bloom_probe``. Gates: (a) ``cyclic_fused`` kernel == plain version on
   the corpus at n in {1, 5, 8, 15, 25} (L=32), n in {5, 8} (L=20) and
   (n, L) in {(9, 8), (20, 16), (33, 32)} (n > L), at
   (1024, 8192) random bytes (where it also equals ``ops.cyclic`` of the
   looked-up values), at (3, 300) and on a row holding tokens -300, -1, 256
   and 300; (b) ``hll_update`` kernel == plain at N in {1, 7, 300, 5000,
   4097 and 8193 (just past one and two blocks' first sweep), 4299996} x b
   in {1, 2, 4, 10, 12, 14, 15, 16, 17, 23, 31} (shared registers up to 14,
   the global registers above) x rank_bits in {32-b, 32}, with 0 and values
   below 2^b among the inputs; (c) the §2 count: the HLL (b=12,
   rank_bits=16) of the corpus's CYCLIC n=5 hashes kept to their 28
   pairwise bits is within 0.1 of the exact distinct 5-gram count, and its
   registers equal the plain version's; (d) ``bloom_probe`` kernel == plain
   at (B, S) in {(1, 4299993), (1024, 4096), (3, 300)} x (k, log2_m) in
   ``BLOOM_CASES``, which cover its three routes, each printed by
   ``bloom.route``: the filter whole in each block's shared memory (log2_m
   14, 18, 20), its first 224 KiB there and the rest through the read-only
   cache (21, 22, 23), all through that cache (24, 26); (e) the
   decontamination scan: a
   Bloom filter (2^22 bits, k=4) of the 8-grams of the first 500,000
   chars, from two CYCLIC n=8 draws with the Theorem-1 discard, probed at
   every window of the corpus: every window of that segment hits, the rest
   hit below 2 x fill^4; (f) the three wrappers' launch counts rise on the
   path;
9. times every path end to end with the card's idle share, every kernel per
   launch at its main path's shape beside its plain version (the Fig. 1
   pair also at n = 25), and reckons each kernel's bound; the HLL call's
   split (the call with its spread over 200 calls, the zero fill alone,
   ``tools/hll_split.cu``'s kernel without its flush, and its stream
   floor); the plan kernel's stats launches with the carry
   copied in and donated (the ``kernels`` line holds the donated times of
   HLL and CountMin, named so), and ``countmin_red_floor``, CountMin's
   increments issued alone; for the serve path also tokens/s and the split
   of a decode step between ``lm.decode_step`` and ``SessionPool.step``.

10. the durable phase (after item 5, before item 9's times), its launch
   counts read on their own: (a) ``stream.run_stream`` with the
   executors ``host``, ``grid`` and ``scan`` on the stats plan and on the
   decontam plan over the deduplicated corpus's rows (1024 x 8192, and
   cut to a ragged tail of 300 symbols with an eighth of the rows idle and
   the rest of random length), each bit-equal to one-shot ``api.run`` with
   the kernel and with the plain version, with one dispatch for ``grid``
   and for ``scan`` (one CUDA-graph replay); (b) one (8, 1024, 512) stats
   block through the graph replay and through the eager loop, in turns:
   device ms, host ms and idle share of each; (c) 60 ``DataPlane`` steps
   with a snapshot every 25 into a temporary directory, the one at 50
   interrupted by a ``FailureInjector``, then a fresh plane of another
   stats seed restores and runs to step 100: its registers, table and
   telemetry must equal item 5's uninterrupted run (snapshot bytes, save
   and restore ms); (d) ``run_dedup_job`` on a ``DedupService`` of 4
   workers at replication 2 over ``SERVICE_DOCS`` of the dedup corpus in
   batches of 1,000, a snapshot every 10, under a seeded chaos storm with
   job kills: flags equal ``add_batch``'s; an elastic restore onto 3
   workers at replication 1 gives them again; worker 1 killed while 2,000
   fresh documents are probed keeps recall loss at 0.0, its revival
   drains the repair queue (docs/s beside ``add_batch``'s); (e) THREEWISE
   signing and stats on the card equal the CPU's;
11. the sharded phase (after item 7's serve path, its launch counts read
   on their own): the multi-device layer (``kernels/shard.py``) on
   ``data_mesh(1)`` and on ``DataMesh((cuda:0,) * 4)``, four virtual
   shards of the one card, each output held bit for bit against the same
   call without a mesh: (a) ``run_sharded`` of the stats plans (both
   families, warm HLL and CountMin carries), the dedup plans (k = 64, both
   families) and the decontam plan at 1021 x 8192 (no d > 1 divides 1021,
   an eighth of the rows idle); (b) item 10's executor checks on each
   mesh; (c) ``NgramStats`` on 1 and 4 shards over (8, 1024, 512) blocks
   through each shard's graph replay (dispatches, replays and launches
   printed); (d) a stats stream exported at 4 shards imported at 1 and at
   2, and one at 1 imported at 4; (e) item 10's ``DataPlane`` snapshots at
   ``data_shards=1``; (f) ``MinHashDeduper`` on 4 shards over
   ``SERVICE_DOCS`` documents (signatures and flags) and
   ``DedupService(mesh=...)`` over them under item 10's chaos storm; (g)
   ``ServeEngine`` greedy and sampled with its pool on 1 and on 4 shards:
   tokens and telemetry equal item 7's runs. ``sharded[...]`` lines time
   one ``run_sharded`` call at d = 1 and 4 against ``api.run`` and one
   stats block at d = 4 against d = 1 and one device (card and host ms,
   idle share), beside the card's name and power limit. Every shard runs
   on cuda:0 here; the distinct-device path needs a machine with more
   cards (``tests/test_torch_on_card.py`` holds it there).

12. the analysis phase (last, its launch counts read on their own): the
   contract census of ``repro_torch.analysis`` with the kernels
   (``verify_contracts(device="cuda")`` over both families, on no mesh,
   ``data_mesh(1)`` and ``DataMesh((cuda:0,) * 4)``) reports no violation;
   its negative controls (a body that runs the plan twice under
   ``api.run``'s contract; a session step whose carry comes back copied)
   are flagged; every deprecated shim (``ops.cyclic_minhash``,
   ``cyclic_hll``, ``cyclic_bloom`` and the ``sketch_fused`` wrappers
   ``cyclic_*_fused``) through the plan kernel equals its plain version on
   the card, both discard settings, B in {8, 1024} x S in {7, 520, 8192}
   with random ``n_windows``, one plan launch a call; the lint and the
   discard checker find nothing. An ``analysis:`` line gives the counts
   and seconds.

13. the train phase (after item 11, before item 8; its launch counts read
   on their own): ``train.loop.train`` on qwen1.5-0.5b recommended (24
   layers, d 1024, vocab 151,936, 463,987,712 parameters, causal skip,
   ``ce_chunk_vocab`` 4752, remat ``dots``, AdamW) with random weights
   from seed 0, over the port's ``DataPlane`` at (8, 1024) with dedup on
   the plan kernel (``impl="kernel"``): 12 steps, a checkpoint after
   step 8 into a temporary directory, a failure injected at step 10, so
   ``run_with_recovery`` restores and replays steps 8 and 9. Gates: (a)
   every loss finite and the mean of the last three below the first; (b)
   one restart, the steps run in the order expected, each replayed step's
   loss within rtol 1e-4 of its first pass; (c) the plan kernel launched
   at least once a step; (d) the data plane's HLL registers, CountMin
   table and token count bit-equal to a plain ``NgramStats(impl="ref")``
   twin on the card fed the same steps in the same order, replays
   included; (e) the trained weights drive ``ServeEngine.generate`` on
   the decode kernel, every token in vocab; (f) one ``make_train_step``
   step at ``paper-tiny`` ``.smoke()`` on the card equals the same step
   on the CPU from one carried state (loss and grad norm rtol 1e-4, every
   parameter 2e-6). ``train[...]`` lines print the loop's log, the step's
   ms (the first apart, then four timed steps), tokens/s, the peak device
   memory, a checkpoint's bytes and its save and restore seconds, the
   card's idle share over two profiled steps and the model FLOPs a step
   (6 N tokens plus attention) as a share of the dense bf16 peak.

14. the MoE and Mamba-2 phase (after item 13, before item 8; its launch
   counts read on their own): mamba2-2.7b at its published widths and
   depth (64 layers, d_model 2560, SSD state 128, vocab 50,280) and
   dbrx-132b at its published widths with 2 of its 40 layers (d_model
   6144, 16 experts of width 10,752, top 4, vocab 100,352), random weights
   from seed 0. Gates: (a) mamba2 ``ServeEngine.generate`` at item 7's
   settings (16 prompts of 128 tokens, 64 new, greedy twice and sampled,
   no-repeat 4-grams, the 2^20-bit canary with 4 rows planted): 64 decode
   launches, no banned 4-gram emitted, the second greedy run's tokens
   equal the first's, every planted row hits the canary; on the primed
   pool the decode kernel at (16, 50432) bit-equal to its plain version;
   (b) mamba2 with float32 activations and caches: prefill of 16 tokens
   then 8 decode steps give the forward's logits within rtol/atol 2e-2
   and the same argmax; (c) dbrx, 2 layers: (a)'s serve (the decode
   kernel at (16, 100352)), prefill's ``dropped_frac`` at the published
   capacity factor printed, then (b)'s check at capacity factor 16; (d)
   mamba2 recommended (remat ``full``, 8 microbatches, AdamW) ``train()``
   over the ``DataPlane`` at (8, 1024) on the plan kernel, 2 steps, no
   checkpoint, then 2 profiled steps on its state (4 steps in all): every
   loss and grad norm finite, one stats launch (HLL + CountMin) a loop
   step, every state tensor keeping its storage over the profiled steps;
   (e) dbrx 2 layers recommended (grouped dispatch, remat ``full``, 16
   microbatches, Adafactor) at (16, 1024), 3 steps and 2 profiled, as (d),
   each step's ``load_balance`` and ``dropped_frac`` in its loop line;
   (f) one step at the ``.smoke()`` of dbrx-132b, kimi-k2-1t-a32b,
   mamba2-2.7b and jamba-1.5-large-398b on the card against the CPU from
   one carried state (loss and grad norm rtol 1e-4, the drop share
   equal, each leaf's update within 1e-3 of its norm). ``moe_mamba[...]``
   lines print tokens/s, the decode step's split, the kernel's time
   beside its plain version and bound, training ms a step and tokens/s,
   peak memory, idle shares (from the raw trace, ``raw_idle``) and the
   model FLOP share (6 N_active, attention's products added).

15. the model mesh phase (after item 14; launch counts read on their
   own): every position a virtual shard of the one card
   (``launch.mesh.make_debug_mesh``), parameters laid out by their specs
   (``nn.sharding.spec_for``), one local program a position. Gates: (a)
   qwen1.5-0.5b at full width and depth, float32 parameters and
   activations (full logits, no chunked loss): one ``make_train_step``
   step on (2, 2) from a carried state (two one-device steps in) against
   the one-device step: loss and grad norm rtol 1e-4, every parameter
   within rtol 2e-3 / atol 2e-4 (the reference test's), every shard
   keeping its storage; (b) qwen recommended (bf16, chunked loss over
   the vocab shards) through ``train()`` on (2, 2) over the ``DataPlane``
   at (8, 1024) on the plan kernel, 4 steps: finite losses, a plan
   launch a step at least, the stats bit-equal to a plain twin, two more
   steps keeping every shard's storage (profiled), and a checkpoint saved
   on (2, 2) restored on (4, 1) and on one device to the same tree; (c)
   qwen float32 on (2, 2) and (1, 3) (16 kv heads do not divide 3: the
   cache shards the sequence, d_ff 2816 stays whole, the vocab splits 3
   ways): prefill of 16 tokens then 8 decode steps within 2e-2 of the
   one-device forward with the same argmax; then ``ServeEngine.generate``
   on (2, 2) (16 prompts of 128, 64 new, greedy): 64 decode launches, no
   banned 4-gram emitted; (d) dbrx-132b at its published widths, 2 of its
   40 layers, bf16 parameters, on (2, 2): the loss forward at capacity
   factor 1.25 at (4, 1024), global dispatch, with float32 activations
   (the dropped count equal to one device's, the loss within 1e-3) and
   with bf16 ones (the loss within 1e-3; the dropped counts printed: a
   bf16 partial sum rounds otherwise than one device's product, and a
   router near-tie may flip); (e) mamba2-2.7b at its published
   widths, 4 of its 64 layers, float32, on (2, 2): one step from a carried
   state against one device (loss and grad norm rtol 1e-4, each leaf's
   update within 1e-3 of its norm). ``mesh[...]`` lines print ms a step
   on the mesh and on one device, tokens/s, idle shares, the collectives
   by kind (calls, bytes), the parameter bytes a position holds and peak
   memory.
16. the dry run phase (after item 15): the op census of
   ``launch.op_census`` (matrix-product FLOPs, the computed bytes of every
   non-view op, the collectives' operand bytes, the peak of the storages a
   step makes) that ``launch.dryrun`` runs on ``meta`` positions, held
   against the same step on the card. Gates: (a) qwen1.5-0.5b recommended,
   one device, a (8, 1024) train step: the census on ``meta`` equal to the
   census on ``cuda:0`` (FLOPs, bytes by op, collectives, ops; the state
   updated in place on both), its dot FLOPs within 1 % of
   ``torch.profiler``'s ``with_flops`` count of the matrix products of a
   step; the median of 3 warm steps printed beside the roofline bound
   max(compute_s, memory_s) at ``configs.base.H100``'s data-sheet peaks,
   the achieved fraction and the model-FLOP share of 989 TFLOP/s; (b) the
   argument bytes from the specs against ``torch.cuda.memory_allocated()``
   of the built state and batch, within the allocator's rounding; the
   census's temporaries (an estimate) printed beside
   ``max_memory_allocated()``; (c) ``H100``'s constants printed beside the
   card's properties and ``nvidia-smi``'s name and power limit; (d) qwen
   float32 at (8, 512) on (2, 2) virtual shards: the census on the card
   equal to ``meta``'s, its collective operand bytes a device printed
   beside phase 15's counter of the same step. ``dryrun[...]`` lines.

Matmuls run in full float32 where they take float32 (TF32 off for cuBLAS
and cuDNN). It prints one JSON line describing each kernel and, last, the
device line.
Any failure raises and exits non-zero; without a CUDA card it exits 2.
"""
import ctypes
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
# measurement only, built beside the kernels: the CountMin increments alone,
# and the decode plane's streams with no filter probe
RED_FLOOR_SRC = ROOT / "tools" / "countmin_red_floor.cu"
STREAM_FLOOR_SRC = ROOT / "tools" / "decode_stream_floor.cu"
# and the HLL update's stream and raises without its flush
HLL_SPLIT_SRC = ROOT / "tools" / "hll_split.cu"
GRID_DIM = 65535            # blocks a grid's y or z dimension holds

# H100 SXM: 132 SMs at the 1.98 GHz boost clock (NVIDIA's Hopper white
# paper; the same figures give the data sheet's 67 TFLOP/s float32 as
# 132 x 128 x 2 x 1.98e9), and 3.35 TB/s of HBM3. Each SM issues integer
# instructions to two pipes of 64 lanes a clock: the INT32 (ALU) pipe, which
# runs logic, shifts and min/max, and the FMA pipe, which also runs IMAD.
# Loads and atomics issue to the SM's 32 load/store units (4 partitions x 8
# in the white paper's SM diagram): 32 lanes a clock.
LANES_PER_S = 132 * 64 * 1.98e9     # one pipe, one instruction a lane-clock
LSU_LANES_PER_S = 132 * 32 * 1.98e9
# the data sheet's HBM rate and dense bf16 peak: read from the port's
# roofline model (configs.base.H100) in main, once src/ is on the path, so
# the kernel bounds and the dry run's roofline cannot drift apart
HBM_BYTES_PER_S = DENSE_BF16_FLOPS = None

K, N, L, BANDS = 64, 8, 32, 16
STREAM_ROWS = 1024          # rows per launch on the dedup and stats paths
CHUNK_S = 512               # the deduper's default stream_chunk_s
BLOCK_T = 8                 # chunks per stats block
DECON_ROWS, SEQ = 512, 1024  # decontam batch
EVAL_DOCS, PLANTED = 500, 8  # eval set; planted rows per decontam batch
PREFIX_COLS = 2048          # HLL accuracy prefix: 1024 rows x 2048 tokens
WIDE_NL = ((9, 8), (20, 16), (33, 32))   # window ops at n > L
ROUTE_NS = (1, 8, 25, 26, 32, 33, 40)   # GENERAL's routes at L = 32
# a dense modulus of degree 32, which the fold takes at no n: the
# irreducible one of weight 9 with the smallest low part
DENSE_P32 = 0x10000033F


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def profiled(torch, fn, iters: int = 1):
    """Run ``fn`` ``iters`` times under torch.profiler after a warm-up.
    Returns (host seconds to issue the calls, wall seconds until the card
    finished, [(device us, name, count)] of every kernel, copy and fill
    the calls put on the card, largest first). A trace that comes back
    with no device event at all (CUPTI dropped it: one of some forty
    traces in a run did so on the card) is taken again, twice at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            issue = time.perf_counter() - t0
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device-side events only: a CPU op's event repeats its kernels' time
        rows = sorted(((e.self_device_time_total, e.key, e.count)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total > 0), reverse=True)
        if rows:
            return issue, wall, rows
        print(f"profile: trace {attempt + 1} saw no device time; taking it "
              f"again")
    raise RuntimeError("torch.profiler saw no device time in 3 traces")


def device_ms(torch, fn, iters: int):
    """(device ms, host ms) per call of ``fn``. The host needs longer to
    issue a launch than the card needs to run it, so CUDA events around a
    loop would time the host; the card's own time is the sum of the device
    events the calls produced."""
    issue, _, rows = profiled(torch, fn, iters)
    return sum(r[0] for r in rows) / 1e3 / iters, issue * 1e3 / iters


def in_turns(torch, kern, plain, k_iters=200, p_iters=10):
    """plain, kernel, kernel, plain: compare within one call, in turns.
    Returns (kernel ms, plain ms, kernel host ms, the four readings). A
    trace can lose device events (CUPTI drops some: a donated launch once
    read half its time), which only reads low, so when a side's two turns
    differ by more than 5 % a third turn is taken and the median of the
    three kept; otherwise the lower of the two."""
    (p1, _), (k1, kh), (k2, _), (p2, _) = (
        device_ms(torch, plain, p_iters), device_ms(torch, kern, k_iters),
        device_ms(torch, kern, k_iters), device_ms(torch, plain, p_iters))

    def settle(a, b, fn, iters):
        if abs(a - b) <= 0.05 * max(a, b):
            return min(a, b)
        return sorted((a, b, device_ms(torch, fn, iters)[0]))[1]

    return (settle(k1, k2, kern, k_iters), settle(p1, p2, plain, p_iters),
            kh, (k1, k2, p1, p2))


def palindrome(torch, fns, iters=200):
    """Device ms a call of each of ``fns``, timed in the order A B C C B A
    with :func:`in_turns`'s rule for the two readings of each."""
    first = [device_ms(torch, fn, iters)[0] for fn in fns]
    second = [device_ms(torch, fn, iters)[0] for fn in reversed(fns)][::-1]
    out = []
    for fn, a, b in zip(fns, first, second):
        out.append(min(a, b) if abs(a - b) <= 0.05 * max(a, b) else
                   sorted((a, b, device_ms(torch, fn, iters)[0]))[1])
    return out


def hash_ops(hs) -> tuple:
    """Fewest instructions for one window hash in its rolling form, one
    step per window, as (ALU-pipe, shared-load) counts. CYCLIC h' = rotl(h,
    1) ^ rotl(out, n) ^ in is two rotations (one funnel shift each at L =
    32; two shifts below it, with the OR and the mask folded into the XORs)
    and the XORs (one three-input LOP3 at L = 32, two below). GENERAL h' =
    x*h ^ c*out ^ in with c = x^n mod p is one shift-reduce step for x*h
    (shift, sign spread, LOP3 at L = 32; two more below) and the product
    by the cheapest form the port knows for (n, p, L), ``general.route``'s:
    the fold (t = out >> (L - n), out << n and a shift for each set bit of
    p_low but bit 0) or the tables (out << n for n < L, then a shift, an AND
    and a shared load for each byte chunk); then the LOP3s that join the
    terms, three at a time, with the mask of out << n below L = 32."""
    from repro_torch.kernels import general
    full = hs.L == 32
    if hs.family == "cyclic":
        rots = sum(1 for r in (1 % hs.L, hs.n % hs.L) if r)
        return rots * (1 if full else 2) + (1 if full else 2), 0
    r = general.route(hs.n, hs.p, hs.L)
    low = 1 if hs.n < hs.L else 0          # out << n
    if r.route == general.FOLD:
        alu = 1 + low + sum(1 for j in r.shifts if j)
        terms, lds = r.ways, 0
    else:
        alu, terms, lds = low + 2 * r.ways, r.ways, r.ways
    # join x*h, out << n, the terms and x_in
    joins = -(-(1 + low + terms) // 2)
    return (3 if full else 5) + alu + joins + (0 if full else low), lds


def window_ops(plan, probes: float = 0.0) -> tuple:
    """Fewest instructions the plan's function needs per valid window, as
    (ALU-pipe, FMA-pipe, load/store) counts: the hash (and the second
    stream's for a Bloom plan) and one AND for the discard mask, then per
    sketch
      MinHash   per lane one IMAD (a*h + b, FMA) and one IMNMX (ALU);
      HLL       AND for the index, shift, BREV + FLO for ctz, min with
                rank_bits, +1 (ALU), one register update (load/store);
      CountMin  per row one IMAD (FMA), one shift for the column (ALU)
                and one atomic add (load/store);
      Bloom     OR for the odd stride (ALU), then per probe one IMAD
                (h + i*stride, FMA), the mask AND, the word shift and the
                bit test (three ALU) and one filter load; ``probes`` is the
                mean number of probes per window this run's data needs (a
                window stops at its first miss)."""
    from repro_torch.kernels.plan import (BloomSpec, CountMinSpec, HLLSpec,
                                          MinHashSpec)
    hs = plan.hash
    streams = 2 if plan.needs_second_stream else 1
    alu, lds = hash_ops(hs)
    alu, fma, lsu = streams * (alu + 1), 0, float(streams * lds)
    for _, spec in plan.sketches:
        if isinstance(spec, MinHashSpec):
            alu, fma = alu + spec.k, fma + spec.k
        elif isinstance(spec, HLLSpec):
            alu, lsu = alu + 6, lsu + 1
        elif isinstance(spec, CountMinSpec):
            alu, fma, lsu = alu + spec.depth, fma + spec.depth, lsu + spec.depth
        elif isinstance(spec, BloomSpec):
            alu, fma, lsu = alu + 1 + 3 * probes, fma + probes, lsu + probes
    return alu, fma, lsu


def roofline(items: int, nbytes: int, alu: float, fma: float, lsu: float,
             what: str = "windows"):
    """(bound ms, "bytes" | "operations", text) for ``items`` elements of
    ``alu`` ALU-pipe, ``fma`` FMA-pipe and ``lsu`` load/store instructions
    each, moving ``nbytes``: the larger of the bytes at HBM's rate and the
    instructions at their issue rates (the ALU pipe's own at one pipe's
    rate, all integer instructions over both pipes, or the loads and
    atomics at the load/store units' rate, whichever is longest)."""
    t = {"ALU issue": items * alu / LANES_PER_S,
         "ALU+FMA issue": items * (alu + fma) / 2 / LANES_PER_S,
         "loads/atomics": items * lsu / LSU_LANES_PER_S}
    which = max(t, key=t.get)
    t_ops, t_bytes = t[which] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    text = (f"{items} {what} x ({alu:g} ALU + {fma:g} FMA + {lsu:g} "
            f"load/store) instructions: {t_ops:.5f} ms by {which}; "
            f"{nbytes} bytes: {t_bytes:.5f} ms")
    return max(t_ops, t_bytes), by, text


def bound(plan, windows: int, nbytes: int, probes: float = 0.0):
    """The plan kernel's roofline over ``windows`` valid windows."""
    return roofline(windows, nbytes, *window_ops(plan, probes))


def launch_times(torch, fn, iters: int = 200) -> list:
    """Run ``fn`` ``iters`` times under torch.profiler after a warm-up and
    return every device event, in the order the card ran them, as (name,
    us); a trace with no device event is taken again, twice at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = sorted((e.time_range.start, e.name,
                         e.time_range.elapsed_us()) for e in prof.events()
                        if e.device_type == DeviceType.CUDA)
        if events:
            return [(name, us) for _, name, us in events]
    raise RuntimeError("torch.profiler saw no device time in 3 traces")


def spread(values) -> str:
    """min / median / max of ``values`` (us) as ms."""
    v = sorted(values)
    return (f"{v[0] / 1e3:.5f} / {v[len(v) // 2] / 1e3:.5f} / "
            f"{v[-1] / 1e3:.5f}")


def hll_split(torch, hll, h, b, rank_bits, b_ms, card, iters=200) -> None:
    """The HLL call at the byte path's shape, split: the whole call (every
    device event) and its launches' spread; the wrapper's zero fill alone;
    ``tools/hll_split.cu``'s variants on the kernel's grid: the kernel
    without its flush, and the stream floor (loads and ranks only)."""
    from repro_torch.kernels import _build
    fn = _build.load(str(HLL_SPLIT_SRC)).hll_split
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes, fn.restype = [vp, ctypes.c_longlong, i, i, vp, i, vp], i
    h = h.reshape(-1).contiguous()
    regs = torch.zeros((1 << b,), dtype=torch.int32, device=h.device)

    def variant(mode):
        def run():
            err = fn(h.data_ptr(), h.numel(), b, rank_bits, regs.data_ptr(),
                     mode, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"hll_split mode {mode}: CUDA error {err}")
        return run

    call = lambda: hll.hll_update(h, b=b, rank_bits=rank_bits)
    fill = lambda: torch.zeros((1 << b,), dtype=torch.int32, device=h.device)
    call_ms, fill_ms, noflush, floor = palindrome(
        torch, [call, fill, variant(1), variant(0)], iters)
    events = launch_times(torch, call, iters)
    kern = [us for name, us in events if "hll" in name]
    # a call is its fill and the kernel after it (a trace can lose events)
    per_call = [us + events[j - 1][1] for j, (name, us) in enumerate(events)
                if "hll" in name and j and "hll" not in events[j - 1][0]]
    print(f"kernel[hll split] N={h.numel()} b={b} rank_bits={rank_bits}, "
          f"the call {call_ms:.5f} ms "
          f"(min / median / max over {len(per_call)} whole calls of "
          f"{iters}: {spread(per_call)}; {len(events)} device events), the "
          f"kernel's own event {spread(kern)}; the zero fill alone "
          f"{fill_ms:.5f}; without the flush {noflush:.5f}; the stream floor "
          f"(loads and ranks) {floor:.5f}; bound {b_ms:.5f} [{card}]")


def device_busy(torch, fn, card: str, what: str) -> float:
    """Profile one call of ``fn``: wall time, the card's busy time, the
    number of device events and the top ones by time. Returns the idle
    share."""
    _, wall, rows = profiled(torch, fn)
    busy = sum(r[0] for r in rows) / 1e6
    events = sum(r[2] for r in rows)
    top = "; ".join(f"{k[:48]} x{c} {t / 1e3:.3f} ms" for t, k, c in rows[:6])
    print(f"profile[{what}]: wall {wall:.3f} s under the profiler, device "
          f"busy {busy:.4f} s = {busy / wall:.4f} of it, idle "
          f"{1 - busy / wall:.4f}; {events} device events; by device time: "
          f"{top} [{card}]")
    return 1 - busy / wall


def rand_u32(torch, gen, shape, dev):
    return torch.randint(0, 1 << 32, shape, generator=gen,
                         dtype=torch.int64).to(torch.uint32).to(dev)


def plan_operands(torch, plan, gen, B, dev, init=True) -> dict:
    """Random operands for every sketch of ``plan`` on ``dev``; with
    ``init``, a random carry of each sketch's state too. The Bloom filter
    is dense (three quarters of its bits set), so probes both hit and
    miss."""
    from repro_torch.kernels.plan import (BloomSpec, CountMinSpec, HLLSpec,
                                          MinHashSpec)
    ops = {}
    for name, spec in plan.sketches:
        if isinstance(spec, MinHashSpec):
            o = {"a": rand_u32(torch, gen, (spec.k,), dev),
                 "b": rand_u32(torch, gen, (spec.k,), dev)}
            carry = rand_u32(torch, gen, (B, spec.k), dev)
        elif isinstance(spec, HLLSpec):
            o = {}
            carry = torch.randint(0, 6, (1 << spec.b,), generator=gen,
                                  dtype=torch.int32).to(dev)
        elif isinstance(spec, CountMinSpec):
            o = {"a": rand_u32(torch, gen, (spec.depth,), dev),
                 "b": rand_u32(torch, gen, (spec.depth,), dev)}
            carry = torch.randint(0, 100, (spec.depth, spec.width),
                                  generator=gen, dtype=torch.int32).to(dev)
        else:
            w = (spec.n_words,)
            o = {"bits": (rand_u32(torch, gen, w, dev).view(torch.int32)
                          | rand_u32(torch, gen, w, dev).view(torch.int32)
                          ).view(torch.uint32)}
            carry = torch.randint(0, 1000, (B,), generator=gen,
                                  dtype=torch.int32).to(dev)
        if init:
            o["init"] = carry
        ops[name] = o
    return ops


def check_plan(torch, api, plan, gen, B, S, full=False) -> int:
    """One kernel-vs-plain comparison of a plan on the card, with random
    n_windows (every window with ``full``), w_start and init; returns max
    |diff| over its outputs."""
    dev = torch.device("cuda")
    W = max(0, S - plan.hash.n + 1)
    x = rand_u32(torch, gen, (B, S), dev)
    xb = rand_u32(torch, gen, (B, S), dev) if plan.needs_second_stream else None
    nw = (torch.full((B,), W, dtype=torch.int32) if full else
          torch.randint(0, W + 2, (B,), generator=gen, dtype=torch.int32))
    ws = torch.randint(0, plan.hash.n + 1, (B,), generator=gen,
                       dtype=torch.int32)
    args = dict(h1v_b=xb, n_windows=nw.to(dev), w_start=ws.to(dev),
                operands=plan_operands(torch, plan, gen, B, dev))
    got = api.run(plan, x, impl="kernel", **args)
    want = api.run(plan, x, impl="ref", **args)
    torch.cuda.synchronize()
    err = 0
    for name in got:
        diff = (got[name].to(torch.int64) - want[name].to(torch.int64)).abs()
        err = max(err, int(diff.max()) if diff.numel() else 0)
        if not torch.equal(got[name], want[name]):
            raise AssertionError(
                f"kernel != plain version: {plan.hash.family} {plan.names} "
                f"sketch {name!r} B={B} S={S}, max |diff| {err}")
    return err


def check_rolling(torch, ops, family, n, Lw, B, S, gen, p=None) -> int:
    """ops.cyclic / ops.general kernel against plain on the card (GENERAL
    mod ``p``, by default find_irreducible_host's), on symbols drawn from
    ``gen`` (on the host, or on the card if it is the card's)."""
    from repro_torch.core import gf2
    dev = torch.device("cuda")
    x = (rand_u32(torch, gen, (B, S), dev) if gen.device.type == "cpu" else
         torch.randint(0, 1 << 32, (B, S), generator=gen, device=dev,
                       dtype=torch.int64).to(torch.uint32))
    if family == "cyclic":
        got = ops.cyclic(x, n=n, L=Lw, impl="kernel")
        want = ops.cyclic(x, n=n, L=Lw, impl="ref")
    else:
        p = p or gf2.find_irreducible_host(Lw)
        got = ops.general(x, n=n, p=p, L=Lw, impl="kernel")
        want = ops.general(x, n=n, p=p, L=Lw, impl="ref")
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"{family}_rolling != plain version: n={n} "
                             f"L={Lw} B={B} S={S} p={p and hex(p)}, max "
                             f"|diff| {err}")
    return err


def dedup_run(torch, corpus_docs, truth, family, sketch_fused, dedup, card):
    """The dedup path: add_batch over the corpus with the launch count read
    around it; returns (deduper, flags, launches, seconds, tokens)."""
    cfg = dedup.DedupConfig(vocab=8192, threshold=0.5, ngram_n=N, L=L,
                            n_signatures=K, lsh_bands=BANDS, family=family,
                            stream_rows=STREAM_ROWS, stream_chunk_s=CHUNK_S,
                            device="cuda")
    dd = dedup.MinHashDeduper(cfg)
    tokens = sum(len(d) for d in corpus_docs)
    torch.cuda.synchronize()
    sketch_fused.LAUNCHES = 0
    t0 = time.perf_counter()
    flags = dd.add_batch(corpus_docs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = sketch_fused.LAUNCHES
    tp = int((flags & truth).sum())
    recall = tp / max(int(truth.sum()), 1)
    precision = tp / max(int(flags.sum()), 1)
    print(f"main[{family}]: {len(corpus_docs)} docs, {tokens} tokens, "
          f"stream_rows={STREAM_ROWS}, stream_chunk_s={CHUNK_S}: add_batch "
          f"{dt:.3f} s = {tokens / dt:.0f} tokens/s, {launches} kernel "
          f"launches, recall {recall:.4f}, precision {precision:.4f} "
          f"[{card}]")
    if launches < 1:
        raise AssertionError(f"{family}: add_batch launched no kernel")
    if not (recall > 0.9 and precision > 0.9):
        raise AssertionError(f"{family}: recall {recall} / precision "
                             f"{precision} not above 0.9")
    return dd, flags, launches, dt, tokens


def stats_blocks(rows: np.ndarray, C=CHUNK_S, T=BLOCK_T):
    """(B, R) token rows, one stream each -> (T, B, C) int32 chunk blocks
    with (T, B) lengths; the last block is padded with zero-length
    chunks."""
    B, R = rows.shape
    n_chunks = -(-R // C)
    n_chunks += -n_chunks % T
    padded = np.zeros((B, n_chunks * C), np.int32)
    padded[:, :R] = rows
    chunks = padded.reshape(B, n_chunks, C).transpose(1, 0, 2)
    lens = np.clip(R - np.arange(n_chunks) * C, 0, C).astype(np.int32)
    for t in range(0, n_chunks, T):
        yield (np.ascontiguousarray(chunks[t : t + T]),
               np.repeat(lens[t : t + T, None], B, axis=1))


def stats_run(ng, rows):
    """update_stream_many over every block of ``rows``; returns the
    finalized state."""
    ss = ng.init_stream(rows.shape[0])
    for toks, lens in stats_blocks(rows):
        ss = ng.update_stream_many(ss, toks, lengths=lens)
    return ng.finalize_stream(ss)


def distinct_windows(rows: np.ndarray, n: int) -> int:
    """Exact number of distinct n-grams inside the rows (none spans two
    rows), counted on the host."""
    w = np.lib.stride_tricks.sliding_window_view(rows.astype(np.int16), n,
                                                 axis=1)
    w = np.ascontiguousarray(w.reshape(-1, n))
    return len(np.unique(w.view(np.dtype((np.void, 2 * n)))[:, 0]))


def pair_probes(torch, u32, ha, hb, bits, k, log2_m) -> float:
    """Mean probes a (ha, hb) pair needs against the filter ``bits``: probe
    i is ``(ha + i * (hb | 1)) & (2^log2_m - 1)`` and a probe loop stops at
    its first unset bit."""
    stride = u32.lanes(hb) | 1
    i = torch.arange(k, device=stride.device)
    p = ((u32.lanes(ha)[..., None] + i * stride[..., None]) & u32.MASK32) & (
        (1 << log2_m) - 1)
    hit = ((u32.lanes(bits)[p >> 5] >> (p & 31)) & 1).to(torch.int64)
    lead = torch.cumprod(hit, dim=-1)[..., :-1].sum(dim=-1)
    return float((1 + lead).to(torch.float64).mean())


def probes_needed(torch, ref, plan, x, xb, bits) -> float:
    """Mean probes per window the Bloom epilogue needs on these inputs."""
    hs, spec = plan.hash, plan.sketches[0][1]
    ha, hb = (ref.window_hashes_ref(v, family=hs.family, n=hs.n, L=hs.L,
                                    p=hs.p) & hs.hash_mask for v in (x, xb))
    return pair_probes(torch, ref.u32, ha, hb, bits, spec.k, spec.log2_m)


def check_past_limits(torch, gen, err) -> float:
    """The kernels past the limits they once had, each size taken from its
    launcher's own rule and printed with the count it reached: a plan of
    ten sketches (one launch a group of eight), one row of more rolling
    segments than a grid dimension holds, and the decode kernel over more
    rows than that. Raises ``err``'s maxima in place; returns the decode
    check's max |logit difference|."""
    from repro_torch.core import gf2
    from repro_torch.kernels import _build, api, ops, sketch_fused
    from repro_torch.kernels.plan import (BloomSpec, CountMinSpec, DecodeSpec,
                                          HashSpec, HLLSpec, MinHashSpec,
                                          SketchPlan)
    dev = torch.device("cuda")
    for family in ("cyclic", "general"):
        ten = SketchPlan(HashSpec(family=family, n=N, L=L), (
            ("sig_a", MinHashSpec(k=K)), ("hll_a", HLLSpec(b=12)),
            ("cms_a", CountMinSpec(depth=4, log2_width=16)),
            ("bl_a", BloomSpec(k=4, log2_m=22)), ("sig_b", MinHashSpec(k=16)),
            ("hll_b", HLLSpec(b=15)),
            ("cms_b", CountMinSpec(depth=2, log2_width=12)),
            ("bl_b", BloomSpec(k=2, log2_m=20)), ("sig_c", MinHashSpec(k=8)),
            ("hll_c", HLLSpec(b=4))))
        groups = len(sketch_fused.sketch_groups(ten.sketches))
        before = sketch_fused.LAUNCHES
        for B, S in ((64, 1024), (1024, 520)):
            e = check_plan(torch, api, ten, gen, B, S)
            for _, spec in ten.sketches:
                err[type(spec).__name__] = max(err[type(spec).__name__], e)
        launched = sketch_fused.LAUNCHES - before
        if groups < 2 or launched != 2 * groups:
            raise AssertionError(f"ten-sketch plan: {launched} launches for "
                                 f"2 calls of {groups} groups")
        print(f"check: {family} plan of {len(ten.sketches)} sketches (2 or 3 "
              f"of each kind) in {groups} launches a call ({launched} for 2 "
              f"calls): kernel == plain version on the card at (64, 1024) "
              f"and (1024, 520)")

    # one row of GRID_DIM + 1 segments of the launcher's own size
    seg = _build.load("rolling").rolling_block_windows()
    segs = GRID_DIM + 1
    S = segs * seg + N - 1
    first = (GRID_DIM - 5) * seg
    cgen = torch.Generator(device=dev).manual_seed(17)
    x = torch.randint(0, 1 << 32, (1, S), generator=cgen, device=dev,
                      dtype=torch.int64).to(torch.uint32)
    toks = (x.view(torch.int32) & 255).contiguous()
    table = torch.randint(0, 1 << 32, (256,), generator=cgen, device=dev,
                          dtype=torch.int64).to(torch.uint32)
    p32 = gf2.find_irreducible_host(L)
    calls = {"cyclic": lambda v, impl: ops.cyclic(v, n=N, L=L, impl=impl),
             "general": lambda v, impl: ops.general(v, n=N, p=p32, L=L,
                                                    impl=impl),
             "cyclic_fused": lambda v, impl: ops.cyclic_fused(
                 v, table, n=N, L=L, impl=impl)}
    for what, call in calls.items():
        src = toks if what == "cyclic_fused" else x
        got = call(src, "kernel")
        # the first segments and those from GRID_DIM - 5 on, each against
        # the plain version of its slice with the n-1 halo
        for lo, hi in ((0, 6 * seg), (first, segs * seg)):
            want = call(src[:, lo : hi + N - 1].contiguous(), "ref")
            d = (got[:, lo:hi].to(torch.int64) - want.to(torch.int64)).abs()
            e = int(d.max())
            fam = "general" if what == "general" else "cyclic"
            err[fam] = max(err[fam], e)
            if not torch.equal(got[:, lo:hi], want):
                raise AssertionError(f"{what}: kernel != plain over windows "
                                     f"[{lo}, {hi}) of a row of {segs} "
                                     f"segments, max |diff| {e}")
        del got
    print(f"check: one row of {S} symbols = {segs} segments of {seg} windows "
          f"(the grid's y holds {GRID_DIM}): ops.cyclic, ops.general and "
          f"ops.cyclic_fused == plain version on the card over the first 6 "
          f"segments and those from segment {GRID_DIM - 5} on "
          f"({segs * seg - first} windows)")
    del x, toks

    # the decode kernel over more rows than a grid dimension holds
    B, V = GRID_DIM + 65, 96
    spec = DecodeSpec(n=4, L=L, log2_m=14, k=2, canary_log2_m=20, canary_k=4)
    word = lambda *shape: torch.randint(0, 1 << 32, shape, generator=cgen,
                                        device=dev, dtype=torch.int64)
    dense = lambda *shape: (word(*shape) | word(*shape)).to(torch.uint32)
    args = (torch.randn((B, V), generator=cgen, device=dev),
            word(B).to(torch.uint32),
            torch.rand((B,), generator=cgen, device=dev) < 0.8,
            dense(B, spec.n_words), word(V).to(torch.uint32))
    cb = dense(spec.canary_words)
    got = api.decode(spec, *args, canary_bits=cb, impl="kernel")
    want = api.decode(spec, *args, canary_bits=cb, impl="ref")
    torch.cuda.synchronize()
    for key in want:
        if not same_bits(torch, got[key], want[key]):
            raise AssertionError(f"decode kernel != plain version: {key} at "
                                 f"{B} rows, V={V}")
    banned_far = int((want["banned"][GRID_DIM:] != 0).sum())
    print(f"check: decode kernel == plain version on the card at {B} rows "
          f"(more than {GRID_DIM}) x V={V}, log2_m=14, canary 2^20 (the rows "
          f"past {GRID_DIM} hold {banned_far} nonzero banned words)")
    return float((got["logits"] - want["logits"]).abs().max())


# -- the decode plane and the serve path --------------------------------------

SERVE_ARCH, SERVE_B, SERVE_P, SERVE_NEW, SERVE_N = "qwen1.5-0.5b", 16, 128, 64, 4
CANARY_GRAMS, PLANTED_ROWS = 1000, 4


def rand_words(torch, gen, shape, dev, dense=True):
    """Random uint32 filter words on the card; ``dense`` ORs two draws (three
    quarters of the bits set), so probes both hit and miss."""
    draw = lambda: torch.randint(0, 1 << 32, shape, generator=gen,
                                 dtype=torch.int64, device=dev)
    w = draw() | draw() if dense else draw()
    return w.to(torch.uint32)


def same_bits(torch, got, want) -> bool:
    """Bit equality (float32 compared as its int32 patterns)."""
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    return got.dtype == want.dtype and torch.equal(got, want)


def check_decode_grid(torch, api, DecodeSpec) -> int:
    """The decode kernel against its plain version over the listed grid;
    returns the max |logit difference| (0 when every bit agrees)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    err, n_checks = 0.0, 0
    for B in (1, 16, 256):
        for V in (152064, 151936, 1000):
            logits = torch.randn((B, V), generator=gen, device=dev)
            prefix = rand_words(torch, gen, (B,), dev, dense=False)
            h1 = rand_words(torch, gen, (V,), dev, dense=False)
            mixed = torch.rand((B,), generator=gen, device=dev) < 0.5
            mixed[0] = True
            for log2_m in (14, 20, 24):
                bloom = rand_words(torch, gen, (B, 1 << (log2_m - 5)), dev)
                for canary in (0, 20, 24):
                    cb = (rand_words(torch, gen, (1 << (canary - 5),), dev)
                          if canary else None)
                    for n in (2, 4, 8, 33):
                        for Lw in (32, 20):
                            spec = DecodeSpec(n=n, L=Lw, log2_m=log2_m, k=2,
                                              canary_log2_m=canary)
                            for ready in (torch.ones_like(mixed), mixed):
                                args = (spec, logits, prefix, ready, bloom,
                                        h1)
                                got = api.decode(*args, canary_bits=cb,
                                                 impl="kernel")
                                want = api.decode(*args, canary_bits=cb,
                                                  impl="ref")
                                torch.cuda.synchronize()
                                for key in want:
                                    if not same_bits(torch, got[key],
                                                     want[key]):
                                        raise AssertionError(
                                            f"decode kernel != plain version:"
                                            f" {key} at B={B} V={V} n={n} "
                                            f"L={Lw} log2_m={log2_m} canary="
                                            f"{canary} ready={'all' if ready.all() else 'mixed'}")
                                err = max(err, float((got["logits"]
                                                      - want["logits"]).abs()
                                                     .max()))
                                n_checks += 1
        print(f"check: decode kernel == plain version on the card at B={B}, "
              f"V in (152064, 151936, 1000), every n, L, log2_m, canary and "
              f"ready case ({n_checks} checks so far)")
    return err


def decode_ops(pb: float, pc: float) -> tuple:
    """Fewest instructions for one candidate of a ready row, as (ALU, FMA,
    load/store): the candidate hash (one LOP3: rotated prefix ^ h1, the
    discard mask), the odd stride (IMAD on the FMA pipe, an OR), the
    logit select; per probe one IMAD (h + i * stride), the mask AND, the
    word shift and the bit test (three ALU) and one filter load, for the
    ``pb`` no-repeat and ``pc`` canary probes this run's data needs per
    candidate (a probe loop stops at its first miss; the canary loop
    recomputes the stride); plus the logit load and store and the h1
    load."""
    alu = 1 + 1 + 1 + 3 * pb + (1 + 3 * pc if pc else 0)
    fma = 1 + pb + (1 + pc if pc else 0)
    lsu = 3 + pb + pc
    return alu, fma, lsu


def probes_until_miss(torch, ref, u32, spec, prefix, ready, bloom, h1,
                      canary_bits):
    """Mean probes per candidate that the no-repeat and the canary loops
    need on these inputs (a loop stops at its first unset bit; rows that
    are not ready probe nothing)."""
    cand = (u32.rotl_const(u32.lanes(prefix), 1, spec.L)[:, None]
            ^ u32.lanes(h1)[None, :]) & spec.hash_mask
    stride = u32.mulmod32(cand, ref.BLOOM_STRIDE) | 1
    rdy = ready.to(torch.bool)[:, None]

    def mean(words, k, log2_m):
        i = torch.arange(k, device=cand.device)
        p = ((cand[..., None] + i * stride[..., None]) & u32.MASK32) & (
            (1 << log2_m) - 1)
        w = u32.lanes(words)
        got = (torch.gather(w, 1, (p >> 5).reshape(w.shape[0], -1))
               .reshape(p.shape) if w.dim() == 2 else w[p >> 5])
        hit = ((got >> (p & 31)) & 1).to(torch.int64)
        lead = torch.cumprod(hit, dim=-1)[..., :-1].sum(dim=-1) + 1
        return float((lead * rdy).to(torch.float64).mean())

    pb = mean(bloom, spec.k, spec.log2_m)
    pc = (mean(canary_bits, spec.canary_k, spec.canary_log2_m)
          if canary_bits is not None else 0.0)
    return pb, pc


def decode_bound(spec, B, V, pb, pc):
    """(bound ms, "bytes" | "operations", text) of one decode launch: the
    logits read and written once, h1, the filters and the canary filter
    read once, the packed masks written once, prefix and ready read once;
    against the instructions :func:`decode_ops` counts at their issue
    rates."""
    W = -(-V // 32)
    nbytes = 4 * (2 * B * V + V + B * spec.n_words + spec.canary_words
                  + B * W * (2 if spec.has_canary else 1) + 2 * B)
    return roofline(B * V, nbytes, *decode_ops(pb, pc),
                    what=f"candidates at {pb:.4f} + {pc:.4f} probes")


def canary_filter(torch, u32, ref, sketches, spec, h1, grams):
    """The shared canary filter of a set of n-grams (G, n): each gram's
    CYCLIC hash from scratch, masked by the discard, its canary_k probes
    set with an exact scatter-OR (independent of the pool's insert)."""
    h = torch.zeros(grams.shape[0], dtype=torch.int64, device=h1.device)
    lanes = u32.lanes(h1)
    for j in range(grams.shape[1]):
        h = u32.rotl_const(h, 1, spec.L) ^ lanes[grams[:, j]]
    h = h & spec.hash_mask
    stride = u32.mulmod32(h, ref.BLOOM_STRIDE) | 1
    i = torch.arange(spec.canary_k, device=h.device)
    p = (((h[:, None] + i * stride[:, None]) & u32.MASK32)
         & ((1 << spec.canary_log2_m) - 1)).reshape(-1)
    bits = torch.zeros(spec.canary_words, dtype=torch.int32,
                       device=h.device).view(torch.uint32)
    bits = sketches._scatter_or(bits, p >> 5, p & 31)
    if not ref.bloom_probe_hits(h, bits, spec.canary_k,
                                spec.canary_log2_m).all():
        raise AssertionError("canary filter misses an inserted gram")
    return bits


class DecodeSpy:
    """Wraps ``api.decode`` while a ``generate`` runs: keeps every step's
    outputs on the host side of the check and, with ``compare``, holds the
    kernel's outputs against the plain version's on the same inputs."""

    def __init__(self, torch, api, compare: bool):
        self.torch, self.api, self.compare = torch, api, compare
        self.real = api.decode
        self.steps = []

    def __call__(self, spec, logits, prefix, ready, bloom, h1, *,
                 canary_bits=None, impl="auto", **kw):
        out = self.real(spec, logits, prefix, ready, bloom, h1,
                        canary_bits=canary_bits, impl=impl, **kw)
        if self.compare:
            want = self.real(spec, logits, prefix, ready, bloom, h1,
                             canary_bits=canary_bits, impl="ref", **kw)
            for key in want:
                if not same_bits(self.torch, out[key], want[key]):
                    raise AssertionError(
                        f"gate (a): decode step {len(self.steps)}: kernel "
                        f"{key} != plain version's")
        self.steps.append({k: v.clone() for k, v in out.items()})
        return out

    def __enter__(self):
        self.api.decode = self
        return self

    def __exit__(self, *exc):
        self.api.decode = self.real


def repeated_completions(prompts, toks, n) -> int:
    """Generated tokens that complete an n-gram already in their row."""
    bad = 0
    for row in np.concatenate([prompts, toks], axis=1).tolist():
        seen = set()
        P = prompts.shape[1]
        for j in range(n - 1, len(row)):
            g = tuple(row[j - n + 1 : j + 1])
            if j >= P and g in seen:
                bad += 1
            seen.add(g)
    return bad


def decode_split(torch, decode, spec, args, cbits, got, card):
    """Split the decode kernel's time at one shape: the launch as the path
    makes it, the same launch with the canary filter off, and the stream
    floor (``tools/decode_stream_floor.cu``: every logit, h1 entry and
    packed word moved, no probe at all, on the kernel's grid and on the
    first version's), timed in turns; and the device events of one
    call."""
    from repro_torch.kernels import _build
    lg, prefix, ready, _, h1 = args
    B, V = lg.shape
    floor = _build.load(str(STREAM_FLOOR_SRC)).decode_stream_floor
    vp, i = ctypes.c_void_p, ctypes.c_int
    floor.argtypes = [vp, vp, vp, vp, i, i, ctypes.c_uint, vp, vp, vp, i,
                      vp]
    floor.restype = ctypes.c_int
    rd = (ready != 0).to(torch.int32)
    outs = [torch.empty_like(got[k]) for k in ("logits", "banned", "canary")]

    def floor_launch(grid):
        e = floor(lg.data_ptr(), prefix.data_ptr(), rd.data_ptr(),
                  h1.data_ptr(), B, V, spec.hash_mask,
                  *[o.data_ptr() for o in outs], grid,
                  torch.cuda.current_stream().cuda_stream)
        if e != 0:
            raise RuntimeError(f"decode_stream_floor launch failed: {e}")

    off = dataclasses.replace(spec, canary_log2_m=0)
    kern = lambda: decode.decode_masks_fused(*args, spec=spec,
                                             canary_bits=cbits)
    t_k, t_off, t_fl, t_fl0 = palindrome(torch, [
        kern, lambda: decode.decode_masks_fused(*args, spec=off),
        lambda: floor_launch(1), lambda: floor_launch(0)])
    _, _, rows = profiled(torch, kern, 20)
    events = "; ".join(f"{k[:40]} x{c} {t / 1e3 / 20:.5f} ms" for t, k, c in
                       rows)
    print(f"kernel[decode split] ({B}, {V}): the launch {t_k:.5f} ms, canary "
          f"off {t_off:.5f} ms, stream floor {t_fl:.5f} ms: streaming "
          f"{t_fl:.5f}, session probes and the rest {t_off - t_fl:.5f}, "
          f"canary probes {t_k - t_off:.5f} ms; the launch / floor "
          f"{t_k / t_fl:.3f}; the floor on the first version's grid "
          f"{t_fl0:.5f} ms; device events of one call: {events} [{card}]")


def serve_phase(torch, card, reset_counts, read_counts, err_grid):
    """The serve path on qwen1.5-0.5b at full width; returns the decode
    kernel's entry of the kernels line, generated tokens/s and what the
    sharded phase serves again: the engine factory, the prompts and the
    greedy and sampled runs."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import sketches, u32
    from repro_torch.kernels import api, decode, ref
    from repro_torch.nn import lm
    from repro_torch.serve import sessions
    from repro_torch.serve.engine import (NoRepeatNgram, SamplerConfig,
                                          ServeEngine)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    params = lm.init(0, cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"serve: {cfg.name} at its published widths ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} KV, head_dim {cfg.resolved_head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab} padded to {lm.padded_vocab(cfg)}, "
          f"{cfg.param_dtype} parameters, {cfg.activation_dtype} "
          f"activations), {n_params} random parameters from seed 0 in "
          f"{time.perf_counter() - t0:.2f} s; TF32 off (cuBLAS and cuDNN)")
    scfg = SamplerConfig(temperature=0.0, no_repeat_ngram=SERVE_N,
                         bloom_log2_m=14, bloom_k=2, hash_bits=32,
                         canary_log2_m=20, canary_k=4, seed=0)
    nrn = NoRepeatNgram(cfg, scfg, dev)         # the engines' own h1 draw
    spec = dataclasses.replace(
        nrn.spec, canary_log2_m=scfg.canary_log2_m, canary_k=scfg.canary_k)
    rng = np.random.default_rng(11)
    grams = rng.integers(0, cfg.vocab, size=(CANARY_GRAMS, SERVE_N))
    cbits = canary_filter(torch, u32, ref, sketches, spec, nrn.h1,
                          torch.from_numpy(grams).to(dev))
    prompts = rng.integers(0, cfg.vocab, size=(SERVE_B, SERVE_P))
    planted = rng.choice(SERVE_B, PLANTED_ROWS, replace=False)
    for j, r in enumerate(planted):
        prompts[r, -(SERVE_N - 1):] = grams[j, : SERVE_N - 1]
    prompts = prompts.astype(np.int32)

    def engine(impl="kernel", mesh=None, **kw):
        s = dataclasses.replace(scfg, **kw)
        return ServeEngine(cfg, params, s, impl=impl, mesh=mesh,
                           canary_bits=cbits if s.ngram_plane != "legacy"
                           else None)

    # the main path: a greedy generate, every step checked (gate a)
    eng = engine()
    eng.generate(prompts[:2, :8], 2)            # first call: cuBLAS set-up
    torch.cuda.synchronize()
    reset_counts()
    with DecodeSpy(torch, api, compare=True) as spy:
        toks, stats = eng.generate(prompts, SERVE_NEW)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"launches[serve path]: {json.dumps(counts)}")
    if counts["decode"] != SERVE_NEW or len(spy.steps) != SERVE_NEW:
        raise AssertionError(f"gate (g): {counts['decode']} decode launches "
                             f"for {SERVE_NEW} fused steps")
    tele = stats["telemetry"]
    print(f"gate (a): every one of {len(spy.steps)} decode steps of the "
          f"greedy call: kernel == plain version (logits, banned and canary "
          f"words); gate (g): {counts['decode']} decode launches for "
          f"{SERVE_NEW} steps; telemetry {json.dumps(tele)}")
    # (b) the plain version on the card gives the same run
    rtoks, rstats = engine(impl="ref").generate(prompts, SERVE_NEW)
    strip = lambda t: {k: v for k, v in t.items() if k != "dispatches"}
    if not (np.array_equal(toks, rtoks)
            and strip(tele) == strip(rstats["telemetry"])):
        raise AssertionError("gate (b): impl='kernel' and impl='ref' differ")
    # (c) the legacy plane
    ltoks, lstats = engine(ngram_plane="legacy").generate(prompts, SERVE_NEW)
    if not np.array_equal(toks, ltoks):
        raise AssertionError("gate (c): fused and legacy planes differ")
    # (d) no repeated 4-gram completed by a generated token
    bad = repeated_completions(prompts, toks, SERVE_N)
    if bad:
        raise AssertionError(f"gate (d): {bad} generated tokens complete a "
                             f"repeated {SERVE_N}-gram")
    # (e) every planted row hits the canary at its first step
    c0 = spy.steps[0]["canary"].to(torch.int64).cpu().numpy()
    hits = [bool((c0[r, grams[j, -1] // 32] >> (grams[j, -1] % 32)) & 1)
            for j, r in enumerate(planted)]
    if not all(hits) or tele["canary_hits"] < PLANTED_ROWS:
        raise AssertionError(f"gate (e): planted rows' canary hits {hits}, "
                             f"total {tele['canary_hits']}")
    print(f"gates (b)-(e): ref == kernel (tokens, telemetry); legacy plane "
          f"== fused (tokens; legacy banned {lstats['banned_candidates']}); "
          f"no generated token completes a repeated {SERVE_N}-gram; planted "
          f"rows {sorted(planted.tolist())} hit the canary at step 0, "
          f"{tele['canary_hits']} canary hits in all")
    # (f) a sampled call
    seng = engine(temperature=0.8, top_k=50)
    reset_counts()
    with DecodeSpy(torch, api, compare=False) as sspy:
        stoks, sstats = seng.generate(prompts, SERVE_NEW)
    slaunches = read_counts()["decode"]
    rows = torch.arange(SERVE_B, device=dev)
    for step, out in enumerate(sspy.steps):
        t = torch.from_numpy(stoks[:, step]).to(dev, torch.int64)
        kth = torch.topk(out["logits"], 50, dim=-1).values[:, -1]
        words = out["banned"].to(torch.int64)[rows, t // 32]
        if not ((out["logits"][rows, t] >= kth).all()
                and ((words >> (t % 32)) & 1 == 0).all()
                and (t < cfg.vocab).all()):
            raise AssertionError(f"gate (f): a sampled token at step {step} "
                                 f"is outside its top 50 or banned")
    if slaunches != SERVE_NEW:
        raise AssertionError(f"gate (g): sampled call {slaunches} launches")
    print(f"gate (f): {stoks.size} sampled tokens (temperature 0.8, top-k "
          f"50) all within their row's top 50 and unbanned; "
          f"{slaunches} launches; banned "
          f"{sstats['banned_candidates']}, canary hits "
          f"{sstats['telemetry']['canary_hits']}")

    # -- times --
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(prompts, SERVE_NEW)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    # a decode step split: the model's step and the pool's step; the
    # profiler runs 8 steps twice (a warm-up, then the traced run)
    warm, split_steps, prof_steps = 4, 24, 8
    logits, caches = lm.prefill(params, cfg, prompts, SERVE_P + warm
                                + split_steps + 2 * prof_steps)
    pool = sessions.SessionPool(eng.decode_spec, SERVE_B, eng.nrn.h1,
                                canary_bits=eng.canary_bits, device=dev)
    pool.admit(SERVE_B)
    pool.prime(prompts)
    t_lm = t_pool = 0.0
    state = {"logits": logits, "caches": caches}

    def one_step(timed=None):
        nonlocal t_lm, t_pool
        lg = lm.mask_pad_logits(cfg, state["logits"].float())
        if timed:
            torch.cuda.synchronize()
            a = time.perf_counter()
        tok = pool.step(lg, temperature=0.0)
        if timed:
            torch.cuda.synchronize()
            b = time.perf_counter()
        state["logits"], state["caches"] = lm.decode_step(
            params, cfg, tok[:, None], state["caches"])
        if timed:
            torch.cuda.synchronize()
            t_pool += b - a
            t_lm += time.perf_counter() - b

    for _ in range(warm):
        one_step()
    for _ in range(split_steps):
        one_step(timed=True)
    idle = device_busy(torch, lambda: [one_step() for _ in range(prof_steps)],
                       card, f"serve decode, {prof_steps} steps (pool.step + "
                       f"lm.decode_step)")
    print(f"serve: generate of {SERVE_B} x {SERVE_NEW} tokens after "
          f"{SERVE_B} x {SERVE_P}-token prompts in {t_gen:.4f} s = "
          f"{SERVE_B * SERVE_NEW / t_gen:.1f} generated tokens/s; a decode "
          f"step (mean of {split_steps}, host clock with a synchronise "
          f"around each part): lm.decode_step {t_lm / split_steps * 1e3:.4f}"
          f" ms, SessionPool.step {t_pool / split_steps * 1e3:.4f} ms; card "
          f"idle {idle:.4f} over {prof_steps} steps [{card}]")

    # the kernel at the main path's shape, with the pool's real state
    st = pool.state
    ready = (st["count"] >= spec.n - 1) & (st["active"] != 0)
    lg = lm.mask_pad_logits(cfg, state["logits"].float())
    out = {}
    for B in (SERVE_B, 256):
        if B == SERVE_B:
            args = (lg, st["prefix"], ready, st["bloom"], pool.h1)
        else:        # more sessions: rows of the same state, repeated

            def rep(t):
                v = t.view(torch.int32) if t.dtype == torch.uint32 else t
                v = v.repeat((B // SERVE_B,) + (1,) * (t.dim() - 1))
                return v.view(t.dtype) if t.dtype == torch.uint32 else v
            args = (rep(lg), rep(st["prefix"]), rep(ready), rep(st["bloom"]),
                    pool.h1)
        args = tuple(a.contiguous() for a in args)
        kern = lambda: decode.decode_masks_fused(*args, spec=spec,
                                                 canary_bits=cbits)
        plain_fn = lambda: ref.decode_masks_ref(
            *args, n=spec.n, L=spec.L, hash_mask=spec.hash_mask,
            log2_m=spec.log2_m, k=spec.k, canary_bits=cbits,
            canary_log2_m=spec.canary_log2_m, canary_k=spec.canary_k)
        got, want = kern(), plain_fn()
        for key in want:
            if not same_bits(torch, got[key], want[key]):
                raise AssertionError(f"decode at ({B}, {lg.shape[1]}): "
                                     f"kernel {key} != plain")
        ms, plain_ms, kh, (k1, k2, p1, p2) = in_turns(
            torch, kern, plain_fn, k_iters=200, p_iters=5)
        pb, pc = probes_until_miss(torch, ref, u32, spec, *args[1:],
                                   canary_bits=cbits)
        b_ms, by, text = decode_bound(spec, B, lg.shape[1], pb, pc)
        print(f"kernel[decode_masks] ({B}, {lg.shape[1]}) n={spec.n} "
              f"log2_m={spec.log2_m} k={spec.k} canary 2^"
              f"{spec.canary_log2_m} k={spec.canary_k}: {ms:.5f} ms per "
              f"launch ({k1:.5f}, {k2:.5f}); plain version {plain_ms:.5f} ms "
              f"({p1:.5f}, {p2:.5f}); bound {b_ms:.5f} ms by {by} ({text}); "
              f"bound / time {b_ms / ms:.3f}; the host takes {kh:.5f} ms to "
              f"issue one launch [{card}]")
        decode_split(torch, decode, spec, args, cbits, got, card)
        out[B] = (ms, plain_ms, b_ms, by)
    ms, plain_ms, b_ms, by = out[SERVE_B]
    entry = {"name": "decode_masks", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/decode.cu",
             "replaces": "src/repro/kernels/decode.py:117",
             "launches": counts["decode"], "max_abs_err": err_grid,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
             "bound_by": by, "library_ms": None}
    ctx = {"engine": engine, "prompts": prompts,
           "greedy": (toks, tele), "sampled": (stoks, sstats["telemetry"])}
    return entry, SERVE_B * SERVE_NEW / t_gen, ctx


# -- the durable phase: executors, the graph, snapshots, the service -------------

# run_dedup_job's corpus: the first 20,000 of the dedup phase's documents
# (all 100,000 took 241.7 s on the card, past the phase's 60 s; PERF.md)
SERVICE_DOCS = 20_000
RAGGED = 300                # the ragged tail of the executor checks


def same_outputs(torch, got, want) -> bool:
    return set(got) == set(want) and all(torch.equal(got[k], want[k])
                                         for k in want)


def executor_checks(torch, api, stream, plan, x, xb, ops, card, what,
                    mesh=None):
    """run_stream's three executors at chunk_s = CHUNK_S, over ``x`` (a
    whole number of chunks) and over ``x`` cut to a ragged tail with some
    rows idle or short: each bit-equal to one-shot ``api.run`` with the
    kernel and with the plain version (on ``mesh`` when given: the stream
    row-sharded, each shard's graph replayed). Prints each executor's
    dispatches for the ragged stream."""
    B, S = x.shape
    cases = [(x, xb, None)]
    Sr = S - CHUNK_S + RAGGED
    nw = torch.randint(0, Sr - N + 2, (B,), device=x.device,
                       generator=torch.Generator(x.device).manual_seed(3))
    nw[: B // 8] = 0
    cases.append((x[:, :Sr].contiguous(),
                  None if xb is None else xb[:, :Sr].contiguous(), nw))
    for xc, xbc, nwc in cases:
        want = api.run(plan, xc, h1v_b=xbc, n_windows=nwc, operands=ops,
                       impl="kernel")
        plain = api.run(plan, xc, h1v_b=xbc, n_windows=nwc, operands=ops,
                        impl="ref")
        if not same_outputs(torch, want, plain):
            raise AssertionError(f"executors[{what}]: one-shot kernel != "
                                 f"plain at S={xc.shape[1]}")
        counts = {}
        for executor in ("host", "grid", "scan"):
            before = stream.dispatch_count()
            got = stream.run_stream(plan, xc, h1v_b=xbc, n_windows=nwc,
                                    operands=ops, chunk_s=CHUNK_S,
                                    executor=executor, mesh=mesh)
            counts[executor] = stream.dispatch_count() - before
            if not same_outputs(torch, got, want):
                raise AssertionError(f"executors[{what}]: {executor} != "
                                     f"one shot at S={xc.shape[1]}")
        chunks = -(-xc.shape[1] // CHUNK_S)
        if counts != {"host": chunks, "grid": 1, "scan": 1}:
            raise AssertionError(f"executors[{what}]: dispatches {counts}, "
                                 f"expected host {chunks}, grid 1, scan 1")
        print(f"executors[{what}] B={B} S={xc.shape[1]} chunk_s={CHUNK_S}"
              f"{' ragged, ' + str(int((nwc == 0).sum())) + ' idle rows' if nwc is not None else ''}: "
              f"host, grid and scan each equal one-shot api.run (kernel and "
              f"plain); dispatches {json.dumps(counts)} [{card}]")


def graph_vs_eager(torch, api, stream, ngc, tok_block, card):
    """One (T, B, C) stats block through the CUDA-graph replay and through
    the eager loop, in turns (eager, graph, graph, eager): device ms and
    host ms a block, then each one's idle share over 10 blocks."""
    T, B, C = tok_block.shape
    plan = ngc.plan
    dev = torch.device("cuda")
    chunks = ngc._lookup(tok_block)
    lens = torch.full((T, B), C, dtype=torch.int32, device=dev)
    ops = api._check_operands(plan, {"cms": ngc._cms_ops()}, None, dev)
    s0 = stream.init_state(plan, B, device=dev)
    graph = lambda: stream._graph_block(plan, s0, chunks, None, lens, ops)
    eager = lambda: stream._eager_block(plan, s0, chunks, None, lens, ops,
                                        False)
    g, e = graph(), eager()
    for name in ("hll", "cms"):
        if not torch.equal(g["sketch"][name], e["sketch"][name]):
            raise AssertionError(f"graph[{name}]: replay != eager loop")
    if not (torch.equal(g["tail"], e["tail"])
            and torch.equal(g["seen"], e["seen"])):
        raise AssertionError("graph: replay tail/seen != eager loop")
    (e1, eh1), (g1, gh1), (g2, gh2), (e2, eh2) = (
        device_ms(torch, eager, 20), device_ms(torch, graph, 20),
        device_ms(torch, graph, 20), device_ms(torch, eager, 20))
    ten = lambda fn: (lambda: [fn() for _ in range(10)])
    g_idle = device_busy(torch, ten(graph), card,
                         f"graph replay, 10 blocks ({T}, {B}, {C})")
    e_idle = device_busy(torch, ten(eager), card,
                         f"eager loop, 10 blocks ({T}, {B}, {C})")
    gd, gh = min(g1, g2), min(gh1, gh2)
    ed, eh = min(e1, e2), min(eh1, eh2)
    print(f"graph[stats block ({T}, {B}, {C})]: replay {gd:.5f} ms on the "
          f"card ({g1:.5f}, {g2:.5f}), host {gh:.5f} ms ({gh1:.5f}, "
          f"{gh2:.5f}), idle {g_idle:.4f}; eager loop {ed:.5f} ms on the "
          f"card ({e1:.5f}, {e2:.5f}), host {eh:.5f} ms ({eh1:.5f}, "
          f"{eh2:.5f}), idle {e_idle:.4f}; replay / eager: card "
          f"{gd / ed:.3f}, host {gh / eh:.3f}, card + host "
          f"{(gd + gh) / (ed + eh):.3f}; update_many replays the graph "
          f"[{card}]")


def stats_rates(torch, stream, ngc, rows, card):
    """``update_stream_many`` over every block of ``rows``, warm, with
    ``update_many``'s graph replay and, for this measurement only, with
    the eager loop in its place, in turns (eager, graph, graph, eager):
    tokens/s of each (the faster of its two runs) and each one's idle
    share over two blocks."""
    replay = stream._graph_block

    def eager(plan, state, chunks, chunk_b, lengths, ops):
        return stream._eager_block(plan, state, chunks, chunk_b, lengths,
                                   ops, False)

    def run(block, fn):
        stream._graph_block = block
        try:
            return fn()
        finally:
            stream._graph_block = replay

    def seconds():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats_run(ngc, rows)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    e1, g1, g2, e2 = (run(eager, seconds), run(replay, seconds),
                      run(replay, seconds), run(eager, seconds))
    two = rows[:, : 2 * BLOCK_T * CHUNK_S]
    g_idle = run(replay, lambda: device_busy(
        torch, lambda: stats_run(ngc, two), card,
        f"stats cyclic, graph replay, 2 blocks ({two.size} tokens)"))
    e_idle = run(eager, lambda: device_busy(
        torch, lambda: stats_run(ngc, two), card,
        f"stats cyclic, eager loop, 2 blocks ({two.size} tokens)"))
    g, e = rows.size / min(g1, g2), rows.size / min(e1, e2)
    print(f"stats[cyclic] warm, update_stream_many over {rows.size} tokens: "
          f"graph replay {g:.0f} tokens/s ({min(g1, g2):.4f} s, "
          f"{max(g1, g2):.4f} s), idle {g_idle:.4f}; eager loop {e:.0f} "
          f"tokens/s ({min(e1, e2):.4f} s, {max(e1, e2):.4f} s), idle "
          f"{e_idle:.4f}; graph / eager {g / e:.3f} [{card}]")


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def dataplane_durability(torch, pipeline, stats, durable, fault, dp_ref, dc,
                         tmp: Path, card, steps=100, every=25, kill=60,
                         interrupt=50, data_shards=None):
    """``DataPlane`` for ``kill`` steps with a snapshot every ``every``
    (the one at ``interrupt`` killed mid-write by a FailureInjector), then
    a fresh plane of another stats seed restores and runs to ``steps``: its
    registers, table and token count must equal ``dp_ref``'s uninterrupted
    run. ``data_shards``: both planes' dedup signing and stats on a data
    mesh of that many shards."""
    cfg = dataclasses.replace(dp_ref.corpus.cfg, data_shards=data_shards)
    inj = fault.FailureInjector(fail_kinds={interrupt: fault.SnapshotInterrupt})
    a = pipeline.DataPlane(cfg, decontam=dc, stats=stats.NgramStats(
        stats.StatsConfig(impl=cfg.impl, device=cfg.device,
                          data_shards=data_shards)))
    saves, lost = [], 0
    for step in range(kill):
        a.next_batch(step)
        if (step + 1) % every == 0:
            t0 = time.perf_counter()
            try:
                a.snapshot(str(tmp), step + 1, injector=inj)
                saves.append(time.perf_counter() - t0)
            except fault.SnapshotInterrupt:
                lost += 1
    if lost != 1 or durable.latest_epoch(str(tmp)) != every:
        raise AssertionError(f"dataplane: {lost} interrupted snapshots, "
                             f"latest {durable.latest_epoch(str(tmp))}")
    b = pipeline.DataPlane(cfg, stats=stats.NgramStats(stats.StatsConfig(
        seed=12345, impl=cfg.impl, device=cfg.device,
        data_shards=data_shards)), decontam=dc)
    t0 = time.perf_counter()
    epoch = b.restore(str(tmp))
    restore_s = time.perf_counter() - t0
    for step in range(epoch, steps):
        b.next_batch(step)
        if (step + 1) % every == 0:
            t0 = time.perf_counter()
            b.snapshot(str(tmp), step + 1)
            saves.append(time.perf_counter() - t0)
    for key in ("hll", "cms"):
        diff = int((b.stats_state[key] != dp_ref.stats_state[key]).sum())
        if diff:
            raise AssertionError(f"dataplane: restored {key} differs from "
                                 f"the uninterrupted run at {diff} entries")
    if b.telemetry() != dp_ref.telemetry():
        raise AssertionError(f"dataplane: telemetry {b.telemetry()} != "
                             f"{dp_ref.telemetry()}")
    nbytes = dir_bytes(tmp / f"step_{steps:08d}")
    save_ms, restore_ms = 1e3 * float(np.median(saves)), 1e3 * restore_s
    print(f"dataplane durability"
          f"{'' if data_shards is None else f' (data_shards={data_shards})'}"
          f": {kill} steps, a snapshot every {every} "
          f"(the one at {interrupt} interrupted), a fresh plane restored "
          f"epoch {epoch} and ran to {steps}: registers, table and telemetry "
          f"equal the uninterrupted run; snapshot {nbytes} bytes, save "
          f"{save_ms:.3f} ms (median of {len(saves)}), restore "
          f"{restore_ms:.3f} ms [{card}]")


def service_checks(torch, dedup, service, fault, dd, docs, want_flags,
                   add_batch_dps, tmp: Path, card, n_docs=SERVICE_DOCS,
                   seed=0):
    """run_dedup_job on a 4-worker, 2-way replicated DedupService under a
    seeded chaos storm with job kills: flags equal ``want_flags`` (the
    in-process deduper's add_batch); an elastic restore onto 3 workers at
    replication 1 gives them again; a killed worker costs no recall and
    its revival drains the repair queue."""
    docs = docs[:n_docs]
    n_batches = -(-len(docs) // 1000)
    chaos = fault.ChaosSchedule(seed, n_batches, n_workers=4, replication=2,
                                job_kill_rate=0.5)
    params = dd.export_state()["params"]
    svc = service.DedupService(dd.cfg, service.ServiceConfig(
        n_workers=4, replication=2))
    svc.dd.import_params(params)
    t0 = time.perf_counter()
    res = service.run_dedup_job(svc, docs, directory=str(tmp),
                                batch_docs=1000, snapshot_every=10,
                                chaos=chaos, max_restarts=n_batches)
    dt = time.perf_counter() - t0
    bad = int((res["flags"] != want_flags[: len(docs)]).sum())
    if bad:
        raise AssertionError(f"service: {bad} flags differ from add_batch")
    other = service.DedupService(dd.cfg, service.ServiceConfig(
        n_workers=3, replication=1))
    res2 = service.run_dedup_job(other, docs, directory=str(tmp),
                                 batch_docs=1000, snapshot_every=10)
    bad = int((res2["flags"] != want_flags[: len(docs)]).sum())
    if bad or len(other) != len(svc):
        raise AssertionError(f"service: elastic restore: {bad} flags differ, "
                             f"{len(other)} != {len(svc)} docs indexed")
    other.close()
    # fresh documents probed with worker 1 down, then worker 1 revived;
    # the oracle is the deduper that flagged the same documents
    fresh, _ = corpus_docs(2000)
    oracle = dd
    if len(docs) < len(want_flags):
        oracle = dedup.MinHashDeduper(dd.cfg)
        oracle.import_params(params)
        oracle.add_batch(docs)
    svc.kill_worker(1)
    got = svc.add_batch(fresh)
    tele = svc.telemetry()
    if not np.array_equal(got, oracle.add_batch(fresh)):
        raise AssertionError("service: flags with worker 1 down != oracle")
    if tele["recall_loss"] != 0.0 or tele["repair_queue_pairs"] == 0:
        raise AssertionError(f"service: worker 1 down: recall_loss "
                             f"{tele['recall_loss']}, repair queue "
                             f"{tele['repair_queue_pairs']}")
    queued = tele["repair_queue_pairs"]
    svc.revive_worker(1)
    tele = svc.telemetry()
    if tele["repair_queue_pairs"] != 0 or tele["dead_replicas"] != 0:
        raise AssertionError(f"service: revive left {tele}")
    svc.close()
    counts = chaos.counts()
    print(f"service: run_dedup_job over {len(docs)} docs in batches of 1000, "
          f"a snapshot every 10, chaos seed {seed} ({json.dumps(counts)}): "
          f"{res['restarts']} restarts, flags equal add_batch's; elastic "
          f"restore on 3 workers at replication 1 equal; worker 1 killed: "
          f"recall_loss 0.0, {queued} pairs queued, revived: queue 0; "
          f"{dt:.3f} s = {len(docs) / dt:.0f} docs/s against add_batch's "
          f"{add_batch_dps:.0f} docs/s [{card}]")


def corpus_docs(n: int, seed: int = 4242):
    """``n`` documents of the dedup corpus's kind, from another seed."""
    from repro_torch.data import corpus
    return corpus.documents(corpus.CorpusSpec(
        n_docs=n, dup_rate=0.25, mutate_frac=0.015, vocab=8192, seed=seed))


def unfused_checks(torch, dedup, stats, docs, rows, card):
    """THREEWISE signing and stats on the card equal the same run of the
    plain path on the CPU, bit for bit."""
    kw = dict(family="threewise", vocab=8192)
    sig = {}
    for dev in ("cuda", "cpu"):
        d = dedup.MinHashDeduper(dedup.DedupConfig(device=dev, **kw))
        sig[dev] = d.signature_many(docs[:300])
    if not np.array_equal(sig["cuda"], sig["cpu"]):
        raise AssertionError("unfused: THREEWISE signatures on the card != "
                             "the CPU's")
    st = {}
    for dev in ("cuda", "cpu"):
        ng = stats.NgramStats(stats.StatsConfig(device=dev, **kw))
        s = ng.update(ng.init_state(), rows[:64, :1024])
        st[dev] = {k: s[k].cpu() for k in ("hll", "cms")}
    for key in ("hll", "cms"):
        if not torch.equal(st["cuda"][key], st["cpu"][key]):
            raise AssertionError(f"unfused: THREEWISE stats {key} on the "
                                 f"card != the CPU's")
    print(f"unfused: THREEWISE signatures of 300 docs and stats of 64 x 1024 "
          f"tokens on the card equal the CPU's [{card}]")


def durable_phase(torch, card, reset_counts, read_counts, ng, dc, dp, dd,
                  docs, flags, rows, add_batch_dps):
    """The streaming executors, the graph against the eager loop, the data
    plane's snapshots and the replicated dedup service, on the card."""
    import tempfile
    from repro_torch.data import durable, pipeline, service, stats
    from repro_torch.data import dedup as dedup_mod
    from repro_torch.kernels import api, stream
    from repro_torch.train import fault
    ngc = ng["cyclic"]
    S = 16 * CHUNK_S
    toks = rows[:, :S]
    x = ngc._lookup(toks)
    xa, xb = dc._lookups(toks)
    reset_counts()
    # (a) the executors on the stats and the decontam plans
    executor_checks(torch, api, stream, ngc.plan, x, None,
                    {"cms": ngc._cms_ops()}, card, "stats")
    executor_checks(torch, api, stream, dc.plan, xa, xb,
                    {"bloom": {"bits": dc.bits}}, card, "decontam")
    # (b) one stats block, graph against eager
    block = next(stats_blocks(rows[:, : BLOCK_T * CHUNK_S]))[0]
    graph_vs_eager(torch, api, stream, ngc, block, card)
    stats_rates(torch, stream, ngc, rows, card)
    with tempfile.TemporaryDirectory() as tmp:
        # (c) the data plane's snapshots
        dataplane_durability(torch, pipeline, stats, durable, fault, dp, dc,
                             Path(tmp) / "dataplane", card)
        # (d) the service
        service_checks(torch, dedup_mod, service, fault, dd, docs, flags,
                       add_batch_dps, Path(tmp) / "service", card,
                       n_docs=SERVICE_DOCS)
    counts = read_counts()
    print(f"launches[durable phase]: {json.dumps(counts)}")
    for kind in ("MinHashSpec", "HLLSpec", "CountMinSpec", "BloomSpec"):
        if counts[kind] < 1:
            raise AssertionError(f"durable phase launched no {kind} plan")
    # (e) the unfused paths
    unfused_checks(torch, dedup_mod, stats, docs, rows, card)


# -- the sharded phase: the multi-device layer on virtual shards ----------------
SHARD_B = 1021              # run_sharded's rows: no d > 1 divides them


def sharded_turns(torch, fns, iters=20):
    """(device ms, host ms) a call of each of ``fns`` (name -> fn), timed in
    turns A B C C B A; each the lower of its two readings."""
    names = list(fns)
    first = {k: device_ms(torch, fns[k], iters) for k in names}
    second = {k: device_ms(torch, fns[k], iters) for k in reversed(names)}
    return {k: (min(first[k][0], second[k][0]), min(first[k][1], second[k][1]))
            for k in names}


def turns_text(times) -> str:
    return "; ".join(f"{k} {d:.5f} ms card, {h:.5f} ms host"
                     for k, (d, h) in times.items())


def sharded_plans(torch, api, shard, meshes, ng, dc, dd, gdd, rows, card):
    """``run_sharded`` of the stats, decontam and dedup plans, both families
    where the path has them, at SHARD_B x 8192 with warm global carries,
    on each mesh: bit-equal to ``api.run``; then one stats call timed."""
    toks = rows[:SHARD_B, : 16 * CHUNK_S]
    cases = []
    for family in ("cyclic", "general"):
        st = ng[family]
        x = st._lookup(toks)
        ops = {"cms": st._cms_ops()}
        warm = api.run(st.plan, x[:64], operands=ops)
        cases.append((f"stats {family}", st.plan, x, None, {
            "hll": {"init": warm["hll"]},
            "cms": {**st._cms_ops(), "init": warm["cms"]}}))
        deduper = dd if family == "cyclic" else gdd
        cases.append((f"dedup {family}", deduper.plan,
                       deduper.fam._lookup(deduper.fam_params,
                                           torch.from_numpy(toks).cuda()),
                       None, {"sig": {"a": deduper.mh_params["a"],
                                      "b": deduper.mh_params["b"]}}))
    xa, xb = dc._lookups(toks)
    cases.append(("decontam cyclic", dc.plan, xa, xb,
                  {"bloom": {"bits": dc.bits}}))
    gen = torch.Generator().manual_seed(5)
    nw = torch.randint(0, toks.shape[1] - N + 2, (SHARD_B,), generator=gen)
    nw[:SHARD_B // 8] = 0
    for what, plan, x, xb2, ops in cases:
        want = api.run(plan, x, h1v_b=xb2, n_windows=nw, operands=ops)
        for name, mesh in meshes.items():
            got = shard.run_sharded(plan, x, h1v_b=xb2, n_windows=nw,
                                    operands=ops, mesh=mesh)
            if not same_outputs(torch, got, want):
                raise AssertionError(f"sharded[{what}]: run_sharded on "
                                     f"{name} != api.run")
        print(f"sharded[{what}] ({SHARD_B}, {x.shape[1]}), an eighth of "
              f"the rows idle: run_sharded on {', '.join(meshes)} == "
              f"api.run, bit for bit [{card}]")
    _, plan, x, _, ops = cases[0]
    fns = {"api.run": lambda: api.run(plan, x, operands=ops)}
    for name, mesh in meshes.items():
        fns[name] = (lambda m: lambda: shard.run_sharded(
            plan, x, operands=ops, mesh=m))(mesh)
    print(f"sharded[run_sharded stats plan ({SHARD_B}, {x.shape[1]})]: "
          f"{turns_text(sharded_turns(torch, fns))} [{card}]")


def sharded_stats(torch, stats, stream, sketch_fused, meshes, ngc, rows,
                  card):
    """``NgramStats`` on each mesh over the same (8, 1024, 512) blocks
    (``update_many``'s per-shard graphs): registers, table and token count
    equal the one-device run's; the dispatches and launches of the run;
    one block timed at each shard count, with its idle share over 10."""
    cut = rows[:, : 4 * BLOCK_T * CHUNK_S]
    want = stats_run(ngc, cut)
    by_mesh = {}
    for name, mesh in meshes.items():
        ng = stats.NgramStats(stats.StatsConfig(device="cuda"), mesh=mesh)
        ng.rebind_params(ngc.export_params())
        stats_run(ng, cut[:, : BLOCK_T * CHUNK_S])     # the captures
        before = (stream.dispatch_count(), sketch_fused.LAUNCHES)
        got = stats_run(ng, cut)
        after = (stream.dispatch_count(), sketch_fused.LAUNCHES)
        for key in ("hll", "cms"):
            if not torch.equal(got[key], want[key]):
                raise AssertionError(f"sharded stats on {name}: {key} != "
                                     f"one device")
        if got["tokens"].tolist() != want["tokens"].tolist():
            raise AssertionError(f"sharded stats on {name}: tokens differ")
        by_mesh[name] = ng
        print(f"sharded[stats on {name}]: update_stream_many over "
              f"{cut.size} tokens == one device (registers, table, tokens); "
              f"{after[0] - before[0]} dispatches, "
              f"{(after[0] - before[0]) * mesh.size} graph replays, "
              f"{after[1] - before[1]} plan launches [{card}]")
    block = next(stats_blocks(cut))[0]
    chunks = ngc._lookup(block)
    T, B, C = chunks.shape
    lens = torch.full((T, B), C, dtype=torch.int32, device="cuda")
    ops = {"cms": ngc._cms_ops()}
    fns = {"one device": (lambda s: lambda: stream.update_many(
        ngc.plan, s, chunks, lengths=lens, operands=ops))(
            stream.init_state(ngc.plan, B, device="cuda"))}
    for name, mesh in meshes.items():
        fns[name] = (lambda s: lambda: stream.update_many(
            ngc.plan, s, chunks, lengths=lens, operands=ops))(
                stream.init_state(ngc.plan, B, device="cuda", mesh=mesh))
    times = sharded_turns(torch, fns)
    idle = {k: device_busy(torch, (lambda f: lambda: [f() for _ in
                                                      range(10)])(fns[k]),
                           card, f"stats block {k}, 10 blocks")
            for k in fns}
    print(f"sharded[stats block ({T}, {B}, {C})]: {turns_text(times)}; "
          f"idle over 10 blocks "
          f"{', '.join(f'{k} {v:.4f}' for k, v in idle.items())} [{card}]")
    return by_mesh


def sharded_elastic(torch, stats, shard, ngc, rows, mesh4, card):
    """A stats stream exported at 4 shards and imported at 1 and 2, and
    one exported at 1 imported at 4, each finished there: the registers,
    table and tokens of the uninterrupted one-device run."""
    cut = rows[:, : 4 * BLOCK_T * CHUNK_S]
    blocks = list(stats_blocks(cut))
    want = stats_run(ngc, cut)
    two = shard.DataMesh((torch.device("cuda", 0),) * 2)
    plans = (("4 shards", mesh4, "1 shard", shard.data_mesh(1)),
             ("4 shards", mesh4, "2 shards", two),
             ("1 shard", shard.data_mesh(1), "4 shards", mesh4))
    for save_name, save_mesh, load_name, load_mesh in plans:
        a = stats.NgramStats(stats.StatsConfig(device="cuda"),
                             mesh=save_mesh)
        a.rebind_params(ngc.export_params())
        ss = a.init_stream(cut.shape[0])
        for toks, lens in blocks[:2]:
            ss = a.update_stream_many(ss, toks, lengths=lens)
        tree = a.export_stream(ss)
        b = stats.NgramStats(stats.StatsConfig(device="cuda", seed=777),
                             mesh=load_mesh)
        ss = b.import_stream(tree)
        for toks, lens in blocks[2:]:
            ss = b.update_stream_many(ss, toks, lengths=lens)
        got = b.finalize_stream(ss)
        for key in ("hll", "cms"):
            if not torch.equal(got[key], want[key]):
                raise AssertionError(f"elastic {save_name} -> {load_name}: "
                                     f"{key} != one device")
        if got["tokens"].tolist() != want["tokens"].tolist():
            raise AssertionError(f"elastic {save_name} -> {load_name}: "
                                 f"tokens differ")
    print(f"sharded[elastic]: a stats stream of {cut.shape[0]} rows saved "
          f"after 2 of {len(blocks)} blocks at 4 shards and restored at 1 "
          f"and at 2, and saved at 1 restored at 4, each finished there: "
          f"registers, table and tokens equal the one-device run [{card}]")


def sharded_dedup(torch, dedup, service, fault, dd, docs, flags, mesh4,
                  card, n_docs=SERVICE_DOCS):
    """``MinHashDeduper`` on the 4-shard mesh over the first ``n_docs``
    documents: signatures and verdicts equal the one-device deduper's; then
    ``DedupService(mesh=...)`` over them under the durable phase's chaos
    storm: flags equal."""
    sub = docs[:n_docs]
    sd = dedup.MinHashDeduper(dd.cfg, mesh=mesh4)
    params = dd.export_state()["params"]
    sd.import_params(params)
    t0 = time.perf_counter()
    sigs = sd.signature_many(sub)
    t_sign = time.perf_counter() - t0
    if not np.array_equal(sigs, dd.signature_many(sub)):
        raise AssertionError("sharded dedup: signatures != one device")
    got = sd.add_batch(sub)
    if not np.array_equal(got, flags[:n_docs]):
        raise AssertionError("sharded dedup: flags != one device")
    sd.close()
    n_batches = -(-n_docs // 1000)
    chaos = fault.ChaosSchedule(0, n_batches, n_workers=4, replication=2,
                                job_kill_rate=0.5)
    svc = service.DedupService(dd.cfg, service.ServiceConfig(
        n_workers=4, replication=2), mesh=mesh4)
    svc.dd.import_params(params)
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = service.run_dedup_job(svc, sub, directory=tmp,
                                    batch_docs=1000, snapshot_every=10,
                                    chaos=chaos, max_restarts=n_batches)
        dt = time.perf_counter() - t0
    svc.close()
    if not np.array_equal(res["flags"], flags[:n_docs]):
        raise AssertionError("sharded service: flags != one device")
    print(f"sharded[dedup]: {n_docs} docs on 4 shards (groups of "
          f"{dd.cfg.stream_rows} x 4 rows): signatures and add_batch flags "
          f"== one device, signing {t_sign:.3f} s; DedupService(mesh) under "
          f"chaos seed 0 ({json.dumps(chaos.counts())}): {res['restarts']} "
          f"restarts, flags == one device, {dt:.3f} s [{card}]")


def sharded_serve(torch, ctx, mesh1, mesh4, card):
    """``ServeEngine`` with its pool on 1 and on 4 virtual shards, greedy
    and sampled: tokens and telemetry (canary and banned counts) equal at
    both and equal the serve phase's one-device runs."""
    strip = lambda t: {k: v for k, v in t.items() if k != "dispatches"}
    for kind, kw in (("greedy", {}), ("sampled",
                                      {"temperature": 0.8, "top_k": 50})):
        base_toks, base_tele = ctx[kind]
        runs = {}
        for name, mesh in (("1 shard", mesh1), ("4 shards", mesh4)):
            toks, st = ctx["engine"](mesh=mesh, **kw).generate(
                ctx["prompts"], SERVE_NEW)
            runs[name] = (toks, strip(st["telemetry"]))
            if not (np.array_equal(toks, base_toks)
                    and runs[name][1] == strip(base_tele)):
                raise AssertionError(f"sharded serve {kind} on {name} != "
                                     f"one device")
        tele = runs["4 shards"][1]
        print(f"sharded[serve {kind}]: {SERVE_ARCH}, {SERVE_B} prompts x "
              f"{SERVE_P}, {SERVE_NEW} new, the pool on 1 and on 4 virtual "
              f"shards: tokens and telemetry == one device (canary hits "
              f"{tele['canary_hits']}, banned {tele['banned_candidates']})"
              f" [{card}]")


def sharded_phase(torch, card, reset_counts, read_counts, ng, dc, dp, dd,
                  gdd, docs, flags, rows, serve_ctx):
    """The multi-device layer (``kernels/shard.py``) on ``data_mesh(1)`` and
    on four virtual shards of the one card: plans, streams, elastic
    restore, the data plane's snapshots, dedup and the service, serving —
    each held bit for bit against the same call without a mesh."""
    import tempfile
    from repro_torch.data import dedup as dedup_mod
    from repro_torch.data import durable, pipeline, service
    from repro_torch.data import stats as stats_mod
    from repro_torch.kernels import api, shard, sketch_fused, stream
    from repro_torch.train import fault
    print(f"sharded: torch.cuda.device_count() = "
          f"{torch.cuda.device_count()}; every shard here runs on cuda:0 "
          f"(the distinct-device path needs more cards) [{card}]")
    mesh1 = shard.data_mesh(1)
    mesh4 = shard.DataMesh((torch.device("cuda", 0),) * 4)
    meshes = {"data_mesh(1)": mesh1, "4 virtual shards": mesh4}
    ngc = ng["cyclic"]
    split, t0 = {}, time.perf_counter()

    def lap(what):
        nonlocal t0
        now = time.perf_counter()
        split[what] = round(now - t0, 1)
        t0 = now

    reset_counts()
    sharded_plans(torch, api, shard, meshes, ng, dc, dd, gdd, rows, card)
    lap("plans")
    toks = rows[:, : 16 * CHUNK_S]
    x = ngc._lookup(toks)
    xa, xb = dc._lookups(toks)
    for name, mesh in meshes.items():
        executor_checks(torch, api, stream, ngc.plan, x, None,
                        {"cms": ngc._cms_ops()}, card, f"stats, {name}",
                        mesh=mesh)
        executor_checks(torch, api, stream, dc.plan, xa, xb,
                        {"bloom": {"bits": dc.bits}}, card,
                        f"decontam, {name}", mesh=mesh)
    lap("executors")
    sharded_stats(torch, stats_mod, stream, sketch_fused,
                  {"1 shard": mesh1, "4 shards": mesh4}, ngc, rows, card)
    lap("stats")
    sharded_elastic(torch, stats_mod, shard, ngc, rows, mesh4, card)
    lap("elastic")
    with tempfile.TemporaryDirectory() as tmp:
        dataplane_durability(torch, pipeline, stats_mod, durable, fault, dp,
                             dc, Path(tmp), card, data_shards=1)
    lap("dataplane")
    sharded_dedup(torch, dedup_mod, service, fault, dd, docs, flags, mesh4,
                  card)
    lap("dedup and service")
    sharded_serve(torch, serve_ctx, mesh1, mesh4, card)
    lap("serve")
    print(f"sharded phase split, s: {json.dumps(split)} [{card}]")
    counts = read_counts()
    print(f"launches[sharded phase]: {json.dumps(counts)}")
    for kind in ("MinHashSpec", "HLLSpec", "CountMinSpec", "BloomSpec",
                 "decode"):
        if counts[kind] < 1:
            raise AssertionError(f"sharded phase launched no {kind} kernel")


# -- the analyzer ------------------------------------------------------------

SHIM_B = (8, 1024)
SHIM_S = (7, 520, 8192)


def shim_checks(torch, ops, ref, sketch_fused, gen) -> int:
    """Each deprecated single-sketch shim through the plan kernel, bit-equal
    to its plain version on the card, both discard settings, B in SHIM_B x
    S in SHIM_S with random n_windows (the dedup and decontam widths: k =
    64, HLL b = 12, Bloom 2^22 bits with k = 4), one plan launch a call.
    ``gen``: a CPU generator. Returns the calls checked."""
    import warnings
    dev = torch.device("cuda")
    a, b = rand_u32(torch, gen, (64,), dev), rand_u32(torch, gen, (64,), dev)
    bits = (rand_u32(torch, gen, (1 << 17,), dev).view(torch.int32)
            | rand_u32(torch, gen, (1 << 17,), dev).view(torch.int32)).view(
                torch.uint32)                 # dense: probes hit and miss
    calls = 0
    for discard in (True, False):
        for B in SHIM_B:
            for S in SHIM_S:
                n = 8 if S >= 8 else 5     # the wrappers need S >= n
                x = rand_u32(torch, gen, (B, S), dev)
                xb = rand_u32(torch, gen, (B, S), dev)
                nw = torch.randint(0, S - n + 2, (B,), generator=gen,
                                   dtype=torch.int32).to(dev)
                hm = (1 << (32 - n + 1)) - 1 if discard else 0xFFFFFFFF
                rank = (32 - n + 1 if discard else 32) - 12
                pairs = {
                    "ops.cyclic_minhash": lambda impl: ops.cyclic_minhash(
                        x, a, b, n=n, n_windows=nw, discard=discard,
                        impl=impl),
                    "ops.cyclic_hll": lambda impl: ops.cyclic_hll(
                        x, n=n, b=12, n_windows=nw, discard=discard,
                        impl=impl),
                    "ops.cyclic_bloom": lambda impl: ops.cyclic_bloom(
                        x, xb, bits, n=n, k=4, log2_m=22, n_windows=nw,
                        discard=discard, impl=impl),
                    "cyclic_minhash_fused": lambda impl: (
                        sketch_fused.cyclic_minhash_fused(
                            x, nw, a, b, n=n, hash_mask=hm)
                        if impl == "kernel" else ref.minhash_fused_ref(
                            x, nw, a, b, n=n, hash_mask=hm)),
                    "cyclic_hll_fused": lambda impl: (
                        sketch_fused.cyclic_hll_fused(
                            x, nw, n=n, b=12, rank_bits=rank, hash_mask=hm)
                        if impl == "kernel" else ref.hll_fused_ref(
                            x, nw, n=n, b=12, rank_bits=rank,
                            hash_mask=hm)),
                    "cyclic_bloom_fused": lambda impl: (
                        sketch_fused.cyclic_bloom_fused(
                            x, xb, nw, bits, n=n, k=4, log2_m=22,
                            hash_mask=hm)
                        if impl == "kernel" else ref.bloom_fused_ref(
                            x, xb, nw, bits, n=n, k=4, log2_m=22,
                            hash_mask=hm))}
                for name, call in pairs.items():
                    before = sketch_fused.LAUNCHES
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore", DeprecationWarning)
                        got = call("kernel")
                        launched = sketch_fused.LAUNCHES - before
                        want = call("ref")
                    if launched != 1:
                        raise AssertionError(f"{name} made {launched} plan "
                                             f"launches, not 1")
                    if not same_bits(torch, got, want):
                        raise AssertionError(
                            f"{name} kernel != plain version at B={B}, "
                            f"S={S}, n={n}, discard={discard}")
                    calls += 1
    return calls


def analysis_phase(torch, card, reset_counts, read_counts):
    """The analyzer on the card (``repro_torch.analysis``): the contract
    census of every registered entry point with the kernels, on no mesh,
    ``data_mesh(1)`` and four virtual shards of the card, must find no
    violation; its negative controls (a body that runs the plan twice
    under ``api.run``'s contract, a session step whose carry comes back
    copied) must be flagged; every deprecated shim through the plan kernel
    equals its plain version, one launch a call."""
    from repro_torch.analysis import contracts, discard, lint
    from repro_torch.kernels import api, ops, ref, sketch_fused
    from repro_torch.kernels.plan import DecodeSpec
    from repro_torch.serve import sessions
    t0 = time.perf_counter()
    reset_counts()
    violations = contracts.verify_contracts(device="cuda",
                                            device_counts=(1, 4))
    for v in violations:
        print(f"analysis violation: {v}")
    if violations:
        raise AssertionError(f"{len(violations)} contract violation(s) on "
                             f"the card")
    census_s = time.perf_counter() - t0
    # negative controls: the census must read its counters
    dev = torch.device("cuda")
    limit = contracts.device_smem_limit(dev)
    plan = contracts._sketch_plan("cyclic")
    x, xb, ops_ = contracts._sketch_args(dev)
    run = lambda: api.run(plan, x, h1v_b=xb, operands=ops_, impl="kernel")

    def doubled():
        run()
        return run()

    flagged = contracts.check_census(
        contracts.contract_for(api.run), contracts.take_census(doubled),
        plan=plan, card=True)
    if not any(f.startswith("launches:") for f in flagged):
        raise AssertionError(f"a second plan launch went unflagged: "
                             f"{flagged}")
    spec = DecodeSpec(n=4, log2_m=8, canary_log2_m=8)
    gen = torch.Generator().manual_seed(12)
    pool = sessions.SessionPool(spec, 8, rand_u32(torch, gen, (64,), dev),
                                canary_bits=rand_u32(
                                    torch, gen, (spec.canary_words,), dev))
    pool.admit(8)
    logits = torch.randn((8, 64), generator=gen).to(dev)

    def copied():
        token = pool.step(logits, temperature=0.0)
        pool.state = {k: v.clone() for k, v in pool.state.items()}
        return token

    moved = contracts.check_census(
        contracts.contract_for(sessions.SessionPool.step),
        contracts.take_census(copied, inplace={"state": lambda: pool.state}),
        card=True)
    if len(moved) != len(pool.state):
        raise AssertionError(f"a copied session carry went unflagged: "
                             f"{moved}")
    t1 = time.perf_counter()
    n_shims = shim_checks(torch, ops, ref, sketch_fused, gen)
    shim_s = time.perf_counter() - t1
    n_lint = len(lint.lint_tree())
    n_discard = len(discard.static_findings()) + len(
        discard.verify_decode_discard())
    if n_lint or n_discard:
        raise AssertionError(f"lint {n_lint}, discard {n_discard} "
                             f"finding(s)")
    counts = read_counts()
    print(f"launches[analysis phase]: {json.dumps(counts)}")
    for kind in ("plan", "decode"):
        if counts[kind] < 1:
            raise AssertionError(f"analysis phase launched no {kind} kernel")
    print(f"analysis: {len(contracts.registry())} entries, 0 violations on "
          f"no mesh, data_mesh(1) and 4 virtual shards ({census_s:.1f} s); "
          f"negative controls flagged ({len(flagged)} launch, {len(moved)} "
          f"in-place findings); {n_shims} shim calls == plain, one plan "
          f"launch each ({shim_s:.1f} s); lint 0, discard 0; smem caps "
          f"{json.dumps(contracts.SMEM_CAPS)} within the card's {limit} "
          f"bytes a block; {time.perf_counter() - t0:.1f} s [{card}]")


# -- the train phase: the dense LM's training half ------------------------------

TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_B, TRAIN_SEQ = 8, 1024        # 8,192 tokens a step
# 12 loop steps, a checkpoint after step 8, a failure injected at step 10:
# steps 8 and 9 replay, 14 steps run
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 12, 8, 10
TRAIN_SCHEDULE = dict(peak_lr=1e-3, warmup_steps=4, decay_steps=12)
TRAIN_TIMED = 4                     # steps timed after the loop
TRAIN_SERVE_NEW = 8                 # tokens the trained weights generate
# the smoke-size step, card against CPU: a carried state (two CPU steps
# first, so the compared update is lr * m / sqrt(v), not lr * sign(g))
SMALL_ARCH, SMALL_B, SMALL_S = "paper-tiny", 4, 64
SMALL_SCHEDULE = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10)
SMALL_TOL = dict(loss=1e-4, grad_norm=1e-4, param_atol=2e-6)
REPLAY_RTOL = 1e-4                  # a replayed step's loss, first pass


def train_flops(cfg, tokens: int, seq: int) -> float:
    """Model FLOPs a step: 6 N a token for the parameters' products
    (forward and backward) plus attention's two S x S products, 12 L H D S
    a token, counted over the whole square as it runs here (one KV chunk
    of 1024, so the causal skip leaves nothing out)."""
    attn = 12 * cfg.n_layers * cfg.n_heads * cfg.resolved_head_dim * seq
    return (6.0 * cfg.param_count() + attn) * tokens


def raw_idle(torch, fn, card: str, what: str, warm: bool = True) -> float:
    """The card's idle share over one call of ``fn`` (after a warm-up call
    unless ``warm`` is off), with the matrix products' share of its busy
    time (cuBLAS, CUTLASS and nvjet kernels by name). Traced with the
    device's activity alone and summed from the raw trace's device events:
    ``key_averages`` builds a Python object an event, which took minutes
    for the 450,000 kernels of two mamba2 training steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    acc = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            t, c = acc.get(e.name(), (0, 0))
            acc[e.name()] = (t + e.duration_ns() / 1e3, c + 1)
    rows = sorted(((t, k, c) for k, (t, c) in acc.items()), reverse=True)
    if not rows:
        raise RuntimeError(f"profile[{what}]: no device event in the trace")
    busy = sum(r[0] for r in rows) / 1e6
    gemm = sum(r[0] for r in rows if any(
        w in r[1].lower() for w in ("gemm", "xmma", "cutlass", "nvjet"))) / 1e6
    top = "; ".join(f"{k[:48]} x{c} {t / 1e3:.3f} ms" for t, k, c in rows[:6])
    print(f"profile[{what}]: wall {wall:.3f} s under the profiler (device "
          f"activity only), device busy {busy:.4f} s = {busy / wall:.4f} of "
          f"it, idle {1 - busy / wall:.4f}; matrix products {gemm:.4f} s of "
          f"the busy time; {sum(r[2] for r in rows)} device events; by "
          f"device time: {top} [{card}]")
    return 1 - busy / wall


def step_card_vs_cpu(torch, registry, tstep, optim, dev, arch=SMALL_ARCH):
    """One ``make_train_step`` step at ``arch``'s ``.smoke()`` on the card
    and on the CPU from one carried state (two CPU steps first). Returns
    the differences: loss and grad norm relative, the largest parameter
    difference, the worst leaf's update difference in norm over its
    update's norm, and each side's ``dropped_frac``."""
    cfg = registry.get_config(arch).smoke()
    sched = optim.Schedule(**SMALL_SCHEDULE)
    fn = tstep.make_train_step(cfg, sched)
    rng = np.random.default_rng(21)
    batches = [{"tokens": rng.integers(0, cfg.vocab, size=(
        SMALL_B, SMALL_S)).astype(np.int32)} for _ in range(3)]
    cpu = tstep.init_state(0, cfg, sched, device="cpu")
    for b in batches[:2]:
        cpu, _ = fn(cpu, b)
    start = [p.detach().clone() for p in cpu["params"].parameters()]
    card = tstep.init_state(0, cfg, sched, device=dev)
    tstep.load_state(card, {"params": cpu["params"].state_dict(),
                            "opt": cpu["opt"], "step": cpu["step"]})
    card, mc = fn(card, batches[2])
    cpu, mp = fn(cpu, batches[2])
    out = {k: abs(float(mc[k]) - float(mp[k])) / abs(float(mp[k]))
           for k in ("loss", "grad_norm")}
    out["params"] = out["update"] = 0.0
    for a, b, s in zip(card["params"].parameters(),
                       cpu["params"].parameters(), start):
        a, b = a.detach().cpu(), b.detach()
        out["params"] = max(out["params"], float((a - b).abs().max()))
        out["update"] = max(out["update"], float(
            torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b - s)))
    out["dropped"] = (float(mc["dropped_frac"]), float(mp["dropped_frac"]))
    return out


def train_phase(torch, card, reset_counts, read_counts):
    """Phase 13: ``train()`` on qwen1.5-0.5b (recommended) at full width
    over the port's ``DataPlane`` on the plan kernel, with a checkpoint,
    an injected failure and a restore; then the gates, the step's times,
    the card's idle share and the model FLOP share."""
    import re
    import tempfile

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataPlane, PipelineConfig
    from repro_torch.data.stats import NgramStats, StatsConfig
    from repro_torch.nn import lm
    from repro_torch.serve.engine import SamplerConfig, ServeEngine
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optim
    from repro_torch.train import step as tstep
    from repro_torch.train.fault import FailureInjector
    from repro_torch.train.loop import LoopConfig, train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_phase = time.perf_counter()

    # (f) one step at smoke size, the card against the CPU
    d = step_card_vs_cpu(torch, registry, tstep, optim, dev)
    if (d["loss"] > SMALL_TOL["loss"] or d["grad_norm"] > SMALL_TOL["grad_norm"]
            or d["params"] > SMALL_TOL["param_atol"]):
        raise AssertionError(f"train step card vs CPU: loss {d['loss']:.3e}, "
                             f"grad norm {d['grad_norm']:.3e}, params "
                             f"{d['params']:.3e} past {SMALL_TOL}")
    print(f"train[card vs cpu]: {SMALL_ARCH} .smoke(), one step from a "
          f"carried state at ({SMALL_B}, {SMALL_S}): loss {d['loss']:.3e} and "
          f"grad norm {d['grad_norm']:.3e} relative, parameters "
          f"{d['params']:.3e} absolute (tolerances {json.dumps(SMALL_TOL)})")

    cfg = registry.get_recommended_config(TRAIN_ARCH)
    pipe = PipelineConfig(seq_len=TRAIN_SEQ, batch_size=TRAIN_B,
                          vocab=cfg.vocab, dedup=True, impl="kernel",
                          device="cuda")
    sched = optim.Schedule(**TRAIN_SCHEDULE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times, lines = [], []

    def log(line: str) -> None:
        lines.append(line)
        if line.startswith("step "):
            times.append(float(re.search(r"([\d.]+) ms", line)[1]))

    split = {"card vs cpu": time.perf_counter() - t_phase}
    reset_counts()
    t0 = time.perf_counter()
    data = DataPlane(pipe)
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = train(cfg, pipe, LoopConfig(
            n_steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY, ckpt_dir=tmp,
            log_every=1, seed=0), schedule=sched,
            injector=FailureInjector(fail_at_steps=(TRAIN_FAIL_AT,)),
            log=log, data=data)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        state = res["state"]
        ckpt_bytes = dir_bytes(Path(tmp))
        # the loop's snapshot is written by a thread beside the steps: a
        # second one of the final state, written here, times a whole save
        t0 = time.perf_counter()
        ckpt.save(tstep.checkpoint_tree(state), tmp, TRAIN_STEPS)
        save_s = time.perf_counter() - t0
    split["data plane"] = build_s
    split["loop"] = loop_s
    split["save"] = save_s
    saved = [ln for ln in lines if ln.startswith("checkpoint step")]
    restored = [ln for ln in lines if ln.startswith("restored step")]
    if len(saved) != 1 or len(restored) != 1:
        raise AssertionError(f"train: snapshots {saved}, restores {restored}")
    host_s = float(re.search(r"host in ([\d.]+) s", saved[0])[1])
    restore_s, waited_s = (float(x) for x in re.search(
        r"in ([\d.]+) s \(waited ([\d.]+) s", restored[0]).groups())
    n_params = sum(p.numel() for p in state["params"].parameters())
    print(f"train: {cfg.name} recommended ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab} padded to {lm.padded_vocab(cfg)}, tied "
          f"{cfg.tie_embeddings}, {n_params} parameters, "
          f"{cfg.param_dtype} parameters, {cfg.activation_dtype} "
          f"activations, remat {cfg.remat}, {cfg.optimizer}, causal skip "
          f"{cfg.attn_causal_skip}, ce_chunk_vocab {cfg.ce_chunk_vocab}); "
          f"DataPlane ({TRAIN_B}, {TRAIN_SEQ}) dedup on the plan kernel, "
          f"{data.corpus.n_docs_kept} documents kept, "
          f"{data.corpus.n_duplicates} dropped, built in {build_s:.2f} s; "
          f"loop of {TRAIN_STEPS} steps, a checkpoint every "
          f"{TRAIN_CKPT_EVERY}, a failure at step {TRAIN_FAIL_AT}: "
          f"{len(res['history'])} steps run in {loop_s:.2f} s, restarts "
          f"{res['restarts']}")
    for line in lines:
        print(f"train[loop]: {line}")
    print(f"launches[train phase]: {json.dumps(counts)}")
    losses = res["losses"]
    # (a) finite losses, falling
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train: a loss is not finite: {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"train: the loss did not fall: {losses}")
    # (b) one restart, from the checkpoint; its replayed steps
    if res["restarts"] != 1:
        raise AssertionError(f"train: restarts {res['restarts']} != 1")
    steps = [s for s, _ in res["history"]]
    want = (list(range(TRAIN_FAIL_AT))
            + list(range(TRAIN_CKPT_EVERY, TRAIN_STEPS)))
    if steps != want:
        raise AssertionError(f"train: steps run {steps} != {want}")
    first = {s: m["loss"] for s, m in res["history"][:TRAIN_FAIL_AT]}
    replay = {s: m["loss"] for s, m in res["history"][TRAIN_FAIL_AT:]
              if s < TRAIN_FAIL_AT}
    for s, loss in replay.items():
        if abs(loss - first[s]) > REPLAY_RTOL * abs(first[s]):
            raise AssertionError(f"train: replayed step {s} loss {loss} != "
                                 f"first pass {first[s]}")
    # (c) the plan kernel ran in the phase
    if counts["plan"] < len(steps):
        raise AssertionError(f"train: {counts['plan']} plan launches for "
                             f"{len(steps)} steps")
    # (d) the data plane's statistics against a plain twin on the card
    t0 = time.perf_counter()
    twin = NgramStats(StatsConfig(impl="ref", device="cuda"))
    twin.rebind_params(data.stats.export_params())
    tw = twin.init_state()
    for s in steps:
        tw = twin.update(tw, data.corpus.batch_for_step(s))
    for k in ("hll", "cms"):
        if not torch.equal(tw[k], data.stats_state[k]):
            raise AssertionError(f"train: the data plane's {k} differs from "
                                 f"the plain twin's")
    if not np.array_equal(tw["tokens"], data.stats_state["tokens"]):
        raise AssertionError("train: token counts differ from the twin's")
    print(f"train: gates held: {len(losses)} finite losses, first "
          f"{losses[0]:.4f}, last three {np.round(losses[-3:], 4).tolist()}; "
          f"restarts 1, steps {steps}; replayed steps' losses "
          f"{json.dumps({s: [first[s], replay[s]] for s in replay})}; "
          f"{counts['plan']} plan launches; stats (HLL b=12, CountMin 4 x "
          f"2^16) bit-equal to the plain twin over the same {len(steps)} "
          f"steps; {res['telemetry']}")
    # (e) the trained weights serve on the decode kernel
    split["twin"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reset_counts()
    eng = ServeEngine(cfg, state["params"], SamplerConfig(
        temperature=0.0, no_repeat_ngram=4), impl="kernel")
    prompts = np.random.default_rng(23).integers(0, cfg.vocab, size=(2, 16))
    toks, _ = eng.generate(prompts, TRAIN_SERVE_NEW)
    serve_counts = read_counts()
    if toks.shape != (2, TRAIN_SERVE_NEW) or int(toks.max()) >= cfg.vocab \
            or int(toks.min()) < 0 or serve_counts["decode"] < TRAIN_SERVE_NEW:
        raise AssertionError(f"train-then-serve: tokens {toks.tolist()}, "
                             f"launches {serve_counts}")
    print(f"train-then-serve: {TRAIN_SERVE_NEW} greedy tokens from the "
          f"trained weights, all in vocab, {serve_counts['decode']} decode "
          f"launches: {toks.tolist()}")
    # times: the timed steps, then two under the profiler
    split["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fn = tstep.make_train_step(cfg, sched)
    timed = []
    for i in range(TRAIN_TIMED):
        batch = data.next_batch(TRAIN_STEPS + i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = fn(state, batch)
        float(m["loss"])
        timed.append((time.perf_counter() - t1) * 1e3)
    ms = float(np.median(timed))
    tokens = TRAIN_B * TRAIN_SEQ
    k = iter(range(10**6))

    def two_steps():
        nonlocal state
        for _ in range(2):
            state, m = fn(state, data.next_batch(100 + next(k)))
        float(m["loss"])

    split["timed"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    idle = raw_idle(torch, two_steps, card, "train two steps")
    split["profiled"] = time.perf_counter() - t0
    flops = train_flops(cfg, tokens, TRAIN_SEQ)
    print(f"train[step]: loop step 0 {times[0]:.1f} ms (first, with the "
          f"set-up), loop steps 1.. median {np.median(times[1:]):.1f} ms "
          f"(min {min(times[1:]):.1f}, max {max(times[1:]):.1f}); timed steps "
          f"{[round(t, 2) for t in timed]} ms, median {ms:.2f} ms, "
          f"{tokens / ms * 1e3:.0f} tokens/s; peak device memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated over the loop); "
          f"checkpoint of step {TRAIN_CKPT_EVERY}: {ckpt_bytes} bytes, "
          f"copied to the host in {host_s:.2f} s (the step's stall; a "
          f"thread writes it), restored in {restore_s:.2f} s (after "
          f"{waited_s:.2f} s waiting for the writer); a whole save of the "
          f"final state {save_s:.2f} s; idle share {idle:.4f} over two "
          f"profiled steps; "
          f"model FLOPs a step {flops:.4e} (6 N tokens {6.0 * cfg.param_count() * tokens:.4e} "
          f"+ attention), {flops / ms * 1e3 / 1e12:.1f} TFLOP/s = "
          f"{flops / ms * 1e3 / DENSE_BF16_FLOPS:.4f} of the dense bf16 peak "
          f"(989 TFLOP/s) [{card}]")
    del state, res, eng, data
    torch.cuda.empty_cache()
    split["rest"] = time.perf_counter() - t_phase - sum(split.values())
    print(f"train phase split, s: "
          f"{json.dumps({k: round(v, 2) for k, v in split.items()})} "
          f"[{card}]")
    return time.perf_counter() - t_phase, tokens / ms * 1e3


# -- phase 14: the MoE and Mamba-2 units -----------------------------------------

MAMBA_ARCH, MOE_ARCH, MOE_LAYERS = "mamba2-2.7b", "dbrx-132b", 2
# train() steps (step 0 warms up), then two profiled steps on the state
MM_STEPS = {MAMBA_ARCH: 2, MOE_ARCH: 3}
MM_BATCH = {MAMBA_ARCH: (8, 1024), MOE_ARCH: (16, 1024)}
MM_SCHEDULE = dict(peak_lr=1e-4, warmup_steps=2, decay_steps=8)
MM_CHECK_P, MM_CHECK_S = 16, 24                  # prefill 16, decode to 24
MM_CHECK_TOL = 2e-2                              # the reference's own
MM_SMOKE = ("dbrx-132b", "kimi-k2-1t-a32b", "mamba2-2.7b",
            "jamba-1.5-large-398b")
# a smoke step's parameter update, each leaf in norm against the CPU's:
# routed gradients leave elements near 0 whose m / sqrt(v) has no
# relative bound, so phase 13's per-element 2e-6 does not carry over
MM_UPDATE_RTOL = 1e-3


def moe_train_flops(cfg, tokens: int, seq: int) -> float:
    """Model FLOPs a step: 6 N_active a token (the routed experts' share
    only: ``param_count(active_only=True)``) plus attention's 12 L H D S
    over its layers. The SSD's own products are not counted, as 6 N
    does not count attention's."""
    n_attn = sum(s.kind == "attn" for s in cfg.layer_specs())
    attn = 12 * n_attn * cfg.n_heads * cfg.resolved_head_dim * seq
    return (6.0 * cfg.param_count(active_only=True) + attn) * tokens


def mm_serve(torch, cfg, params, card, reset_counts, read_counts):
    """Gates (a) and (c)'s serve: ``ServeEngine.generate`` at phase 8's
    settings on ``params`` (16 prompts x 128, 64 new, greedy twice and
    sampled, no-repeat 4-grams in 2^14-bit filters with k = 2, the 2^20-bit
    canary with k = 4, four rows planted with a canary gram's head); then
    the decode kernel at the path's shape on a primed pool's real state,
    bit-equal to its plain version and timed beside it and its bound; the
    split of a decode step; the card's idle share. Returns a dict of the
    numbers."""
    from repro_torch.core import sketches, u32
    from repro_torch.kernels import decode, ref
    from repro_torch.nn import lm
    from repro_torch.serve import sessions
    from repro_torch.serve.engine import (NoRepeatNgram, SamplerConfig,
                                          ServeEngine)

    dev = torch.device("cuda")
    V = lm.padded_vocab(cfg)
    scfg = SamplerConfig(temperature=0.0, no_repeat_ngram=SERVE_N,
                         bloom_log2_m=14, bloom_k=2, hash_bits=32,
                         canary_log2_m=20, canary_k=4, seed=0)
    nrn = NoRepeatNgram(cfg, scfg, dev)
    spec = dataclasses.replace(
        nrn.spec, canary_log2_m=scfg.canary_log2_m, canary_k=scfg.canary_k)
    rng = np.random.default_rng(31)
    grams = rng.integers(0, cfg.vocab, size=(CANARY_GRAMS, SERVE_N))
    cbits = canary_filter(torch, u32, ref, sketches, spec, nrn.h1,
                          torch.from_numpy(grams).to(dev))
    prompts = rng.integers(0, cfg.vocab, size=(SERVE_B, SERVE_P))
    planted = rng.choice(SERVE_B, PLANTED_ROWS, replace=False)
    for j, r in enumerate(planted):
        prompts[r, -(SERVE_N - 1):] = grams[j, : SERVE_N - 1]
    prompts = prompts.astype(np.int32)
    engine = lambda **kw: ServeEngine(cfg, params, dataclasses.replace(
        scfg, **kw), impl="kernel", canary_bits=cbits)
    eng = engine()
    eng.generate(prompts[:2, :8], 2)            # first call: cuBLAS set-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    toks, stats = eng.generate(prompts, SERVE_NEW)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    counts = read_counts()
    again, _ = engine().generate(prompts, SERVE_NEW)
    stoks, sstats = engine(temperature=0.8, top_k=50).generate(prompts,
                                                               SERVE_NEW)
    bad = (repeated_completions(prompts, toks, SERVE_N)
           + repeated_completions(prompts, stoks, SERVE_N))
    if counts["decode"] != SERVE_NEW:
        raise AssertionError(f"{cfg.name} serve: {counts['decode']} decode "
                             f"launches for {SERVE_NEW} steps")
    if bad:
        raise AssertionError(f"{cfg.name} serve: {bad} generated tokens "
                             f"complete a repeated {SERVE_N}-gram")
    if not np.array_equal(toks, again):
        raise AssertionError(f"{cfg.name} serve: a second greedy run gave "
                             f"other tokens")
    for t in (toks, stoks):
        if t.shape != (SERVE_B, SERVE_NEW) or t.min() < 0 \
                or t.max() >= cfg.vocab:
            raise AssertionError(f"{cfg.name} serve: tokens out of vocab")
    tele = stats["telemetry"]
    if tele["canary_hits"] < PLANTED_ROWS:
        raise AssertionError(f"{cfg.name} serve: {tele['canary_hits']} "
                             f"canary hits for {PLANTED_ROWS} planted rows")
    print(f"moe_mamba[{cfg.name} serve]: greedy {SERVE_B} x {SERVE_NEW} "
          f"after {SERVE_P}-token prompts in {t_gen:.4f} s = "
          f"{SERVE_B * SERVE_NEW / t_gen:.1f} generated tokens/s; a second "
          f"greedy run gives the same tokens; sampled (0.8, top-k 50) banned "
          f"{sstats['banned_candidates']}; no generated token completes a "
          f"repeated {SERVE_N}-gram; {counts['decode']} decode launches; "
          f"telemetry {json.dumps(tele)} [{card}]")

    # the decode kernel at the path's shape, on a primed pool's state; the
    # split of a step between the model and the pool
    warm, split_steps, prof_steps = 2, 12, 4
    logits, caches = lm.prefill(params, cfg, prompts, SERVE_P + warm
                                + split_steps + 2 * prof_steps)
    pool = sessions.SessionPool(eng.decode_spec, SERVE_B, eng.nrn.h1,
                                canary_bits=eng.canary_bits, device=dev)
    pool.admit(SERVE_B)
    pool.prime(prompts)
    t_lm = t_pool = 0.0
    state = {"logits": logits, "caches": caches}

    def one_step(timed=False):
        nonlocal t_lm, t_pool
        lg = lm.mask_pad_logits(cfg, state["logits"].float())
        if timed:
            torch.cuda.synchronize()
            a = time.perf_counter()
        tok = pool.step(lg, temperature=0.0)
        if timed:
            torch.cuda.synchronize()
            b = time.perf_counter()
        state["logits"], state["caches"] = lm.decode_step(
            params, cfg, tok[:, None], state["caches"])
        if timed:
            torch.cuda.synchronize()
            t_pool += b - a
            t_lm += time.perf_counter() - b

    for _ in range(warm):
        one_step()
    for _ in range(split_steps):
        one_step(timed=True)
    idle = raw_idle(torch, lambda: [one_step() for _ in range(prof_steps)],
                    card, f"{cfg.name} decode, {prof_steps} steps")
    st = pool.state
    ready = (st["count"] >= spec.n - 1) & (st["active"] != 0)
    lg = lm.mask_pad_logits(cfg, state["logits"].float())
    args = tuple(a.contiguous() for a in (lg, st["prefix"], ready,
                                          st["bloom"], pool.h1))
    kern = lambda: decode.decode_masks_fused(*args, spec=spec,
                                             canary_bits=cbits)
    plain = lambda: ref.decode_masks_ref(
        *args, n=spec.n, L=spec.L, hash_mask=spec.hash_mask,
        log2_m=spec.log2_m, k=spec.k, canary_bits=cbits,
        canary_log2_m=spec.canary_log2_m, canary_k=spec.canary_k)
    got, want = kern(), plain()
    for key in want:
        if not same_bits(torch, got[key], want[key]):
            raise AssertionError(f"decode at ({SERVE_B}, {V}): kernel {key} "
                                 f"!= plain version's")
    ms, plain_ms, kh, (k1, k2, p1, p2) = in_turns(torch, kern, plain,
                                                  k_iters=200, p_iters=5)
    pb, pc = probes_until_miss(torch, ref, u32, spec, *args[1:],
                               canary_bits=cbits)
    b_ms, by, text = decode_bound(spec, SERVE_B, V, pb, pc)
    print(f"kernel[decode_masks] ({SERVE_B}, {V}) on {cfg.name}'s primed "
          f"pool: kernel == plain version (logits, banned and canary words); "
          f"{ms:.5f} ms per launch ({k1:.5f}, {k2:.5f}); plain version "
          f"{plain_ms:.5f} ms ({p1:.5f}, {p2:.5f}); bound {b_ms:.5f} ms by "
          f"{by} ({text}); bound / time {b_ms / ms:.3f} [{card}]")
    print(f"moe_mamba[{cfg.name} decode step]: lm.decode_step "
          f"{t_lm / split_steps * 1e3:.4f} ms, SessionPool.step "
          f"{t_pool / split_steps * 1e3:.4f} ms (mean of {split_steps}, host "
          f"clock with a synchronise around each part); card idle "
          f"{idle:.4f} over {prof_steps} profiled steps [{card}]")
    del pool, state, caches, logits
    return {"serve_tokens_s": SERVE_B * SERVE_NEW / t_gen,
            "decode": counts["decode"],
            "lm_ms": t_lm / split_steps * 1e3,
            "pool_ms": t_pool / split_steps * 1e3, "idle": idle,
            "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms}


def mm_decode_check(torch, cfg, params, card):
    """Gates (b) and (c)'s check: float32 activations and caches, one
    prompt of 24 tokens: prefill of 16 then 8 decode steps give the
    training forward's logits within 2e-2 and the same argmax (the
    reference's tests/test_models.py check)."""
    from repro_torch.nn import lm
    cfg = dataclasses.replace(cfg, activation_dtype="float32")
    toks = torch.from_numpy(np.random.default_rng(33).integers(
        0, cfg.vocab, size=(1, MM_CHECK_S))).cuda()
    with torch.no_grad():
        full, aux = lm.forward(params, cfg, toks)
    full = lm.mask_pad_logits(cfg, full.float()[0])
    last, caches = lm.prefill(params, cfg, toks[:, :MM_CHECK_P],
                              max_len=MM_CHECK_S, cache_dtype=torch.float32)
    outs = [last]
    for t in range(MM_CHECK_P, MM_CHECK_S):
        step_logits, caches = lm.decode_step(params, cfg, toks[:, t:t + 1],
                                             caches)
        outs.append(step_logits)
    worst = 0.0
    for i, got in enumerate(outs[:-1]):
        got = lm.mask_pad_logits(cfg, got.float())[0]
        want = full[MM_CHECK_P - 1 + i]
        err = float(((got - want).abs() - MM_CHECK_TOL * want.abs()).max())
        worst = max(worst, float((got - want).abs().max()))
        if err > MM_CHECK_TOL or int(got.argmax()) != int(want.argmax()):
            raise AssertionError(f"{cfg.name}: decode step {i} differs from "
                                 f"the forward (max |diff| "
                                 f"{float((got - want).abs().max()):.4e}, "
                                 f"argmax {int(got.argmax())} vs "
                                 f"{int(want.argmax())})")
    print(f"moe_mamba[{cfg.name} prefill + decode == forward]: float32 "
          f"activations and caches, prefill {MM_CHECK_P} then "
          f"{MM_CHECK_S - MM_CHECK_P} decode steps: max |logit diff| "
          f"{worst:.4e} (tolerance rtol/atol {MM_CHECK_TOL}), every argmax "
          f"equal; forward aux {[round(float(a), 6) for a in aux]} "
          f"(capacity factor {cfg.capacity_factor}) [{card}]")


def mm_train(torch, cfg, card, reset_counts, read_counts):
    """Gates (d) and (e): ``train()`` over the port's ``DataPlane`` on the
    plan kernel, no checkpoint; then two steps timed under the profiler,
    whose state must keep its storage. Returns a dict of the numbers."""
    import re
    import tempfile

    from repro_torch.data.pipeline import DataPlane, PipelineConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.train import optim
    from repro_torch.train import step as tstep
    from repro_torch.train.loop import LoopConfig, train

    B, S = MM_BATCH[cfg.name]
    n_steps = MM_STEPS[cfg.name]
    pipe = PipelineConfig(seq_len=S, batch_size=B, vocab=cfg.vocab,
                          dedup=True, impl="kernel", device="cuda")
    sched = optim.Schedule(**MM_SCHEDULE)
    t0 = time.perf_counter()
    data = DataPlane(pipe)
    build_s = time.perf_counter() - t0
    lines = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = train(cfg, pipe, LoopConfig(
            n_steps=n_steps, ckpt_every=10**9, ckpt_dir=tmp, log_every=1,
            seed=0, num_microbatches=cfg.num_microbatches), schedule=sched,
            log=lines.append, data=data)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    for line in lines:
        print(f"moe_mamba[{cfg.name} train loop]: {line}")
    steps = [ln for ln in lines if ln.startswith("step ")]
    ms = [float(re.search(r"([\d.]+) ms", ln)[1]) for ln in steps]
    gnorms = [float(re.search(r"gnorm +([-\d.e+naif]+)", ln)[1])
              for ln in steps]
    losses = res["losses"]
    if len(losses) != n_steps or not (np.isfinite(losses).all()
                                      and np.isfinite(gnorms).all()):
        raise AssertionError(f"{cfg.name} train: losses {losses}, grad "
                             f"norms {gnorms}")
    # one stats launch (HLL + CountMin) a step, on the plan kernel
    if counts["plan"] != n_steps or counts["HLLSpec"] != n_steps \
            or counts["CountMinSpec"] != n_steps:
        raise AssertionError(f"{cfg.name} train: launches {counts} for "
                             f"{n_steps} steps")
    state = res["state"]
    fn = tstep.make_train_step(cfg, sched,
                               num_microbatches=cfg.num_microbatches)
    k = iter(range(10**6))
    before = launch_train.storage_pointers(state)

    profiled_m = []

    def two_steps():
        nonlocal state
        for _ in range(2):
            state, m = fn(state, data.next_batch(100 + next(k)))
            profiled_m.append(m)
        float(m["loss"])

    # the loop has warmed the step up: no third warm-up pair
    idle = raw_idle(torch, two_steps, card, f"{cfg.name} train two steps",
                    warm=False)
    more = [(float(m["loss"]), float(m["grad_norm"])) for m in profiled_m]
    if not np.isfinite(more).all():
        raise AssertionError(f"{cfg.name} train: profiled steps' (loss, "
                             f"grad norm) {more}")
    lost = launch_train.moved(before, state)
    if lost:
        raise AssertionError(f"{cfg.name} train: {len(lost)} state tensors "
                             f"changed storage, e.g. {lost[0]}")
    tokens = B * S
    step_ms = float(np.median(ms[1:]))
    flops = moe_train_flops(cfg, tokens, S)
    n_params = sum(p.numel() for p in state["params"].parameters())
    print(f"moe_mamba[{cfg.name} train]: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {n_params} parameters ({cfg.param_count(True)} "
          f"active), remat {cfg.remat}, {cfg.num_microbatches} microbatches, "
          f"{cfg.optimizer}, dispatch {cfg.moe_dispatch}; DataPlane ({B}, "
          f"{S}) built in {build_s:.2f} s; {n_steps} steps in {loop_s:.2f} s,"
          f" step 0 {ms[0]:.1f} ms, steps 1.. median {step_ms:.1f} ms = "
          f"{tokens / step_ms * 1e3:.0f} tokens/s; launches {json.dumps(counts)}"
          f"; peak device memory {peak / 2**30:.2f} GiB over the loop; two "
          f"more steps, (loss, grad norm) {more}, every state tensor kept "
          f"its storage over them; idle share "
          f"{idle:.4f} over those two profiled steps; model FLOPs a step "
          f"{flops:.4e} (6 N_active tokens + attention), "
          f"{flops / step_ms * 1e3 / 1e12:.1f} TFLOP/s = "
          f"{flops / step_ms * 1e3 / DENSE_BF16_FLOPS:.4f} of the dense bf16 "
          f"peak (989 TFLOP/s) [{card}]")
    del state, res, data
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "train_tokens_s": tokens / step_ms * 1e3,
            "train_idle": idle, "peak_gib": peak / 2**30,
            "plan": counts["plan"]}


def moe_mamba_phase(torch, card, reset_counts, read_counts):
    """Phase 14: mamba2-2.7b at its published widths and depth and
    dbrx-132b at its published widths with two layers, each served
    (``ServeEngine.generate``) and trained (``train()``), with the gates
    (a)-(f) of docstring item 14."""
    from repro_torch.configs import registry
    from repro_torch.nn import lm
    from repro_torch.train import optim
    from repro_torch.train import step as tstep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    split, out = {}, {}
    models = ((MAMBA_ARCH, registry.get_config(MAMBA_ARCH)),
              (MOE_ARCH, dataclasses.replace(registry.get_config(MOE_ARCH),
                                             n_layers=MOE_LAYERS)))
    for arch, cfg in models:
        # (a) / (c): serve, then (b) / (c): prefill + decode == forward
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = lm.init(0, cfg, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in params.parameters())
        print(f"moe_mamba[{arch} model]: {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, vocab {cfg.vocab} padded to "
              f"{lm.padded_vocab(cfg)}, {n_params} random {cfg.param_dtype} "
              f"parameters from seed 0 in {init_s:.2f} s; TF32 off")
        out[arch] = mm_serve(torch, cfg, params, card, reset_counts,
                             read_counts)
        if cfg.n_experts:
            prompts = torch.from_numpy(np.random.default_rng(31).integers(
                0, cfg.vocab, size=(SERVE_B, SERVE_P))).to(dev)
            with torch.no_grad():
                _, aux = lm.forward(params, cfg, prompts)
            print(f"moe_mamba[{arch} prefill aux]: ({SERVE_B}, {SERVE_P}) "
                  f"prompts, {cfg.moe_dispatch} dispatch at the published "
                  f"capacity factor {cfg.capacity_factor}: load_balance "
                  f"{float(aux[0]):.6f}, dropped_frac {float(aux[1]):.6f}")
            check = dataclasses.replace(cfg, capacity_factor=16.0)
        else:
            check = cfg
        mm_decode_check(torch, check, params, card)
        out[arch]["serve_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del params
        torch.cuda.empty_cache()
        split[f"{arch} serve"] = time.perf_counter() - t0
        print(f"moe_mamba[{arch} serve phase]: {split[f'{arch} serve']:.1f} "
              f"s, peak {out[arch]['serve_peak_gib']:.2f} GiB", flush=True)
        # (d) / (e): train
        t0 = time.perf_counter()
        tcfg = registry.get_recommended_config(arch)
        if arch == MOE_ARCH:
            tcfg = dataclasses.replace(tcfg, n_layers=MOE_LAYERS)
        out[arch].update(mm_train(torch, tcfg, card, reset_counts,
                                  read_counts))
        split[f"{arch} train"] = time.perf_counter() - t0
        print(f"moe_mamba[{arch} train phase]: {split[f'{arch} train']:.1f} "
              f"s", flush=True)
    # (f) the card against the CPU at smoke size
    t0 = time.perf_counter()
    for arch in MM_SMOKE:
        d = step_card_vs_cpu(torch, registry, tstep, optim, dev, arch)
        if (d["loss"] > SMALL_TOL["loss"]
                or d["grad_norm"] > SMALL_TOL["grad_norm"]
                or d["update"] > MM_UPDATE_RTOL
                or d["dropped"][0] != d["dropped"][1]):
            raise AssertionError(f"gate (f) {arch}: {d}")
        print(f"moe_mamba[{arch} .smoke() card vs cpu]: one step from a "
              f"carried state at ({SMALL_B}, {SMALL_S}): loss "
              f"{d['loss']:.3e} and grad norm {d['grad_norm']:.3e} relative "
              f"(tolerance 1e-4), parameters {d['params']:.3e} absolute, "
              f"worst leaf update {d['update']:.3e} of its norm (tolerance "
              f"{MM_UPDATE_RTOL}), dropped_frac {d['dropped'][0]} on both")
    split["card vs cpu"] = time.perf_counter() - t0
    print(f"launches[moe_mamba phase]: " + json.dumps(
        {a: {"decode": o["decode"], "plan": o["plan"]}
         for a, o in out.items()}))
    print(f"moe_mamba summary: " + json.dumps(
        {a: {k: round(v, 5) if isinstance(v, float) else v
             for k, v in o.items()} for a, o in out.items()})
          + f" [{card}]")
    print(f"moe_mamba phase split, s: "
          f"{json.dumps({k: round(v, 2) for k, v in split.items()})} "
          f"[{card}]")
    return time.perf_counter() - t_phase


# -- phase 15: the model mesh -----------------------------------------------------

MESH_ARCH = "qwen1.5-0.5b"
MESH_STEP_B, MESH_STEP_S = 8, 512           # gate (a): 4,096 tokens a step
MESH_TRAIN_B, MESH_TRAIN_S, MESH_TRAIN_STEPS = 8, 1024, 4     # gate (b)
MESH_TOL = dict(loss=1e-4, grad_norm=1e-4, rtol=2e-3, atol=2e-4)
MESH_UPDATE_RTOL = 1e-3                     # gate (e), as phase 14's (f)
MESH_MOE_B, MESH_MOE_S = 4, 1024            # gate (d)
MESH_MOE_LOSS_ATOL = 1e-3
MESH_MAMBA_LAYERS = 4                       # gate (e): 4 of mamba2's 64
MESH_MAMBA_B, MESH_MAMBA_S = 4, 512


def mesh_shard_bytes(sp) -> tuple:
    """(least, most) parameter bytes a mesh position holds."""
    per = []
    for pos in sp.mesh.positions():
        per.append(sum(leaf.shards[leaf.coord(pos)].numel()
                       * leaf.shards[leaf.coord(pos)].element_size()
                       for leaf in sp.leaves.values()))
    return min(per), max(per)


def mesh_coll_text(counts) -> str:
    return json.dumps({k: {"calls": v["calls"], "bytes": v["bytes"]}
                       for k, v in sorted(counts.items())})


def mesh_step_gate(torch, cfg, mesh, B, S, what, card, update_rtol=None):
    """One ``make_train_step`` step on ``mesh`` and on one device from one
    carried state (two one-device steps first); the gate's tolerances,
    each shard keeping its storage; then one more step each, timed.
    Returns the numbers."""
    from repro_torch.launch import train as launch_train
    from repro_torch.nn import collectives
    from repro_torch.train import optim
    from repro_torch.train import step as tstep
    sched = optim.Schedule(**SMALL_SCHEDULE)
    fn = tstep.make_train_step(cfg, sched)
    rng = np.random.default_rng(41)
    batches = [{"tokens": rng.integers(0, cfg.vocab, size=(B, S)).astype(
        np.int32)} for _ in range(4)]
    one = tstep.init_state(0, cfg, sched, device="cuda")
    for b in batches[:2]:
        one, _ = fn(one, b)
    start = {n: p.detach().clone() for n, p in one["params"].named_parameters()}
    sharded = tstep.shard_state(one, cfg, mesh, sched)
    before = launch_train.storage_pointers(sharded)
    torch.cuda.reset_peak_memory_stats()
    collectives.reset_collectives()
    sharded, ms = fn(sharded, batches[2])
    coll = collectives.collective_count()
    one, m1 = fn(one, batches[2])
    lost = launch_train.moved(before, sharded)
    if lost:
        raise AssertionError(f"mesh[{what}]: {len(lost)} shards changed "
                             f"storage, e.g. {lost[0]}")
    d = {k: abs(float(ms[k]) - float(m1[k])) / abs(float(m1[k]))
         for k in ("loss", "grad_norm")}
    full = sharded["params"].full()
    worst_p = worst_u = 0.0
    for n, p in one["params"].named_parameters():
        a, b = full[n].float(), p.detach().float()
        excess = float(((a - b).abs() - MESH_TOL["rtol"] * b.abs()).max())
        worst_p = max(worst_p, excess)
        upd = b - start[n].float()
        worst_u = max(worst_u, float(torch.linalg.vector_norm(a - b) / max(
            float(torch.linalg.vector_norm(upd)), 1e-30)))
    del full
    if (d["loss"] > MESH_TOL["loss"] or d["grad_norm"] > MESH_TOL["grad_norm"]
            or (update_rtol is None and worst_p > MESH_TOL["atol"])
            or (update_rtol is not None and worst_u > update_rtol)):
        raise AssertionError(f"mesh[{what}]: loss {d['loss']:.3e}, grad norm "
                             f"{d['grad_norm']:.3e} relative, parameters "
                             f"{worst_p:.3e} past rtol {MESH_TOL['rtol']}, "
                             f"worst leaf update {worst_u:.3e}")
    times = {}
    for name, st in (("mesh", sharded), ("one device", one)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = fn(st, batches[3])
        float(m["loss"])
        times[name] = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    lo, hi = mesh_shard_bytes(sharded["params"])
    print(f"mesh[{what}]: {cfg.name} {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.param_dtype} parameters, "
          f"{cfg.activation_dtype} activations, TF32 off, ({B}, {S}), mesh "
          f"{mesh.shape}: one step from a carried state (two one-device "
          f"steps in): loss {float(ms['loss']):.6f} vs {float(m1['loss']):.6f}"
          f" ({d['loss']:.3e} relative), grad norm {d['grad_norm']:.3e} "
          f"relative, parameters {max(worst_p, 0.0):.3e} past rtol "
          f"{MESH_TOL['rtol']} (atol {MESH_TOL['atol']}), worst leaf update "
          f"{worst_u:.3e} of its norm; every shard kept its storage; next "
          f"step {times['mesh']:.1f} ms on the mesh vs "
          f"{times['one device']:.1f} ms on one device "
          f"({B * S / times['mesh'] * 1e3:.0f} vs "
          f"{B * S / times['one device'] * 1e3:.0f} tokens/s); collectives "
          f"of the gated step {mesh_coll_text(coll)}; parameter bytes a "
          f"position {lo}-{hi}; peak device memory {peak / 2**30:.2f} GiB "
          f"[{card}]")
    del sharded, one
    torch.cuda.empty_cache()
    return {"mesh_ms": times["mesh"], "one_ms": times["one device"]}


def mesh_train_gate(torch, card, reset_counts, read_counts, mesh):
    """Gate (b): ``train()`` on the mesh over the ``DataPlane`` on the plan
    kernel, the stats against a plain twin, two profiled steps that keep
    every shard's storage, a checkpoint saved on the mesh restored on
    (4, 1) and on one device."""
    import tempfile

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataPlane, PipelineConfig
    from repro_torch.data.stats import NgramStats, StatsConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.nn import collectives
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optim
    from repro_torch.train import step as tstep
    from repro_torch.train.loop import LoopConfig, train

    cfg = registry.get_recommended_config(MESH_ARCH)
    B, S, n = MESH_TRAIN_B, MESH_TRAIN_S, MESH_TRAIN_STEPS
    pipe = PipelineConfig(seq_len=S, batch_size=B, vocab=cfg.vocab,
                          dedup=True, impl="kernel", device="cuda")
    sched = optim.Schedule(**TRAIN_SCHEDULE)
    data = DataPlane(pipe)
    lines = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = train(cfg, pipe, LoopConfig(n_steps=n, ckpt_every=10**9,
                                          ckpt_dir=tmp, log_every=1, seed=0),
                    schedule=sched, log=lines.append, data=data, mesh=mesh)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    counts = read_counts()
    for line in lines:
        print(f"mesh[train loop]: {line}")
    losses = res["losses"]
    if len(losses) != n or not np.isfinite(losses).all():
        raise AssertionError(f"mesh train: losses {losses}")
    if counts["plan"] < n:
        raise AssertionError(f"mesh train: {counts['plan']} plan launches "
                             f"for {n} steps")
    twin = NgramStats(StatsConfig(impl="ref", device="cuda"))
    twin.rebind_params(data.stats.export_params())
    tw = twin.init_state()
    for s in range(n):
        tw = twin.update(tw, data.corpus.batch_for_step(s))
    for k in ("hll", "cms"):
        if not torch.equal(tw[k], data.stats_state[k]):
            raise AssertionError(f"mesh train: the data plane's {k} differs "
                                 f"from the plain twin's")
    state = res["state"]
    fn = tstep.make_train_step(cfg, sched)
    before = launch_train.storage_pointers(state)
    k = iter(range(10**6))

    def two_steps():
        nonlocal state
        for _ in range(2):
            state, m = fn(state, data.next_batch(100 + next(k)))
        float(m["loss"])

    collectives.reset_collectives()
    t0 = time.perf_counter()
    two_steps()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 2
    coll = {kind: {key: v // 2 for key, v in c.items()}
            for kind, c in collectives.collective_count().items()}
    idle = raw_idle(torch, two_steps, card, "mesh train two steps",
                    warm=False)
    lost = launch_train.moved(before, state)
    if lost:
        raise AssertionError(f"mesh train: {len(lost)} shards changed "
                             f"storage, e.g. {lost[0]}")
    peak = torch.cuda.max_memory_allocated()
    lo, hi = mesh_shard_bytes(state["params"])
    # a checkpoint saved on the mesh restores on (4, 1) and on one device
    t0 = time.perf_counter()
    tree = tstep.checkpoint_tree(state)
    flat = ckpt.flatten_with_path(tree)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt.save(tree, tmp, 1)
        del state, res
        torch.cuda.empty_cache()
        for where in ((4, 1), None):
            other = (tstep.init_state(1, cfg, sched,
                                      mesh=make_debug_mesh(*where))
                     if where else tstep.init_state(1, cfg, sched))
            tstep.restore_state(other, tmp)
            got = dict(ckpt.flatten_with_path(tstep.checkpoint_tree(other)))
            for path, t in flat:
                if not torch.equal(torch.as_tensor(got[path]).cuda(),
                                   torch.as_tensor(t).cuda()):
                    raise AssertionError(f"mesh train: restored on {where} "
                                         f"leaf {path} differs")
            del other, got
            torch.cuda.empty_cache()
    ckpt_s = time.perf_counter() - t0
    print(f"mesh[train]: {cfg.name} recommended ({cfg.param_dtype} "
          f"parameters, remat {cfg.remat}, ce_chunk_vocab "
          f"{cfg.ce_chunk_vocab}) on mesh {mesh.shape}, train() over the "
          f"DataPlane ({B}, {S}) on the plan kernel: {n} steps in "
          f"{loop_s:.2f} s, losses {np.round(losses, 4).tolist()}, launches "
          f"{json.dumps(counts)}; stats bit-equal to the plain twin; two "
          f"more steps {step_ms:.1f} ms a step = {B * S / step_ms * 1e3:.0f} "
          f"tokens/s, every shard kept its storage, idle share {idle:.4f} "
          f"over two profiled steps; collectives a step "
          f"{mesh_coll_text(coll)}; parameter bytes a position {lo}-{hi}; "
          f"peak device memory {peak / 2**30:.2f} GiB; the checkpoint saved "
          f"on {mesh.shape} restored on (4, 1) and on one device to the same "
          f"tree ({len(flat)} leaves) in {ckpt_s:.1f} s [{card}]")
    return {"plan": counts["plan"], "train_ms": step_ms,
            "train_tokens_s": B * S / step_ms * 1e3, "idle": idle,
            "peak_gib": peak / 2**30, "collectives": coll}


def mesh_decode_gate(torch, cfg, params, mesh, card):
    """Prefill 16 tokens then 8 decode steps on the mesh at float32: the
    one-device forward's logits within 2e-2 and the same argmax."""
    from repro_torch.nn import lm
    toks = torch.from_numpy(np.random.default_rng(43).integers(
        0, cfg.vocab, size=(2, MM_CHECK_S))).cuda()
    with torch.no_grad():
        full, _ = lm.forward(params, cfg, toks)
    full = lm.mask_pad_logits(cfg, full.float())
    sp = lm.shard(params, cfg, mesh)
    last, caches = lm.prefill(sp, cfg, toks[:, :MM_CHECK_P],
                              max_len=MM_CHECK_S, cache_dtype=torch.float32)
    outs = [last]
    t0 = time.perf_counter()
    for t in range(MM_CHECK_P, MM_CHECK_S):
        step_logits, caches = lm.decode_step(sp, cfg, toks[:, t:t + 1],
                                             caches)
        outs.append(step_logits)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (MM_CHECK_S - MM_CHECK_P)
    worst = 0.0
    for i, got in enumerate(outs[:-1]):
        got = lm.mask_pad_logits(cfg, got.float())
        want = full[:, MM_CHECK_P - 1 + i]
        excess = float(((got - want).abs() - MM_CHECK_TOL * want.abs()).max())
        worst = max(worst, float((got - want).abs().max()))
        if excess > MM_CHECK_TOL or not torch.equal(got.argmax(-1),
                                                   want.argmax(-1)):
            raise AssertionError(f"mesh[serve {mesh.shape}]: decode step {i} "
                                 f"differs from the forward (max |diff| "
                                 f"{float((got - want).abs().max()):.4e})")
    kv = caches[0]["u0"].k
    leaf = sp.leaves["blocks.0.u0.ffn.w_in.w"]
    vocab = sp.leaves["embed.table"]
    print(f"mesh[serve {mesh.shape}]: {cfg.name} float32, prefill "
          f"{MM_CHECK_P} then {MM_CHECK_S - MM_CHECK_P} decode steps: max "
          f"|logit diff| {worst:.4e} from the one-device forward (tolerance "
          f"rtol/atol {MM_CHECK_TOL}), every argmax equal; KV cache spec "
          f"{tuple(kv.spec)} ({'sequence' if kv.spec.axes(1) else 'kv heads'}"
          f" over model), w_in spec {tuple(leaf.spec)}, embed spec "
          f"{tuple(vocab.spec)}; {step_ms:.1f} ms a decode step [{card}]")
    return sp


def mesh_phase(torch, card, reset_counts, read_counts):
    """Phase 15: the model mesh, gates (a)-(e) of docstring item 15."""
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.nn import collectives, lm
    from repro_torch.serve.engine import SamplerConfig, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    split, out = {}, {}
    mesh22 = make_debug_mesh(2, 2)
    f32 = dict(param_dtype="float32", activation_dtype="float32")
    # (a) qwen float32, one step on (2, 2) against one device
    t0 = time.perf_counter()
    cfg = dataclasses.replace(registry.get_config(MESH_ARCH), **f32)
    out["qwen step"] = mesh_step_gate(torch, cfg, mesh22, MESH_STEP_B,
                                      MESH_STEP_S, "a: qwen step", card)
    split["a"] = time.perf_counter() - t0
    # (b) qwen recommended through train() on (2, 2)
    t0 = time.perf_counter()
    out["qwen train"] = mesh_train_gate(torch, card, reset_counts,
                                        read_counts, mesh22)
    split["b"] = time.perf_counter() - t0
    # (c) qwen serve on (2, 2) and (1, 3), then generate on (2, 2)
    t0 = time.perf_counter()
    cfg = dataclasses.replace(registry.get_config(MESH_ARCH), **f32)
    params = lm.init(0, cfg, device="cuda")
    sp13 = mesh_decode_gate(torch, cfg, params, make_debug_mesh(1, 3), card)
    del sp13
    sp = mesh_decode_gate(torch, cfg, params, mesh22, card)
    del params
    torch.cuda.empty_cache()
    rng = np.random.default_rng(44)
    prompts = rng.integers(0, cfg.vocab, size=(SERVE_B, SERVE_P))
    eng = ServeEngine(cfg, sp, SamplerConfig(temperature=0.0,
                                             no_repeat_ngram=SERVE_N),
                      impl="kernel")
    eng.generate(prompts[:2, :8], 2)            # first call: set-up
    reset_counts()
    collectives.reset_collectives()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    toks, _ = eng.generate(prompts, SERVE_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t1
    counts = read_counts()
    coll = collectives.collective_count()
    bad = repeated_completions(prompts, toks, SERVE_N)
    if counts["decode"] != SERVE_NEW or bad or toks.shape != (SERVE_B,
                                                              SERVE_NEW):
        raise AssertionError(f"mesh serve: {counts['decode']} decode "
                             f"launches, {bad} banned {SERVE_N}-grams, "
                             f"tokens {toks.shape}")
    idle = raw_idle(torch, lambda: eng.generate(prompts[:, :32], 8), card,
                    "mesh serve generate")
    print(f"mesh[serve generate]: {cfg.name} float32 on {mesh22.shape}, "
          f"ServeEngine.generate {SERVE_B} prompts x {SERVE_P}, "
          f"{SERVE_NEW} new, greedy, no-repeat {SERVE_N}-grams: "
          f"{counts['decode']} decode launches, no banned {SERVE_N}-gram "
          f"emitted, {gen_s:.2f} s = {SERVE_B * SERVE_NEW / gen_s:.1f} "
          f"generated tokens/s; collectives {mesh_coll_text(coll)}; idle "
          f"share {idle:.4f} over a short generate [{card}]")
    out["serve"] = {"decode": counts["decode"],
                    "tokens_s": SERVE_B * SERVE_NEW / gen_s, "idle": idle}
    del eng, sp
    torch.cuda.empty_cache()
    split["c"] = time.perf_counter() - t0
    # (d) dbrx, 2 layers, bf16 parameters: the loss at capacity factor 1.25
    # on (2, 2), with float32 activations (gated: the same dropped count)
    # and bf16 ones (gated: the loss; the dropped count printed)
    t0 = time.perf_counter()
    base = dataclasses.replace(registry.get_config(MOE_ARCH),
                               n_layers=MOE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params = lm.init(0, base, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(45).integers(
        0, base.vocab, size=(MESH_MOE_B, MESH_MOE_S))).cuda()
    n_assign = MESH_MOE_B * MESH_MOE_S * base.top_k * base.repeats
    cfgs = {a: dataclasses.replace(base, activation_dtype=a)
            for a in ("float32", "bfloat16")}
    got = {}

    def moe_loss(p, cfg):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss, m = lm.loss(p, cfg, {"tokens": toks})
        float(loss)
        return loss, m, (time.perf_counter() - t1) * 1e3

    with torch.no_grad():
        for a, c in cfgs.items():
            moe_loss(params, c)                    # a first call: set-up
            got[a] = {"one": moe_loss(params, c)}
        sp = lm.shard(params, base, mesh22)
        del params
        torch.cuda.empty_cache()
        for a, c in cfgs.items():
            collectives.reset_collectives()
            got[a]["mesh"] = moe_loss(sp, c)
            got[a]["collectives"] = collectives.collective_count()
    lo, hi = mesh_shard_bytes(sp)
    peak = torch.cuda.max_memory_allocated()
    for a in cfgs:
        (l1, m1, one_ms), (l2, m2, mesh_ms) = got[a]["one"], got[a]["mesh"]
        drop1 = round(float(m1["dropped_frac"]) * n_assign)
        drop2 = round(float(m2["dropped_frac"]) * n_assign)
        diff = abs(float(l2) - float(l1))
        print(f"mesh[moe {a}]: {base.name} {base.n_layers} of its 40 layers "
              f"at its published widths, bf16 parameters, {a} activations, "
              f"{base.moe_dispatch} dispatch at capacity factor "
              f"{base.capacity_factor}, ({MESH_MOE_B}, {MESH_MOE_S}) on "
              f"{mesh22.shape}: loss {float(l2):.6f} vs {float(l1):.6f} on "
              f"one device (|diff| {diff:.3e}, tolerance "
              f"{MESH_MOE_LOSS_ATOL}); dropped assignments {drop2} vs "
              f"{drop1} of {n_assign}"
              f"{' (gated)' if a == 'float32' else ' (printed)'}; "
              f"load_balance {float(m2['load_balance']):.6f} vs "
              f"{float(m1['load_balance']):.6f}; loss forward {mesh_ms:.1f} "
              f"ms vs {one_ms:.1f} ms; collectives "
              f"{mesh_coll_text(got[a]['collectives'])}; parameter bytes a "
              f"position {lo}-{hi}; peak device memory {peak / 2**30:.2f} "
              f"GiB [{card}]")
        if diff > MESH_MOE_LOSS_ATOL or (a == "float32" and drop1 != drop2):
            raise AssertionError(f"mesh[moe {a}]: dropped {drop2} vs "
                                 f"{drop1}, loss {float(l2)} vs {float(l1)}")
        out[f"moe {a}"] = {"mesh_ms": mesh_ms, "one_ms": one_ms,
                           "dropped": [drop2, drop1]}
    del sp
    torch.cuda.empty_cache()
    split["d"] = time.perf_counter() - t0
    # (e) mamba2, 4 of its 64 layers, float32: one step on (2, 2)
    t0 = time.perf_counter()
    cfg = dataclasses.replace(registry.get_config(MAMBA_ARCH),
                              n_layers=MESH_MAMBA_LAYERS, **f32)
    out["mamba step"] = mesh_step_gate(
        torch, cfg, mesh22, MESH_MAMBA_B, MESH_MAMBA_S, "e: mamba2 step",
        card, update_rtol=MESH_UPDATE_RTOL)
    split["e"] = time.perf_counter() - t0
    print(f"launches[mesh phase]: " + json.dumps(
        {"plan (train)": out["qwen train"]["plan"],
         "decode (generate)": out["serve"]["decode"]}))
    print(f"mesh summary: " + json.dumps(
        {k: {kk: round(vv, 5) if isinstance(vv, float) else vv
             for kk, vv in v.items()} for k, v in out.items()})
          + f" [{card}]")
    print(f"mesh phase split, s: "
          f"{json.dumps({k: round(v, 2) for k, v in split.items()})} "
          f"[{card}]")
    return time.perf_counter() - t_phase


# -- phase 16: the dry run on the card ---------------------------------------------

DRY_ARCH = "qwen1.5-0.5b"
DRY_B, DRY_S = 8, 1024              # gate (a): phase 13's step, one device
DRY_MESH_B, DRY_MESH_S = 8, 512     # gate (d): phase 15's (a) step, (2, 2)
DRY_PROFILER_RTOL = 0.01
DRY_TIMED = 3
MATMUL_EVENTS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def profiler_matmul_flops(torch, fn) -> tuple:
    """torch.profiler's ``with_flops`` count of the matrix products in one
    call of ``fn`` (2 M N K each, the census's convention; the profiler
    also counts elementwise ops, which are left out): (the products that
    ran, every event). Under a selective checkpoint (remat ``dots``) the
    profiler records a product twice in the forward (the call that enters
    the checkpoint's Python dispatch mode and the call that mode makes)
    and once more for each product the recompute serves from its cache,
    which launches nothing; the products that ran are the events with no
    product nested in them whose call launched a kernel."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_flops=True) as prof:
        fn()
        torch.cuda.synchronize()

    def nests_product(e) -> bool:
        return any(c.name in MATMUL_EVENTS or nests_product(c)
                   for c in e.cpu_children)

    mm = [e for e in prof.events() if e.name in MATMUL_EVENTS and e.flops]
    ran = [e for e in mm if e.device_time_total > 0 and not nests_product(e)]
    return (float(sum(e.flops for e in ran)), float(sum(e.flops for e in mm)))


def census_diff(a: dict, b: dict) -> str:
    """The counts two census records disagree on, and the ops whose bytes
    differ."""
    keys = [k for k in ("dot_flops", "bytes", "collectives", "ops")
            if a[k] != b[k]]
    ops = {k: (a["bytes_by_op"].get(k), b["bytes_by_op"].get(k))
           for k in set(a["bytes_by_op"]) | set(b["bytes_by_op"])
           if a["bytes_by_op"].get(k) != b["bytes_by_op"].get(k)}
    return f"{keys}; bytes by op {ops}"


def dryrun_phase(torch, card):
    """Phase 16: the dry run's census (``launch.dryrun``, ``launch.
    op_census``) on the card against ``meta``, gates (a)-(d) of docstring
    item 16."""
    import statistics

    from repro_torch.configs import registry
    from repro_torch.configs.base import H100, ShapeConfig
    from repro_torch.launch import dryrun, op_census
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.nn import collectives

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    split, out = {}, {}
    same = ("dot_flops", "bytes", "collectives", "ops", "bytes_by_op")
    # (a) qwen recommended, one device, (8, 1024): meta against the card
    t0 = time.perf_counter()
    cfg = registry.get_recommended_config(DRY_ARCH)
    shape = ShapeConfig(f"train_{DRY_B}x{DRY_S}", DRY_S, DRY_B, "train")
    meta, meta_in_place = dryrun.census_cell(cfg, shape, None, "meta")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    m0 = torch.cuda.memory_allocated()
    cell = dryrun.build_cell(cfg, shape, None, "cuda")
    torch.cuda.synchronize()
    state_b = torch.cuda.memory_allocated() - m0
    torch.cuda.reset_peak_memory_stats()
    got, in_place = dryrun.run_census(cell, "train")
    torch.cuda.synchronize()
    temp_card = torch.cuda.max_memory_allocated() - m0 - state_b
    if any(meta[k] != got[k] for k in same) or not (in_place and
                                                    meta_in_place):
        raise AssertionError(f"dryrun[a]: the census on the card differs "
                             f"from meta's: {census_diff(meta, got)}; in "
                             f"place {in_place} / {meta_in_place}")
    prof, prof_all = profiler_matmul_flops(torch, cell.fn)
    rel = abs(prof - got["dot_flops"]) / got["dot_flops"]
    if rel > DRY_PROFILER_RTOL:
        raise AssertionError(f"dryrun[a]: census dot FLOPs "
                             f"{got['dot_flops']} vs the profiler's {prof:.0f}"
                             f" ({rel:.3e} relative)")
    times = []
    for _ in range(DRY_TIMED):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, m = cell.fn()
        float(m["loss"])
        times.append(time.perf_counter() - t1)
    step_s = statistics.median(times)
    terms = H100.roofline_seconds(got["dot_flops"], got["bytes"], 0.0, 1)
    bound_s = max(terms["compute_s"], terms["memory_s"])
    model_flops = 6.0 * cfg.param_count(active_only=True) * shape.tokens
    print(f"dryrun[a: census]: {cfg.name} recommended, one device, "
          f"({DRY_B}, {DRY_S}) train step: dot FLOPs {got['dot_flops']}, "
          f"computed bytes {got['bytes']}, {got['ops']} ops, the same on "
          f"meta and on the card (census {meta['census_s']:.1f} s on meta, "
          f"{got['census_s']:.1f} s on the card); the profiler's matrix "
          f"products that ran a kernel {prof:.0f} ({rel:.2e} from the "
          f"census; {prof_all:.0f} in every event, the checkpoint's nested "
          f"and cached calls too); in place "
          f"{in_place} [{card}]")
    print(f"dryrun[a: roofline]: median of {DRY_TIMED} warm steps "
          f"{step_s * 1e3:.1f} ms ({', '.join(f'{t * 1e3:.1f}' for t in times)}"
          f") vs the H100 data-sheet bound max(compute {terms['compute_s'] * 1e3:.2f}"
          f" ms, memory {terms['memory_s'] * 1e3:.2f} ms) = "
          f"{bound_s * 1e3:.2f} ms: achieved roofline fraction "
          f"{bound_s / step_s:.4f}; model FLOPs (6 N tokens) "
          f"{model_flops:.4e} = {model_flops / step_s / H100.peak_flops:.4f} "
          f"of {H100.peak_flops / 1e12:.0f} TFLOP/s, dot FLOPs "
          f"{got['dot_flops'] / step_s / H100.peak_flops:.4f} of it [{card}]")
    out["a"] = {"dot_flops": got["dot_flops"], "bytes": got["bytes"],
                "profiler_flops": prof, "step_ms": step_s * 1e3,
                "bound_ms": bound_s * 1e3, "fraction": bound_s / step_s}
    split["a"] = time.perf_counter() - t0
    # (b) the state's bytes from the specs against the allocator
    arg_b, _ = dryrun.spec_bytes(cfg, shape)
    ts = [t for t in dryrun.tensors_of([cell.state, cell.inputs])
          if t.is_cuda]
    slack = sum(512 if t.nbytes < 1 << 20 else 1 << 20 for t in ts)
    exact = sum(-(-t.nbytes // 512) * 512 for t in ts)
    if not exact <= state_b <= exact + slack or abs(state_b - arg_b) > slack:
        raise AssertionError(f"dryrun[b]: the built state holds {state_b} "
                             f"bytes, the specs say {arg_b} (slack {slack})")
    print(f"dryrun[b: memory]: argument bytes from the specs {arg_b} vs "
          f"torch.cuda.memory_allocated() of the built state and batch "
          f"{state_b} ({state_b - arg_b:+d}; {len(ts)} tensors on the card, "
          f"{exact} rounded to the allocator's 512 bytes, at most {slack} "
          f"more where a block of 1 MiB or more keeps an unsplit remainder "
          f"of its segment); the census's temporaries "
          f"(an estimate) {got['peak_bytes']} vs max_memory_allocated() above "
          f"the state during the census step {temp_card} "
          f"({got['peak_bytes'] / max(temp_card, 1):.3f} of it) [{card}]")
    out["b"] = {"argument_bytes": arg_b, "allocated": state_b,
                "temp_estimate": got["peak_bytes"], "temp_card": temp_card}
    del cell
    torch.cuda.empty_cache()
    # (c) the constants against the card
    props = torch.cuda.get_device_properties(0)
    print(f"dryrun[c: constants]: configs.base.H100 peak {H100.peak_flops:.3e}"
          f" FLOP/s (dense bf16), HBM {H100.hbm_bw:.3e} B/s, "
          f"{H100.hbm_bytes:.3e} B, NVLink {H100.link_bw:.3e} B/s each way "
          f"(the SXM data sheet at 700 W); the card: {props.name}, "
          f"{props.multi_processor_count} SMs, {props.total_memory} bytes of "
          f"memory; nvidia-smi: {card}")
    # (d) a (2, 2) virtual-shard step of qwen float32 at (8, 512)
    t0 = time.perf_counter()
    c32 = dataclasses.replace(registry.get_config(DRY_ARCH),
                              param_dtype="float32",
                              activation_dtype="float32")
    mshape = ShapeConfig(f"train_{DRY_MESH_B}x{DRY_MESH_S}", DRY_MESH_S,
                         DRY_MESH_B, "train")
    meta, _ = dryrun.census_cell(c32, mshape,
                                 make_debug_mesh(2, 2, device="meta"), "meta")
    got, in_place = dryrun.census_cell(c32, mshape,
                                       make_debug_mesh(2, 2, device="cuda"),
                                       "cuda")
    recv = collectives.collective_count()
    if any(meta[k] != got[k] for k in same) or not in_place:
        raise AssertionError(f"dryrun[d]: the mesh census on the card "
                             f"differs from meta's: {census_diff(meta, got)}"
                             f"; in place {in_place}")
    per_dev = op_census.collective_bytes(got)
    calls = op_census.count_collectives(got)
    print(f"dryrun[d: mesh]: {c32.name} float32 ({DRY_MESH_B}, {DRY_MESH_S})"
          f" on (2, 2) virtual shards of the card: the census the same on "
          f"meta; collective operand bytes a device "
          f"{json.dumps({k: round(v) for k, v in per_dev.items() if v})}, "
          f"calls a device {json.dumps({k: v for k, v in calls.items() if v})}"
          f"; phase 15's counter of the same step (bytes each position "
          f"receives, summed; calls a group) {mesh_coll_text(recv)}; dot "
          f"FLOPs a device {op_census.dot_flops(got):.4e} [{card}]")
    out["d"] = {"collective_bytes": per_dev, "received": recv}
    torch.cuda.empty_cache()
    split["d"] = time.perf_counter() - t0
    print(f"dryrun summary: " + json.dumps(
        {k: {kk: (round(vv, 5) if isinstance(vv, float) else vv)
             for kk, vv in v.items()} for k, v in out.items()}) + f" [{card}]")
    print(f"dryrun phase split, s: "
          f"{json.dumps({k: round(v, 2) for k, v in split.items()})} [{card}]")
    return time.perf_counter() - t_phase


# -- the paper's byte-level path ------------------------------------------------

BYTES_CHARS = 4_300_000     # bench_corpus: the King James Bible's size
COUNT_N, COUNT_B, COUNT_RANK = 5, 12, 16   # 28 pairwise bits = 12 + 16
SCAN_N, SEG_CHARS = 8, 500_000             # decontam: 8-grams, eval segment
# bloom_probe's (k, log2_m) checks: its filter whole in each block's shared
# memory (14, 18, 20), its first 224 KiB there and the rest through the
# read-only cache (21, 22, 23), all through the read-only cache (24, 26)
BLOOM_CASES = ((2, 14), (8, 18), (4, 20), (4, 21), (4, 22), (4, 23),
               (4, 24), (1, 26))


def distinct_byte_grams(text: np.ndarray, n: int) -> int:
    """Exact number of distinct byte n-grams (n <= 8), on the host."""
    W = len(text) - n + 1
    key = np.zeros(W, np.int64)
    for k in range(n):
        key = (key << 8) | text[k : k + W].astype(np.int64)
    return len(np.unique(key))


def bytes_phase(torch, card, reset_counts, read_counts):
    """The paper's byte-level path over the 4.3 Mchar corpus, gates (a)-(f)
    of the module docstring; returns the three kernels' entries of the
    kernels line."""
    from repro_torch.core import BloomFilter, HyperLogLog, make_family, u32
    from repro_torch.data import corpus
    from repro_torch.kernels import bloom, hll, ops, ref, sketch_fused
    from repro_torch.kernels.plan import HashSpec

    dev = torch.device("cuda")
    cgen = torch.Generator(device=dev).manual_seed(14)
    t0 = time.perf_counter()
    text = corpus.bench_corpus(BYTES_CHARS)
    chars = torch.from_numpy(text[None]).to(dev)            # (1, 4.3M) int32
    fam5 = make_family("cyclic", COUNT_N)
    fam8 = make_family("cyclic", SCAN_N)
    table = fam5.init(torch.Generator().manual_seed(1), 256, dev)["h1"]
    ta = fam8.init(torch.Generator().manual_seed(2), 256, dev)["h1"]
    tb = fam8.init(torch.Generator().manual_seed(3), 256, dev)["h1"]

    def rand_bytes(shape):
        return torch.randint(0, 256, shape, generator=cgen, device=dev,
                             dtype=torch.int32)

    def rand_hashes(shape):
        return rand_words(torch, cgen, shape, dev, dense=False)

    def check_fused(toks, n, Lw, what):
        got = ops.cyclic_fused(toks, table, n=n, L=Lw, impl="kernel")
        want = ops.cyclic_fused(toks, table, n=n, L=Lw, impl="ref")
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"gate (a): cyclic_rolling_fused != plain "
                                 f"version: {what} n={n} L={Lw}, max |diff| "
                                 f"{err}")
        return got, err

    # (a) the fused lookup kernel against its plain version
    err_a = 0
    for n, Lw in ((1, 32), (5, 32), (8, 32), (15, 32), (25, 32), (5, 20),
                  (8, 20)) + WIDE_NL:
        err_a = max(err_a, check_fused(chars, n, Lw, "corpus")[1])
    rnd = rand_bytes((1024, 8192))
    got, e = check_fused(rnd, SCAN_N, 32, "(1024, 8192)")
    looked = table.view(torch.int32)[rnd.to(torch.int64)].view(torch.uint32)
    if not torch.equal(got, ops.cyclic(looked, n=SCAN_N, impl="kernel")):
        raise AssertionError("gate (a): cyclic_rolling_fused != ops.cyclic "
                             "of the looked-up values at (1024, 8192)")
    err_a = max(err_a, e, check_fused(rand_bytes((3, 300)), SCAN_N, 32,
                                      "(3, 300)")[1])
    odd = rand_bytes((1, 64))
    odd[0, :4] = torch.tensor([-300, -1, 256, 300])
    odd[0, 30:34] = torch.tensor([300, 256, -1, -300])
    for n in (1, 3, 8):
        err_a = max(err_a, check_fused(odd, n, 32, "tokens outside [0, 256)"
                                       )[1])
    print(f"gate (a): cyclic_rolling_fused == plain version on the card: the "
          f"corpus (1, {BYTES_CHARS}) at n in (1, 5, 8, 15, 25) with L=32, "
          f"n in (5, 8) with L=20 and (n, L) in {WIDE_NL}, (1024, 8192) (== "
          f"ops.cyclic of the "
          f"looked-up values too), (3, 300), and a row with tokens -300, -1, "
          f"256, 300")

    # (b) hll_update against its plain version: shared registers up to
    # b = 14, global ones above; N from one hash (one block) to the corpus,
    # and just past a block's and two blocks' first sweep (1,024 threads x
    # 4 loads)
    err_b = 0
    hll_ns = (1, 7, 300, 4097, 5000, 8193, BYTES_CHARS - COUNT_N + 1)
    hll_bs = (1, 2, 4, 10, 12, 14, 15, 16, 17, 23, 31)
    for N in hll_ns:
        h = rand_hashes((N,))
        for b in hll_bs:
            planted = torch.tensor([0, 1, (1 << b) - 1, 1 << b],
                                   dtype=torch.int64)[:N]
            hv = h.view(torch.int32).clone()
            hv[: len(planted)] = planted.to(torch.int32)
            hv = hv.view(torch.uint32)
            for rb in (32 - b, 32):
                got = hll.hll_update(hv, b=b, rank_bits=rb)
                want = ref.hll_update_ref(hv, b=b, rank_bits=rb)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    err_b = int((got - want).abs().max())
                    raise AssertionError(f"gate (b): hll_update != plain "
                                         f"version at N={N} b={b} "
                                         f"rank_bits={rb}, max |diff| "
                                         f"{err_b}")
                del got, want
    print(f"gate (b): hll_update == plain version on the card at N in "
          f"{hll_ns} x b in {hll_bs} x rank_bits in (32-b, 32), with 0, 1, "
          f"2^b - 1 and 2^b planted")

    # (d) bloom_probe against its plain version, on each of its routes
    err_d = 0
    routes = {m: bloom.route(m) for _, m in BLOOM_CASES}
    if set(routes.values()) != {0, 1, 2}:
        raise AssertionError(f"gate (d): the cases miss a route: {routes}")
    for B, S in ((1, BYTES_CHARS - SCAN_N + 1), (1024, 4096), (3, 300)):
        ha, hb = rand_hashes((B, S)), rand_hashes((B, S))
        for k, log2_m in BLOOM_CASES:
            bits = rand_words(torch, cgen, (1 << (log2_m - 5),), dev)
            got = bloom.bloom_probe(ha, hb, bits, k=k, log2_m=log2_m)
            want = ref.bloom_probe_ref(ha, hb, bits, k=k, log2_m=log2_m)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"gate (d): bloom_probe != plain version "
                                     f"at ({B}, {S}) k={k} log2_m={log2_m}")
    print(f"gate (d): bloom_probe == plain version on the card at (B, S) in "
          f"((1, {BYTES_CHARS - SCAN_N + 1}), (1024, 4096), (3, 300)) x (k, "
          f"log2_m) in {BLOOM_CASES}; the route of each log2_m (1 whole in "
          f"each block's shared memory, 2 its first 224 KiB there and the "
          f"rest through the read-only cache, 0 all through that cache): "
          f"{json.dumps(routes)}; checks of the phase "
          f"{time.perf_counter() - t0:.1f} s")

    # -- the main path: the §2 count and the decontamination scan --
    seg_w = SEG_CHARS - SCAN_N + 1

    def run_path():
        h28 = fam5.pairwise_bits(ops.cyclic_fused(chars, table, n=COUNT_N))
        regs = hll.hll_update(h28, b=COUNT_B, rank_bits=COUNT_RANK)
        ha = fam8.pairwise_bits(ops.cyclic_fused(chars, ta, n=SCAN_N))
        hb = fam8.pairwise_bits(ops.cyclic_fused(chars, tb, n=SCAN_N))
        bf = BloomFilter(log2_m=22, k=4)
        bits = bf.add(bf.init(dev), ha[:, :seg_w], hb[:, :seg_w])
        hits = bloom.bloom_probe(ha, hb, bits, k=bf.k, log2_m=bf.log2_m)
        return h28, regs, ha, hb, bf, bits, hits

    run_path()                                   # warm: builds nothing new
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    h28, regs, ha, hb, bf, bits, hits = run_path()
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t0
    counts = read_counts()
    print(f"launches[bytes path]: {json.dumps(counts)}")
    for kind in ("lookup", "hll", "bloom"):
        if counts[kind] < 1:
            raise AssertionError(f"gate (f): the bytes path launched no "
                                 f"{kind} kernel")
    # (c) the §2 distinct count
    est = float(HyperLogLog(b=COUNT_B, hash_bits=fam5.out_bits)
                .estimate(regs))
    exact = distinct_byte_grams(text, COUNT_N)
    rel = abs(est - exact) / exact
    print(f"gate (c): HLL (b={COUNT_B}, rank_bits={COUNT_RANK}) of the "
          f"corpus's {fam5.out_bits}-bit CYCLIC n={COUNT_N} hashes: estimate "
          f"{est:.0f} vs exact distinct {COUNT_N}-grams {exact}: relative "
          f"error {rel:.4f}")
    if not rel <= 0.1:
        raise AssertionError(f"gate (c): HLL estimate off by {rel:.4f}")
    if not torch.equal(regs, ref.hll_update_ref(h28, b=COUNT_B,
                                                rank_bits=COUNT_RANK)):
        raise AssertionError("gate (c): registers != the plain version's")
    # (e) the decontamination scan
    fill = float(bf.fill_fraction(bits))
    inside = bool(hits[0, :seg_w].all())
    outside = float(hits[0, seg_w:].to(torch.float64).mean())
    print(f"gate (e): filter of the first {SEG_CHARS} chars' {SCAN_N}-grams "
          f"(2^22 bits, k=4, fill {fill:.4f}); every segment window hits: "
          f"{inside}; other windows hit {outside:.6f} (limit 2 x fill^4 = "
          f"{2 * fill ** 4:.6f})")
    if not inside or not outside < 2 * fill ** 4:
        raise AssertionError("gate (e): the decontamination scan failed")
    if not torch.equal(hits, ref.bloom_probe_ref(ha, hb, bits, k=4,
                                                 log2_m=22)):
        raise AssertionError("gate (e): hits != the plain version's")
    idle = device_busy(torch, run_path, card, "bytes path: count + scan")
    print(f"bytes path: {BYTES_CHARS} chars counted and scanned in "
          f"{t_path:.4f} s = {BYTES_CHARS / t_path:.0f} chars/s; card idle "
          f"{idle:.4f} [{card}]")

    # -- times at the path's shapes --
    entries = []

    def timed(name, kern, plain_fn, b_ms, by, text, what, launches, err,
              replaces, source, k_iters=200):
        ms, plain_ms, kh, (k1, k2, p1, p2) = in_turns(
            torch, kern, plain_fn, k_iters=k_iters, p_iters=10)
        print(f"kernel[{name}] {what}: {ms:.5f} ms per launch ({k1:.5f}, "
              f"{k2:.5f}); plain version {plain_ms:.5f} ms ({p1:.5f}, "
              f"{p2:.5f}); bound {b_ms:.5f} ms by {by} ({text}); bound / time "
              f"{b_ms / ms:.3f}; the host takes {kh:.5f} ms to issue one "
              f"launch [{card}]")
        if replaces:
            entries.append({
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": by, "library_ms": None})

    # the lookup kernel: 4 bytes in and 4 out a window, the table once; per
    # window the CYCLIC roll, a clamp of the token (three ALU) and one table
    # read from shared memory
    for B, toks, n, replaces in ((1, chars, COUNT_N,
                                  "src/repro/kernels/sketch_fused.py:653"),
                                 (1024, rnd, SCAN_N, None)):
        S = toks.shape[1]
        W = S - n + 1
        b_ms, by, btext = roofline(
            B * W, 4 * B * (S + W) + 4 * 256,
            hash_ops(HashSpec(family="cyclic", n=n, L=32))[0] + 3, 0, 1)
        timed("cyclic_rolling_fused",
              lambda: sketch_fused.cyclic_rolling_fused(toks, table, n=n),
              lambda: ref.cyclic_fused_ref(toks, table, n), b_ms, by, btext,
              f"({B}, {S}) n={n} L=32", counts["lookup"], err_a, replaces,
              "rolling.cu")
    # the HLL kernel: 4 bytes a hash, the registers zeroed and written once;
    # per hash AND, shift, BREV + FLO, min, +1 and the compare (ALU) and one
    # register read; an atomic for each register the data touches
    N = h28.numel()
    touched = int((regs > 0).sum())
    b_ms, by, btext = roofline(N, 4 * N + 8 * regs.numel(), 7, 0,
                               1 + touched / N, what="hashes")
    timed("hll_update",
          lambda: hll.hll_update(h28, b=COUNT_B, rank_bits=COUNT_RANK),
          lambda: ref.hll_update_ref(h28, b=COUNT_B, rank_bits=COUNT_RANK),
          b_ms, by, btext, f"N={N} b={COUNT_B} rank_bits={COUNT_RANK}",
          counts["hll"], err_b, "src/repro/kernels/hll.py:49", "hll.cu")
    hll_split(torch, hll, h28, COUNT_B, COUNT_RANK, b_ms, card)
    # the Bloom kernel: 9 bytes an element and the filter once; per element
    # the odd stride (ALU), per probe one IMAD (FMA), mask, shift and bit
    # test (ALU) and one filter load, for the probes this data needs
    probes = pair_probes(torch, u32, ha, hb, bits, bf.k, bf.log2_m)
    E = ha.numel()
    b_ms, by, btext = roofline(E, 9 * E + 4 * bits.numel(),
                               1 + 3 * probes, probes, probes,
                               what="elements")
    timed("bloom_probe",
          lambda: bloom.bloom_probe(ha, hb, bits, k=bf.k, log2_m=bf.log2_m),
          lambda: ref.bloom_probe_ref(ha, hb, bits, k=bf.k,
                                      log2_m=bf.log2_m),
          b_ms, by, btext, f"(1, {E}) k={bf.k} log2_m={bf.log2_m}, "
          f"{probes:.4f} probes an element", counts["bloom"], err_d,
          "src/repro/kernels/bloom.py:43", "bloom.cu")
    return entries, BYTES_CHARS / t_path


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    global HBM_BYTES_PER_S, DENSE_BF16_FLOPS
    from repro_torch.configs.base import H100
    HBM_BYTES_PER_S, DENSE_BF16_FLOPS = H100.hbm_bw, H100.peak_flops
    from repro_torch.core import gf2
    from repro_torch.data import corpus, decontam, dedup, pipeline, stats
    from repro_torch.kernels import (_build, api, bloom, cyclic, decode,
                                     general, hll, ops, ref, sketch_fused)
    from repro_torch.kernels.plan import (BloomSpec, CountMinSpec, DecodeSpec,
                                          HashSpec, HLLSpec, MinHashSpec,
                                          SketchPlan)

    def reset_counts():
        sketch_fused.LAUNCHES = cyclic.LAUNCHES = general.LAUNCHES = 0
        decode.LAUNCHES = sketch_fused.LOOKUP_LAUNCHES = 0
        bloom.LAUNCHES = hll.LAUNCHES = 0
        for kind in sketch_fused.EPILOGUE_LAUNCHES:
            sketch_fused.EPILOGUE_LAUNCHES[kind] = 0

    def read_counts() -> dict:
        return {**sketch_fused.EPILOGUE_LAUNCHES, "plan": sketch_fused.LAUNCHES,
                "cyclic": cyclic.LAUNCHES, "general": general.LAUNCHES,
                "decode": decode.LAUNCHES,
                "lookup": sketch_fused.LOOKUP_LAUNCHES,
                "bloom": bloom.LAUNCHES, "hll": hll.LAUNCHES}

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build(_build.sources() + [str(RED_FLOOR_SRC),
                                     str(STREAM_FLOOR_SRC),
                                     str(HLL_SPLIT_SRC)])
    print(f"build: {_build.sources()}, {RED_FLOOR_SRC.name}, "
          f"{STREAM_FLOOR_SRC.name} and {HLL_SPLIT_SRC.name} with "
          f"{_build.nvcc()} into "
          f"{_build.BUILD_DIR} in {time.perf_counter() - t0:.2f} s")
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"build[{name}]: {line.strip()}")

    # -- 3. and 6. every kernel against its plain version -----------------------
    def check_sets(family):
        hs = HashSpec(family=family, n=N, L=L)
        sets = {
            "minhash": (("sig", MinHashSpec(k=K)),),
            "hll b=4": (("hll", HLLSpec(b=4)),),
            "hll b=12": (("hll", HLLSpec(b=12)),),
            "hll b=14": (("hll", HLLSpec(b=14)),),
            "hll b=15": (("hll", HLLSpec(b=15)),),
            "hll b=16": (("hll", HLLSpec(b=16)),),
            "hll b=12 rank_bits=6": (("hll", HLLSpec(b=12, rank_bits=6)),),
            "countmin w=12": (("cms", CountMinSpec(depth=4,
                                                   log2_width=12)),),
            "countmin w=16": (("cms", CountMinSpec(depth=4,
                                                   log2_width=16)),),
            "bloom log2_m=20": (("bloom", BloomSpec(k=4, log2_m=20)),),
            "bloom log2_m=22": (("bloom", BloomSpec(k=4, log2_m=22)),),
            "stats (hll + countmin)": (
                ("hll", HLLSpec(b=12)),
                ("cms", CountMinSpec(depth=4, log2_width=16))),
            "all four": (("sig", MinHashSpec(k=K)), ("hll", HLLSpec(b=12)),
                         ("cms", CountMinSpec(depth=4, log2_width=16)),
                         ("bloom", BloomSpec(k=4, log2_m=22))),
        }
        return {k: SketchPlan(hs, v) for k, v in sets.items()}

    gen = torch.Generator().manual_seed(0)
    err = {"MinHashSpec": 0, "HLLSpec": 0, "CountMinSpec": 0,
           "BloomSpec": 0, "cyclic": 0, "general": 0}
    t0 = time.perf_counter()
    for family in ("cyclic", "general"):
        for what, plan in check_sets(family).items():
            for B in (8, 64, 1024):
                for S in (7, 520, 1024, 8192):
                    e = check_plan(torch, api, plan, gen, B, S)
                    for _, spec in plan.sketches:
                        kind = type(spec).__name__
                        err[kind] = max(err[kind], e)
            print(f"check: {family} {what}: kernel == plain version on the "
                  f"card at B in (8, 64, 1024) x S in (7, 520, 1024, 8192)")
    # one row of 65,600 segments: a row this long keeps the longest segment
    # (1,024 windows), and a grid of one block a (row, segment) held at most
    # 65,535 segments a row; the tiles are now one linear index
    big_s = 65_600 * 1024 + N - 1
    e = check_plan(torch, api, check_sets("cyclic")["stats (hll + countmin)"],
                   gen, 1, big_s, full=True)
    err["HLLSpec"] = max(err["HLLSpec"], e)
    err["CountMinSpec"] = max(err["CountMinSpec"], e)
    print(f"check: cyclic stats plan over one row of {big_s - N + 1} windows "
          f"(65,600 tiles of 1,024): kernel == plain version on the card")
    for family in ("cyclic", "general"):
        for n in (1, 8, 25, 32):
            for Lw in (16, 32):
                if n > Lw:
                    continue
                # GENERAL at (1024, 8192): with the route cases below, at
                # L = 16 and 32 for these n
                for B, S in ((64, 8192), (1024, 520), (1024, 64),
                             (1024, 8192), (3, n)):
                    if family == "general" and (B, S) == (1024, 8192):
                        continue
                    err[family] = max(err[family], check_rolling(
                        torch, ops, family, n, Lw, B, S, gen))
            print(f"check: ops.{family} n={n} L in (16, 32): kernel == "
                  f"plain version on the card")
        # n > L: rotations reduce mod L, the halo is sized past 32
        for n, Lw in WIDE_NL:
            for B, S in ((1024, 520), (3, 9000)):
                err[family] = max(err[family], check_rolling(
                    torch, ops, family, n, Lw, B, S, gen))
        print(f"check: ops.{family} at (n, L) in {WIDE_NL}: kernel == plain "
              f"version on the card")
    # GENERAL's two routes (general.route: 1 the fold, 2 the tables, with
    # their ways), with the default p and a dense one (weight 9), n past L;
    # every count of terms and tables the kernel has
    if not gf2.is_irreducible_host(DENSE_P32):
        raise AssertionError(f"DENSE_P32 {hex(DENSE_P32)} is reducible")
    routes, t1 = {}, time.perf_counter()
    rgen = torch.Generator(device="cuda").manual_seed(18)
    for p, Lw, ns in ((gf2.find_irreducible_host(32), 32, ROUTE_NS),
                      (DENSE_P32, 32, ROUTE_NS + (12, 20)),
                      (gf2.find_irreducible_host(19), 19, (1, 8, 19, 25)),
                      (gf2.find_irreducible_host(20), 20, (1, 8, 20, 25)),
                      (gf2.find_irreducible_host(16), 16, (1, 8, 25, 32))):
        for n in ns:
            r = general.route(n, p, Lw)
            routes[f"{hex(p)} n={n}"] = f"{r.route}x{r.ways}"
            for B, S in ((1024, 8192), (3, 300)):
                err["general"] = max(err["general"], check_rolling(
                    torch, ops, "general", n, Lw, B, S, rgen, p=p))
    if not {"1x2", "1x4", "2x1", "2x2", "2x3", "2x4"} <= set(routes.values()):
        raise AssertionError(f"the GENERAL cases miss a route: {routes}")
    print(f"check: ops.general on both routes at (1024, 8192) and (3, 300): "
          f"kernel == plain version on the card; the route x ways of each "
          f"(p, n): {json.dumps(routes)}; {time.perf_counter() - t1:.1f} s")
    err_decode = check_decode_grid(torch, api, DecodeSpec)
    err_decode = max(err_decode, check_past_limits(torch, gen, err))
    print(f"checks: {time.perf_counter() - t0:.1f} s")

    # -- 4. the dedup path ----------------------------------------------------
    t0 = time.perf_counter()
    spec = corpus.CorpusSpec(n_docs=100_000, dup_rate=0.25,
                             mutate_frac=0.015, vocab=8192, seed=42)
    docs, dup_of = corpus.documents(spec)
    truth = dup_of >= 0
    print(f"corpus: {len(docs)} docs, {int(truth.sum())} planted "
          f"near-duplicates, made in {time.perf_counter() - t0:.2f} s")
    reset_counts()
    dd, flags, launches, dt, tokens = dedup_run(torch, docs, truth, "cyclic",
                                                sketch_fused, dedup, card)

    # re-sign 2,000 documents through the plain version on the card
    plain = dedup.MinHashDeduper(dedup.DedupConfig(**{**dd.cfg.__dict__,
                                                      "impl": "ref"}))
    plain.import_params(dd.export_state()["params"])
    sub = docs[:2000]
    if not np.array_equal(dd.signature_many(sub), plain.signature_many(sub)):
        raise AssertionError("cyclic: kernel signatures != plain version")
    print("main[cyclic]: 2000 documents re-signed by the plain version on "
          "the card: equal")

    # signing alone (warm), to split add_batch into card and host work
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dd.signature_many(docs)
    torch.cuda.synchronize()
    t_sign = time.perf_counter() - t0
    print(f"main[cyclic]: signature_many alone {t_sign:.3f} s = "
          f"{tokens / t_sign:.0f} tokens/s; LSH probe + verify "
          f"{dt - t_sign:.3f} s of add_batch [{card}]")
    device_busy(torch, lambda: dd.signature_many(docs[:20_000]), card,
                "cyclic signature_many, 20000 docs")

    gdocs, gtruth = docs[:20_000], truth[:20_000]
    gdd, _, glaunches, _, _ = dedup_run(torch, gdocs, gtruth, "general",
                                        sketch_fused, dedup, card)
    gplain = dedup.MinHashDeduper(dedup.DedupConfig(**{**gdd.cfg.__dict__,
                                                       "impl": "ref"}))
    gplain.import_params(gdd.export_state()["params"])
    if not np.array_equal(gdd.signature_many(sub),
                          gplain.signature_many(sub)):
        raise AssertionError("general: kernel signatures != plain version")
    print("main[general]: 2000 documents re-signed by the plain version on "
          "the card: equal")

    # -- 5. the data-plane path ------------------------------------------------
    # the deduplicated corpus packed with EOS, as PackedCorpus does
    kept = np.flatnonzero(~flags)
    packed = pipeline.pack([docs[i] for i in kept], 8192, 0)
    doc_of = np.repeat(kept, [len(docs[i]) + 1 for i in kept])
    per_row = len(packed) // STREAM_ROWS
    rows = packed[: STREAM_ROWS * per_row].reshape(STREAM_ROWS, per_row)
    n_stats = rows.size
    # the eval set: 500 kept original documents; a row that holds any token
    # of one of them or of its planted near-duplicates may flag rightly
    rng = np.random.default_rng(7)
    eval_ids = np.sort(rng.choice(kept[dup_of[kept] < 0], EVAL_DOCS,
                                  replace=False))
    tainted = np.isin(doc_of, np.union1d(
        eval_ids, np.flatnonzero(np.isin(dup_of, eval_ids))))
    eval_stream = pipeline.pack([docs[i] for i in eval_ids], 8192, 0)
    eval_rows = eval_stream[: len(eval_stream) // SEQ * SEQ].reshape(-1, SEQ)
    n_batches = len(packed) // (DECON_ROWS * SEQ)
    print(f"data plane: {len(kept)} kept docs packed into {len(packed)} "
          f"tokens; stats over {STREAM_ROWS} streams of {per_row} tokens; "
          f"eval set {EVAL_DOCS} docs = {len(eval_rows)} rows of {SEQ}")

    reset_counts()
    ng, fin = {}, {}
    stats_s = {}
    for family in ("cyclic", "general"):
        ng[family] = stats.NgramStats(stats.StatsConfig(family=family,
                                                        device="cuda"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = stats_run(ng[family], rows)
        torch.cuda.synchronize()
        stats_s[family] = time.perf_counter() - t0
        fin[family] = st
        # the first window of every stream was counted: CountMin never
        # undercounts it; a plain-version twin with the same draws, queried
        # on the same state, must give the same estimates
        hh = ng[family].heavy_hitter_count(st, rows[:, :64])
        if not (hh >= 1).all():
            raise AssertionError(f"stats[{family}]: a counted window has "
                                 f"estimate 0")
        twin = stats.NgramStats(stats.StatsConfig(family=family, device="cuda",
                                                  impl="ref"))
        twin.rebind_params(ng[family].export_params())
        if not np.array_equal(hh, twin.heavy_hitter_count(st, rows[:, :64])):
            raise AssertionError(f"stats[{family}]: heavy-hitter estimates "
                                 f"!= the plain version's")
        print(f"stats[{family}]: update_stream_many over {n_stats} tokens "
              f"in ({BLOCK_T}, {STREAM_ROWS}, {CHUNK_S}) blocks: "
              f"{stats_s[family]:.3f} s = {n_stats / stats_s[family]:.0f} "
              f"tokens/s; distinct 8-grams ~ "
              f"{ng[family].distinct_ngrams(st):.0f}, tokens counted "
              f"{ng[family].token_count(st)}, heavy-hitter estimates of the "
              f"first windows: median {int(np.median(hh))}, max "
              f"{int(hh.max())} [{card}]")
        if ng[family].token_count(st) != n_stats:
            raise AssertionError(f"stats[{family}]: token count "
                                 f"{ng[family].token_count(st)} != {n_stats}")

    dc = decontam.Decontaminator(decontam.DecontamConfig(device="cuda"))
    dc.add_eval_set(eval_rows)
    planted_rows, batches, counts = [], [], []
    t_flag = 0.0
    for bi in range(n_batches):
        batch = packed[bi * DECON_ROWS * SEQ : (bi + 1) * DECON_ROWS * SEQ
                       ].reshape(DECON_ROWS, SEQ).copy()
        at = rng.choice(DECON_ROWS, PLANTED, replace=False)
        batch[at] = eval_rows[rng.integers(0, len(eval_rows), PLANTED)]
        planted = np.zeros(DECON_ROWS, bool)
        planted[at] = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = dc.contamination(batch)
        t_flag += time.perf_counter() - t0
        planted_rows.append(planted)
        counts.append(got)
        if bi < 2:
            batches.append(batch)
    frac = np.concatenate(counts)
    flagged = frac > dc.cfg.max_hit_frac
    planted = np.concatenate(planted_rows)
    clean = ~planted & ~tainted[: n_batches * DECON_ROWS * SEQ].reshape(
        -1, SEQ).any(axis=1)
    false_rate = flagged[clean].mean()
    n_dec = n_batches * DECON_ROWS * SEQ
    print(f"decontam: {n_batches} batches of {DECON_ROWS} x {SEQ} "
          f"({n_dec} tokens), filter fill "
          f"{float(dc.bloom.fill_fraction(dc.bits)):.4f}: flag "
          f"{t_flag:.3f} s = {n_dec / t_flag:.0f} tokens/s; planted rows "
          f"flagged {int(flagged[planted].sum())}/{int(planted.sum())}; "
          f"rows of other documents flagged {int(flagged[clean].sum())}/"
          f"{int(clean.sum())} = {false_rate:.6f} [{card}]")
    if not flagged[planted].all():
        raise AssertionError("decontam: a planted eval row did not flag")
    if not false_rate < 0.01:
        raise AssertionError(f"decontam: false-flag rate {false_rate}")

    dp = pipeline.DataPlane(pipeline.PipelineConfig(
        seq_len=SEQ, batch_size=64, device="cuda"), decontam=dc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(100):
        dp.next_batch(step)
    torch.cuda.synchronize()
    t_dp = time.perf_counter() - t0
    tele = dp.telemetry()
    print(f"dataplane: 100 next_batch steps of 64 x {SEQ} in {t_dp:.3f} s "
          f"= {100 * 64 * SEQ / t_dp:.0f} tokens/s; telemetry "
          f"{json.dumps(tele)} [{card}]")
    if tele["tokens_seen"] != 100 * 64 * SEQ:
        raise AssertionError(f"dataplane: tokens_seen {tele['tokens_seen']}")
    counts_dp = read_counts()
    print(f"launches[data plane path]: {json.dumps(counts_dp)}")
    for kind in ("HLLSpec", "CountMinSpec", "BloomSpec", "cyclic", "general"):
        if counts_dp[kind] < 1:
            raise AssertionError(f"data plane path launched no {kind} kernel")

    # checks of the data plane against the exact count and the plain version
    prefix = rows[:, :PREFIX_COLS]
    hng = stats.NgramStats(stats.StatsConfig(device="cuda"))
    pst = stats_run(hng, prefix)
    est = hng.distinct_ngrams(pst)
    exact = distinct_windows(prefix, N)
    rel = abs(est - exact) / exact
    print(f"stats[cyclic] prefix of {prefix.size} tokens: HLL estimate "
          f"{est:.0f} vs exact distinct 8-grams {exact}: relative error "
          f"{rel:.4f}")
    if not rel <= 0.1:
        raise AssertionError(f"HLL estimate off by {rel:.4f} > 0.1")
    png = stats.NgramStats(stats.StatsConfig(device="cuda", impl="ref"))
    png.rebind_params(hng.export_params())
    pref = stats_run(png, prefix)
    for key in ("hll", "cms"):
        if not torch.equal(pst[key], pref[key]):
            raise AssertionError(f"stats prefix: kernel {key} != plain")
    print("stats[cyclic] prefix: registers and table equal the plain "
          "version's on the card")
    pdc = decontam.Decontaminator(decontam.DecontamConfig(device="cuda",
                                                          impl="ref"))
    pdc.rebind_params({"pa": dc.pa, "pb": dc.pb, "bits": dc.bits})
    for bi, batch in enumerate(batches):
        if not np.array_equal(pdc.contamination(batch), counts[bi]):
            raise AssertionError(f"decontam batch {bi}: kernel != plain")
    print(f"decontam: {len(batches)} batches re-scanned by the plain version "
          f"on the card: equal")

    # -- 10. the durable phase -----------------------------------------------
    t0 = time.perf_counter()
    durable_phase(torch, card, reset_counts, read_counts, ng, dc, dp, dd, docs,
                  flags, rows, len(docs) / dt)
    print(f"durable phase: {time.perf_counter() - t0:.1f} s [{card}]")

    # -- 9. times of the dedup and data-plane paths ---------------------------------
    t_times = time.perf_counter()
    two_blocks = rows[:, : 2 * BLOCK_T * CHUNK_S]
    idle_stats = device_busy(torch, lambda: stats_run(ng["cyclic"],
                                                      two_blocks), card,
                             f"stats cyclic, 2 blocks ({two_blocks.size} "
                             f"tokens)")
    some = [np.concatenate([b for b in batches])]
    idle_dec = device_busy(torch, lambda: dc.contamination(some[0]), card,
                           f"decontam flag, {some[0].size} tokens")

    dev = torch.device("cuda")
    kernels = []
    B, S = STREAM_ROWS, N - 1 + CHUNK_S
    windows = B * CHUNK_S
    x = rand_u32(torch, gen, (B, S), dev)
    nw = torch.full((B,), CHUNK_S, dtype=torch.int32, device=dev)
    ws = torch.zeros((B,), dtype=torch.int32, device=dev)

    def time_plan(name, plan, operands, xb=None, probes=0.0, replaces=None,
                  launches=0, max_err=0, nbytes=0, donate=False):
        """Check the launch at the main shape against its plain version,
        then time it in turns. With ``donate`` every timed launch folds
        into one carry of its own, and a profile of one launch must show
        the kernel alone: no copy, no fill."""
        own = lambda: {k: {kk: v.clone() if kk == "init" else v
                           for kk, v in o.items()}
                       for k, o in operands.items()}
        plain_fn = lambda: ref.sketch_plan_ref(plan, x, xb, nw, operands,
                                               w_start=ws)
        got = sketch_fused.sketch_plan_fused(x, xb, nw, own(), plan=plan,
                                             w_start=ws, donate=donate)
        want = plain_fn()
        for key in got:
            if not torch.equal(got[key], want[key]):
                raise AssertionError(f"{name}: kernel != plain at the main "
                                     f"shape (donate={donate})")
        carry = own() if donate else operands
        kern = lambda: sketch_fused.sketch_plan_fused(
            x, xb, nw, carry, plan=plan, w_start=ws, donate=donate)
        ms, plain_ms, kh, (k1, k2, p1, p2) = in_turns(torch, kern, plain_fn)
        b_ms, by, text = bound(plan, windows, nbytes, probes)
        events = ""
        if donate:
            # 20 launches: CUPTI can drop the one event of a single launch
            _, _, rows = profiled(torch, kern, 20)
            if any("sketch_plan_kernel" not in r[1] for r in rows):
                raise AssertionError(f"{name}: a donated launch put more than "
                                     f"the kernel on the card: {rows}")
            events = "; its profile: the kernel alone, no copy or fill"
        print(f"kernel[{name}] {plan.hash.family} B={B} S={S}: {ms:.5f} ms "
              f"per launch ({k1:.5f}, {k2:.5f}); plain version "
              f"{plain_ms:.5f} ms ({p1:.5f}, {p2:.5f}); bound {b_ms:.5f} "
              f"ms by {by} ({text}); bound / time {b_ms / ms:.3f}; the host "
              f"takes {kh:.5f} ms to issue one launch{events} [{card}]")
        if replaces:
            kernels.append({
                "name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/sketch_plan.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": by, "library_ms": None})
        return ms

    # the dedup path's launch: stream_rows rows of n-1 carried symbols plus
    # a full chunk, every window valid, a carried signature
    mplan = SketchPlan(HashSpec(family="cyclic", n=N, L=L),
                       (("sig", MinHashSpec(k=K)),))
    mops = {"sig": {"a": dd.mh_params["a"], "b": dd.mh_params["b"],
                    "init": api.full_u32((B, K), 0xFFFFFFFF, dev)}}
    time_plan("sketch_plan_minhash", mplan, mops,
              replaces="src/repro/kernels/sketch_fused.py:381",
              launches=launches, max_err=err["MinHashSpec"],
              nbytes=4 * (B * S + 2 * B + 2 * K + 2 * B * K))
    gk = time_plan("sketch_plan_minhash general",
                   SketchPlan(HashSpec(family="general", n=N, L=L),
                              mplan.sketches), mops,
                   nbytes=4 * (B * S + 2 * B + 2 * K + 2 * B * K))
    # the deduper's default stream_rows: a launch of few rows, which the
    # launcher spreads over the card with shorter segments
    Bd = dedup.DedupConfig().stream_rows
    opsd = {"sig": {**mops["sig"], "init": mops["sig"]["init"][:Bd]}}
    kd = lambda: sketch_fused.sketch_plan_fused(x[:Bd], None, nw[:Bd], opsd,
                                                plan=mplan, w_start=ws[:Bd])
    dms, _ = device_ms(torch, kd, 200)
    db, dby, _ = bound(mplan, Bd * CHUNK_S,
                       4 * (Bd * S + 2 * Bd + 2 * K + 2 * Bd * K))
    print(f"kernel[sketch_plan_minhash] default stream_rows B={Bd} S={S}: "
          f"{dms:.5f} ms per launch; bound {db:.5f} ms by {dby}; bound / time "
          f"{db / dms:.3f} (GENERAL at B={B}: {gk:.5f} ms) [{card}]")

    # the stats path's launch, with the stats instance's own parameters and
    # the registers and table its run over the corpus carried out: the state
    # every launch of the path but the first starts from
    ngc = ng["cyclic"]
    hll_spec, cms_spec = ngc.plan.sketches[0][1], ngc.plan.sketches[1][1]
    regs, table = fin["cyclic"]["hll"], fin["cyclic"]["cms"]
    hs = ngc.plan.hash
    x = ngc._lookup(rows[:, : S])
    cms_ops = {"a": ngc._cms_params["a"], "b": ngc._cms_params["b"],
               "init": table}
    rb = 4 * (B * S + 2 * B)                   # symbols, n_windows, w_start
    hll_plan = SketchPlan(hs, (("hll", hll_spec),))
    cms_plan = SketchPlan(hs, (("cms", cms_spec),))
    hll_bytes = rb + 2 * 4 * regs.numel()
    cms_bytes = rb + 2 * 4 * table.numel() + 8 * cms_spec.depth
    # the carry copied in (the first chunk of a block), then donated (every
    # other chunk: update_many folds into its own carry in place)
    time_plan("sketch_plan_hll copied", hll_plan, {"hll": {"init": regs}},
              nbytes=hll_bytes)
    time_plan("sketch_plan_hll donated", hll_plan, {"hll": {"init": regs}},
              replaces="src/repro/kernels/sketch_fused.py:381",
              launches=counts_dp["HLLSpec"], max_err=err["HLLSpec"],
              nbytes=hll_bytes, donate=True)
    # the first launch of a stream: registers at zero, so most windows
    # raise a register
    zero_regs = torch.zeros_like(regs)
    time_plan("sketch_plan_hll from zeroed registers", hll_plan,
              {"hll": {"init": zero_regs}}, nbytes=hll_bytes)
    time_plan("sketch_plan_countmin copied", cms_plan, {"cms": cms_ops},
              nbytes=cms_bytes)
    cms_ms = time_plan("sketch_plan_countmin donated", cms_plan,
                       {"cms": cms_ops},
                       replaces="src/repro/kernels/sketch_fused.py:381",
                       launches=counts_dp["CountMinSpec"],
                       max_err=err["CountMinSpec"], nbytes=cms_bytes,
                       donate=True)
    stats_ops = {"hll": {"init": regs}, "cms": cms_ops}
    stats_bytes = rb + 2 * 4 * (regs.numel() + table.numel())
    time_plan("sketch_plan_stats (hll + countmin) copied", ngc.plan,
              stats_ops, nbytes=stats_bytes)
    time_plan("sketch_plan_stats (hll + countmin) donated", ngc.plan,
              stats_ops, nbytes=stats_bytes, donate=True)
    time_plan("sketch_plan_stats (hll + countmin) from zeroed registers",
              ngc.plan, {"hll": {"init": zero_regs}, "cms": cms_ops},
              nbytes=stats_bytes)
    # the fourth case, checked only: zeroed registers with the carry donated
    # (timed, its registers would be warm after the first launch)
    zdon = {"hll": {"init": zero_regs.clone()},
            "cms": {**cms_ops, "init": table.clone()}}
    want = ref.sketch_plan_ref(ngc.plan, x, None, nw, zdon, w_start=ws)
    got = sketch_fused.sketch_plan_fused(x, None, nw, zdon, plan=ngc.plan,
                                         w_start=ws, donate=True)
    if any(not torch.equal(got[k], want[k]) for k in got):
        raise AssertionError("stats plan from zeroed registers, donated: "
                             "kernel != plain")
    print("check: the stats launch from zeroed registers with its carry "
          "donated: kernel == plain version on the card")

    # the launch's skeleton at this shape: stage, hash and the tile's
    # barriers under the lightest epilogue there is (MinHash with k = 1:
    # one multiply-add and min a window, one atomicMin a tile)
    skel = SketchPlan(hs, (("sig", MinHashSpec(k=1)),))
    sk_ops = {"sig": {"a": cms_ops["a"][:1].contiguous(),
                      "b": cms_ops["b"][:1].contiguous(),
                      "init": api.full_u32((B, 1), 0xFFFFFFFF, dev)}}
    time_plan("sketch_plan skeleton (minhash k=1)", skel, sk_ops,
              nbytes=rb + 8 * B + 8, donate=True)

    # the floor of any CountMin design with one global atomic an increment:
    # the same 4 x 524,288 increments of this launch, columns precomputed
    # (depth-major, as the table), issued by a kernel that does nothing else
    hw = (ref.window_hashes_ref(x, family=hs.family, n=hs.n, L=hs.L, p=hs.p)
          & hs.hash_mask)[:, :CHUNK_S].reshape(-1)
    ca, cb = (ref.u32.lanes(cms_ops[k]) for k in ("a", "b"))
    lw = cms_spec.log2_width
    cols = (((ref.u32.mulmod32(ca[:, None], hw[None, :]) + cb[:, None])
             & ref.u32.MASK32) >> (32 - lw)).to(torch.int32).contiguous()
    floor_table = torch.zeros_like(table)
    red_floor = _build.load(str(RED_FLOOR_SRC)).countmin_red_floor
    red_floor.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    red_floor.restype = ctypes.c_int

    def floor_launch():
        e = red_floor(cols.data_ptr(), hw.numel(), cms_spec.depth, lw,
                      floor_table.data_ptr(),
                      torch.cuda.current_stream().cuda_stream)
        if e != 0:
            raise RuntimeError(f"countmin_red_floor launch failed: {e}")

    floor_launch()
    fresh = sketch_fused.sketch_plan_fused(
        x, None, nw, {"cms": {k: v for k, v in cms_ops.items()
                              if k != "init"}}, plan=cms_plan, w_start=ws)
    if not torch.equal(floor_table, fresh["cms"]):
        raise AssertionError("countmin_red_floor: its table != the CountMin "
                             "epilogue's from zero")
    floor_ms, floor_host = device_ms(torch, floor_launch, 200)
    print(f"kernel[countmin_red_floor] {cms_spec.depth} x {hw.numel()} "
          f"increments into a ({cms_spec.depth}, {table.shape[1]}) int32 "
          f"table, columns precomputed ({4 * cols.numel()} bytes): "
          f"{floor_ms:.5f} ms per launch; the CountMin epilogue (donated) "
          f"takes {cms_ms / floor_ms:.3f} of it; the host takes "
          f"{floor_host:.5f} ms to issue one launch [{card}]")

    # the decontam path's launch: real packed tokens, the real filter
    x, xb = dc._lookups(rows[:, : S])
    probes = probes_needed(torch, ref, dc.plan, x, xb, dc.bits)
    bl_ops = {"bloom": {"bits": dc.bits,
                        "init": torch.zeros((B,), dtype=torch.int32,
                                            device=dev)}}
    time_plan("sketch_plan_bloom", dc.plan, bl_ops, xb=xb, probes=probes,
              replaces="src/repro/kernels/sketch_fused.py:381",
              launches=counts_dp["BloomSpec"], max_err=err["BloomSpec"],
              nbytes=4 * (2 * B * S + 2 * B + dc.bits.numel() + 2 * B))
    print(f"kernel[sketch_plan_bloom]: the filter's data needs {probes:.4f} "
          f"probes a window (k={dc.cfg.k})")

    # the Fig. 1 pair at (1024, 8192), L=32: n=8 (the path's, in the
    # kernels line, timed beside its plain version) and n=25 (the two
    # kernels alone, in turns)
    xr = rand_u32(torch, gen, (1024, 8192), dev)
    p32 = gf2.find_irreducible_host(32)
    for n in (N, 25):
        Wr = 8192 - n + 1
        pair = {"cyclic": (lambda: cyclic.cyclic_rolling(xr, n=n, L=L),
                           lambda: ref.cyclic_ref(xr, n, L),
                           "src/repro/kernels/cyclic.py:87"),
                "general": (lambda: general.general_rolling(xr, n=n, p=p32,
                                                            L=L),
                            lambda: ref.general_ref(xr, n, p32, L),
                            "src/repro/kernels/general.py:67")}
        for family, (kern, plain_fn, _) in pair.items():
            if not torch.equal(kern().to(torch.int64), plain_fn()):
                raise AssertionError(f"{family}_rolling: kernel != plain at "
                                     f"(1024, 8192) n={n}")
        if n != N:
            alone = dict(zip(pair, palindrome(
                torch, [k for k, _, _ in pair.values()], iters=100)))
        fig, fig_frac = {}, {}
        for family, (kern, plain_fn, src_line) in pair.items():
            if n == N:
                ms, plain_ms, kh, (k1, k2, p1, p2) = in_turns(
                    torch, kern, plain_fn, k_iters=100, p_iters=5)
                plain = (f"; plain version {plain_ms:.5f} ms ({p1:.5f}, "
                         f"{p2:.5f})")
                ms_text = f"{ms:.5f} ms per launch ({k1:.5f}, {k2:.5f})"
            else:
                ms, plain = alone[family], ""
                ms_text = f"{ms:.5f} ms per launch (in turns, kernels alone)"
            fig[family] = ms
            alu, lds = hash_ops(HashSpec(family=family, n=n, L=L))
            b_ms, by, text = roofline(1024 * Wr, 4 * 1024 * (8192 + Wr),
                                      alu, 0, lds)
            fig_frac[family] = b_ms / ms
            how = (f", route {general.route(n, p32, L)}"
                   if family == "general" else "")
            print(f"kernel[{family}_rolling] (1024, 8192) n={n} L={L}{how}: "
                  f"{ms_text}{plain}; bound {b_ms:.5f} ms by {by} ({text}); "
                  f"bound / time {b_ms / ms:.3f} [{card}]")
            if n == N:
                kernels.append({
                    "name": f"{family}_rolling", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/rolling.cu",
                    "replaces": src_line, "launches": counts_dp[family],
                    "max_abs_err": err[family], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                    "library_ms": None})
        print(f"fig1: GENERAL / CYCLIC time ratio "
              f"{fig['general'] / fig['cyclic']:.3f} at (1024, 8192), n={n}, "
              f"L={L}, of these kernels, which run at "
              f"{fig_frac['cyclic']:.3f} (CYCLIC) and "
              f"{fig_frac['general']:.3f} (GENERAL) of their bounds: a "
              f"reading of these kernels, not yet of the families (the "
              f"paper's claim: about 2) [{card}]")
    print(f"kernel times of the dedup and data-plane paths: "
          f"{time.perf_counter() - t_times:.1f} s")
    print(f"end to end: dedup add_batch {tokens / dt:.0f} tokens/s; stats "
          f"cyclic {n_stats / stats_s['cyclic']:.0f} tokens/s, general "
          f"{n_stats / stats_s['general']:.0f} tokens/s (idle share "
          f"{idle_stats:.4f}); decontam {n_dec / t_flag:.0f} tokens/s (idle "
          f"share {idle_dec:.4f}) [{card}]")
    # -- 7. the serve path, with its times ---------------------------------------
    t0 = time.perf_counter()
    entry, serve_tps, serve_ctx = serve_phase(torch, card, reset_counts,
                                              read_counts, err_decode)
    kernels.append(entry)
    print(f"serve phase: {time.perf_counter() - t0:.1f} s; generated "
          f"{serve_tps:.1f} tokens/s [{card}]")
    # -- 11. the sharded phase ------------------------------------------------
    t0 = time.perf_counter()
    sharded_phase(torch, card, reset_counts, read_counts, ng, dc, dp, dd,
                  gdd, docs, flags, rows, serve_ctx)
    del serve_ctx
    print(f"sharded phase: {time.perf_counter() - t0:.1f} s [{card}]")
    # -- 13. the train phase ------------------------------------------------
    train_s, train_tps = train_phase(torch, card, reset_counts, read_counts)
    print(f"train phase: {train_s:.1f} s; {train_tps:.0f} tokens/s [{card}]")
    # -- 14. the MoE and Mamba-2 units ----------------------------------------
    mm_s = moe_mamba_phase(torch, card, reset_counts, read_counts)
    print(f"moe_mamba phase: {mm_s:.1f} s [{card}]")
    # -- 15. the model mesh ---------------------------------------------------
    mesh_s = mesh_phase(torch, card, reset_counts, read_counts)
    print(f"mesh phase: {mesh_s:.1f} s [{card}]")
    # -- 16. the dry run on the card -------------------------------------------
    dry_s = dryrun_phase(torch, card)
    print(f"dryrun phase: {dry_s:.1f} s [{card}]")
    # -- 8. the byte-level path, with its times -----------------------------
    t0 = time.perf_counter()
    byte_entries, bytes_cps = bytes_phase(torch, card, reset_counts,
                                          read_counts)
    kernels.extend(byte_entries)
    print(f"bytes phase: {time.perf_counter() - t0:.1f} s; "
          f"{bytes_cps:.0f} chars/s [{card}]")
    # -- 12. the analyzer ---------------------------------------------------
    analysis_phase(torch, card, reset_counts, read_counts)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(f"launches: dedup path (cyclic add_batch) {launches}, general "
          f"add_batch {glaunches}; data plane path {json.dumps(counts_dp)}")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
