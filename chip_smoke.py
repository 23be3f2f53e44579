#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives ``src/repro_torch`` (never the JAX package) on the card, in phases
that each raise on failure; nothing is caught, so a failed phase ends the
run with a nonzero exit and no result line.

1. Environment: the card's name and power limit, torch and CUDA versions;
   build every kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   per source, all at once); where the toolkit has ``cuobjdump``, check
   that exactly the bf16 x bf16 paged-attention instantiations issue
   tensor-core (HMMA) instructions and that all load through cp.async;
   print every instantiation's registers and spill bytes beside the
   fixed-split kernel's (:data:`PTXAS_FIXED_SPLITS`).
2. Kernels: each kernel against its plain PyTorch version on the card over
   a sweep of cases, with the tolerance stated beside it (kernel 1 also
   over the split design's edge cases forced to 1, 2, 4 and 8 splits), then
   timed at the serving path's shapes beside its bound, its plain version
   and a library yardstick: call time (``ms``: CUDA events over 20
   back-to-back calls, which the host sets for short kernels) and device
   time (``device_ms``: torch.profiler's kernel time per call, L2 flushed
   before each call by a 256 MB write; ``library_device_ms`` counts every
   device op of the yardstick's call).  Kernel 1 is also timed on long
   rows (8 rows of 3072-4096 tokens) and at each forced split count beside
   the split rule's own counts.  Kernel 3
   (``paged_attention_sharded``) is kernel 1 launched once per shard on
   ``TP`` head slabs of one card; it is held against the plain version over
   the joined arena, and each head bit for bit against one launch over the
   whole arena, with and without the fused append.  The fused launch
   (``paged_attention_append_cuda``: kernel 2's append inside kernel 1's
   launch, the serving path's one launch per layer) is held bit for bit,
   arena and output, against ``kv_append_cuda`` + ``paged_attention_cuda``
   on a copy, its arena bit-exact and its output within kernel 1's
   tolerance against the plain version, over kernel 1's sweep, the split
   edge cases, long rows, GQA with two query groups, denied rows, -1 pages
   and page ids past the arena; then timed as kernel 1 is, beside the pair.
   Multi-query at head dim 256 (paligemma-3b's decoder: one KV head, 8
   query heads, 4 a shard): kernel 1 and the fused launch over the split
   edge cases (bf16, float32, float32 q over a bf16 arena; 1 and 2 splits
   and the rule's) and at the
   serving shapes, timed there; kernel 3 over a replicated arena (two
   copies, each shard appending the same K/V to its own) bit for bit one
   launch over all query heads, timed.  The same for granite-20b's
   decoder (48 query heads on one KV head of 128, 24 a shard), at kernel
   level only.  Kernel 3 over the per-shard
   KV-head slabs of a head count the TP degree does not divide (Hq=8,
   Hkv=2, D=128 over 4 shards: shards 0-1 on a one-head copy of KV head 0,
   2-3 of head 1; bf16, C = 1 and 16, without and with the fused append):
   every copy bit for bit its head of the whole launch's arena, the output
   within kernel 1's tolerance of the plain version and bit for bit one
   launch over the whole arena.  Kernel 3 where a shard's query slab
   straddles KV-head groups (Hq=6, Hkv=3, D=128 over 2 shards: shard 0 on
   KV heads 0-1, shard 1 on 1-2, each launch on its 3 query heads padded
   with zero heads to 4; bf16, C = 1 and 16, without and with the fused
   append): within kernel 1's tolerance of the plain version, every copy
   bit for bit its heads of the whole launch's arena (the shared head's
   two copies bitwise equal), the output bit for bit that launch's.
3. Parity: reduced olmo-1b and olmoe-1b-7b engines on the card against the
   same engines on the CPU (plain versions), float32 weights: generated
   tokens must agree.  Reduced whisper-tiny, recurrentgemma-9b and
   mamba2-780m through ``build_model`` (a 40-token prefill, 8 greedy
   steps), card against CPU on the same float32 weights: logits within
   1e-3, tokens equal.
4. Engines: full-width olmo-1b, olmoe-1b-7b (MoE: 64 experts top-8, the
   dropless expert layer in the fused step, each expert's hidden axis
   split at TP=2) and paligemma-3b (its text decoder: one KV head of 256,
   the arena replicated at TP=2) served through ``PagedServingEngine``,
   each at TP=1 and at ``tensor_parallel=TP`` with every shard on this
   card (``devices=["cuda:0"] * TP``), with seeded float32 weights and then
   the same weights in bf16 (the main path).  Each cell runs twice: with
   the runner's eager step, then through its captured CUDA graphs (the
   card's default, one graph a key; ``serving/runner.py``), and the graph
   run's tokens, block tables, snapshots, lengths, last tokens, pool
   (clock included) and arena must be bitwise the eager run's.  In each
   run every request must finish, the clock mirror must equal the pool's
   clock, the fused launch must run once per layer per shard per step
   (a replay adds what its capture recorded, a capture's dry step what
   an eager step launches; the graphs' recorded launches times their
   replays, and torch.profiler's count of the kernel in two steady
   steps, must give the same) and ``kv_append_cuda`` never, and a steady
   step must make exactly one device->host transfer; each run prints
   its wall and steady-step ms, device ms and ops a step and busy share,
   the graph run its captures' ms and the graph pool's bytes; over a
   replicated arena the shards' copies must
   be bitwise equal after the run, each the whole arena's bytes.  Across
   runs: in float32, TP=2 must equal TP=1 in tokens, and in the K/V of
   every position written within 2e-2 + 2e-2|x| (olmo-1b and paligemma;
   for olmoe wherever no router flip reaches: both float32 runs record
   every token's top-k expert set and the router's k-th minus (k+1)-th
   probability; every K/V element beyond the tolerance must lie
   downstream of a flip, and a flip no other flip reaches must be a near
   tie, its gap below 1e-4);
   in bf16, TP=2's K/V must stay
   as close to float32's as TP=1's do (mean abs difference within 1.25x),
   over the prompt positions and, apart, over the generated positions
   where both still feed the model float32's tokens; the tokens TP=2
   shares with TP=1 are printed.  Then olmoe-1b-7b at TP=2 under the
   reference's other expert layouts (``REPRO_MOE_SHARD``): ``ep`` (32
   whole experts a shard) in float32 and bf16, ``none`` (replicated, the
   layer run once on the lead) in bf16, each held as above and by its
   expert bytes per shard (half the whole set under ``ep``); float32
   ``ep``'s tokens must equal float32 ``tp``'s, its K/V held by the same
   routing check (routes are recorded in the eager runs: a replay runs
   no Python).  Roofline lines: one steady step of each of the
   olmo-1b bf16 TP=1 run and the olmoe bf16 ``tp`` and ``ep`` runs goes
   eagerly through ``launch/op_analysis.py`` (the fused launches' work
   added by ``attention_work``'s rules); its FLOPs and bytes, the H100
   bound they give and the graph run's mean steady-step wall time as a
   share of it are printed.
5. Fleet: full-width olmo-1b (the engine phase's configuration, 16
   requests unless stated) served by ``DataParallelEngine`` with both
   replicas on this card.  Each path has its launch counts set to 0 just
   before it and held just after: the fused launch once per layer, shard
   and engine step, the standalone append never.  Each replica steps on a
   CUDA stream of its own.  (a) bf16, the main path: the replicas' two
   streams distinct and not the default stream; in ``step()`` mode every
   step's launches per replica and exactly one read per replica in a
   steady step (sync debug mode); then threaded ``run()`` (the same
   tokens), ``step()`` and one engine on the same requests, each timed on
   its second drain (the first captures its graphs), and ``run()`` and
   one engine again with the eager step (the same tokens); the fleet's
   tokens/s over one engine's; the clock mirror per replica.
   Every replica serves through its step graphs, a threaded round's all
   captured before its driver threads start.  (b) Failover: a warmed
   fleet with ``auto_revive`` whose replica 0 is killed mid-decode; in
   float32 the stitched tokens must equal one engine's, with one failure,
   one revival and every request of the killed replica migrated; in bf16
   the equal tokens are printed.  Then in float32 replica 0 stalls, twice:
   a 30 s ``torch.cuda._sleep`` on its stream at its 20th driver
   iteration, and a 20 s one at its 4th (mid-prefill, the card test's
   point), its thread blocked in the step's read; the watchdog (2 s)
   fails it over and revives it on a new stream, and the fleet finishes
   every request, token-exact against one engine, while the stalled
   stream still sleeps; the round after the stall captures no graph, and
   the steps whose graph is missing run eagerly, counted (printed, and
   some must be).  (c) bf16 under ``ChaosConfig`` (denials, spurious
   invalidations, delayed frees, unmap-under-reader): in ``step()`` mode
   one read per replica per steady step; then on 64 pages a replica with
   a kill, timed against the same fleet fault-free: 0 lost,
   every fault kind fired, the clock mirror per replica once the frees
   the chaos layer still defers are applied and the clock ticks of its
   spontaneous releases added.  (d) float32 2 replicas x
   ``tensor_parallel=2`` (four shards on this card): tokens equal one
   TP=2 engine's (those equal to TP=1's are printed), 2 x 16 shard
   launches per replica step.  (e) A bursty two-class trace
   at 0.6x the requests/s one engine sustained in (a), replayed open-loop
   through ``launch/serve.py::_replay_trace``: 0 lost, TTFT percentiles
   per class.  (f) The CLI's ``main`` at its reduced size: ``--replicas
   2``, ``--classes --stream``, ``--trace``.
   (l) Heads the TP degree does not divide: full-width olmo-1b with 6
   query heads over 3 KV heads of 128, float32, served at TP=1 and at
   ``tensor_parallel=4`` on this card (``devices=["cuda:0"] * 4``), 8
   requests of 64-256 prompt tokens, 32 new each, through the step
   graphs: every shard holds the whole attention block and a whole copy of
   the arena and launches kernel 3 over all six query heads
   (``sharding/rules.py::heads_split``).  Held: TP=4's tokens equal
   TP=1's, the four copies bitwise equal after the run, each run's
   launches (4 x 16 fused launches a step at TP=4) and clock mirror.
6. Models (g): the non-paged path, ``build_model`` on the card at full
   width and depth for olmo-1b (512-token prompts), mamba2-780m (1000, no
   multiple of its SSD chunk), recurrentgemma-9b (2560: past its 2048
   window, misaligned with it, the chunked RG-LRU branch) and
   whisper-tiny (1500 seeded frames, 64 tokens), B=4, seeded weights in
   float32 then bf16 (the main dtype), each prefill followed by 64 greedy
   decode steps twice, over two copies of its cache: eagerly, and through
   ``models/graphs.py::graph_decode_step`` (one captured CUDA graph,
   replayed).  Held in float32: finite logits and states, ``len``, the
   decoded logits against teacher forcing over the same tokens within
   3e-2 abs+rel (5e-2 for the ring-windowed recurrentgemma), as the
   reference's tests allow.  Held in both dtypes: the graph run's tokens,
   logits and final cache bitwise the eager run's; every steady eager
   ``decode_step`` (the third on) and every graph call, the capturing
   one included, makes no device->host transfer (sync debug mode
   "error"); no kernel of the repository launches (counts set to 0
   before, read after) and the capture records none.  Printed: prefill
   ms (cold and warm), eager and graph decode ms/step and tokens/s, the
   capture's ms and its graph pool's bytes, and peak memory; bf16's
   greedy tokens equal to float32's, and olmo-1b bf16's equal to the
   paged engine's on the same prompts and weights (its arena is bf16:
   the equal prefix); roofline lines for olmo-1b bf16's prefill and its
   eager and graph decode step (counted by ``launch/op_analysis.py`` on
   fake tensors at the same shapes).
7. Training (h): (1) every reduced config, card against CPU in float32
   with TF32 off, from the same seeded weights and batch: ``Model.loss``
   within 1e-5 + 1e-4|x|, every gradient leaf within 1e-5 + 1e-3|x|, and
   one AdamW step's update within 1e-5 where the CPU's gradient exceeds
   1e-6 (2 lr elsewhere: a near-zero gradient may flip the sign of AdamW's
   first step).  (2) Full-width olmo-1b through
   ``launch/train.py::train`` on the card: B=4, S=1024, 8 steps of ramp
   data at lr 1e-4, a checkpoint every 4 steps into a temporary
   directory under ``build/`` (deleted afterwards; the free disk is
   printed first), a simulated failure at step 6, bf16 parameters and
   float32 moments.
   Held: every logged loss finite, exactly one failure and one restore,
   the final loss below the first, steps 2 and 3 (neither a log nor a
   checkpoint step) free of device->host transfers (sync debug mode
   "error" from the batch's upload to the step's end), no kernel of the
   repository launched, and the final checkpoint restored bit for bit
   into a fresh module and optimizer state.  Printed: ms/step (CUDA
   events), tokens/s, peak memory, checkpoint GB and seconds.  (3)
   mamba2-780m (S=1024) and whisper-tiny (448 tokens over 1500 frames) at
   full width, B=4, 3 steps each through ``make_train_step``: finite
   losses, peak memory and step times printed.  A roofline line for
   olmo-1b's step, counted as phase (g)'s.
8. The sharded step (i): ``init_distributed`` over NCCL at world size 1,
   ``make_device_mesh((1, 1))`` on the card, and full-width olmo-1b (B=4,
   S=1024) through ``launch/steps.py::sharded`` against the same work
   unsharded from the same weights.  (1) float32 with TF32 off: the loss
   and every gradient of step 1 within 1e-4 abs+rel, and each
   parameter's change by one ``make_train_step`` within 1e-3 relative L2
   of the unsharded change (a skipped update gives 1, a flipped one 2).
   (2) bf16, printed: which of step 1's gradient leaves are bitwise, and
   the sharded path's ``global_norm`` and vocab-parallel cross-entropy
   against their plain versions on the same values.  (3) bf16 parameters,
   float32 moments, ``make_train_step`` with ``step_specs`` for 3 steps of
   ramp data: each loss within 1e-5 + 1e-4|x| (phase (h)'s), each
   parameter's change from its initial value within 0.5 relative L2 of
   the unsharded change, the third step free of device->host transfers
   (sync debug mode "error"), every parameter a DTensor on the mesh
   afterwards, no kernel launched.  Printed: whether losses and
   parameters are bitwise, ms/step of both beside phase (h)'s.  The process group is
   destroyed afterwards.  (A card cannot hold two NCCL ranks: multi-rank
   runs are the CPU tests' gloo worlds.)
9. The pool's public functions (j), at a deployment's size: 32768 pages
   (a full-depth olmo-1b page of 16 bf16 tokens is 2 MiB, so 64 GiB of
   KV) in superblocks of 8, 64 rows.  (1) A seeded sequence of 300
   public calls (``alloc_pages_batch`` with ``max_grow=4``,
   ``alloc_pages``, ``share_pages``, ``unshare_pages``/``free_pages``,
   ``release_empty_superblocks``/``map_superblocks`` with ints and 0-dim
   tensors, ``snapshot_versions``, ``validate_and_commit``,
   ``validate_read``) on a pool on the card and one on the CPU: after
   every call the six state tensors and every returned value bitwise
   equal; over the card's run no page granted twice while live, a version
   moved only by a zero-transition or a release (+1), the clock equal to
   the batches that reclaimed something.  ``append_kv`` and ``gather_kv``
   bitwise card against CPU over the same writes (−1 pages, positions past
   the table, ids past the arena).  (2) Each of the 13 public functions
   called once under sync debug mode "error".  (3) The OA read protocol
   with kernel 1: one layer's arena from ``kv_pages_init(32768, 16, 16,
   128)`` (4.3 GB bf16), 64 rows grown by ``alloc_pages_batch`` and
   written by ``append_kv`` over 200 steps, ``snapshot_versions``, kernel
   1 (``kernels/ops.py::paged_attention``) within 2e-2 of plain attention
   over ``gather_kv``'s rows; then a third of the rows freed, their pages
   re-granted to other rows and overwritten, one superblock released;
   kernel 1 through the stale tables (finite: the arena is persistent),
   ``validate_and_commit`` and ``validate_read`` false for exactly the
   moved rows, the other rows' outputs bitwise those of the first read;
   kernel 1 launched exactly twice.  Printed: each public function's call
   ms (CUDA events, 20 calls).
10. The host layer (k), on the card's host: ``benchmarks/memory_release.py
   ::run(quick=False)`` through ``repro_torch.core`` — 100000 keys into a
   ``MichaelHashTable`` under ``OAVer`` over ``LRMalloc(512 x 64 KiB)``,
   each ``ReleaseStrategy``, all deleted, ``flush``, ``flush_all_caches``,
   then the keys inserted again.  Held: every insert and delete true, the
   table empty, ``nodes_freed`` over 90% of the keys, superblocks retired
   (``persistent_released`` > 0: the reference counts the EMPTY
   transition under every strategy; under ``KEEP`` no remap and Pss kept
   within 90%, as ``tests/test_allocator.py`` holds it), every
   superblock's range read back, the second fill taking fewer fresh
   superblocks than the first and reusing parked ranges; the
   ``Allocator`` protocol exerciser of ``tests/test_layering.py`` on
   ``HostAllocator`` and on a ``DevicePagePool`` on the card; no kernel
   launched.  Printed, not held: peak and after Pss and Rss, whether they
   shrank, superblocks, seconds.
11. Examples (m): the README's four examples over the port
   (``examples/*_torch.py``) on the card at their default sizes: the
   quickstart (host layer, serving with its prefix cache, 40 training
   steps on random tokens: the loss must stay within 0.1 of ln V),
   serve_paged (its four workloads through the serving CLI),
   train_lm (300 reduced steps, a checkpoint every 100, a failure at 150:
   the loss must fall through the restart) and reclaim_demo (the three
   release strategies' /proc residency, then the device pool's burst,
   ``shrink()`` and next burst).  Each serving path's launches are set to
   0 before it and held after it (the fused launch once per layer a step;
   the training demos launch none of the repository's kernels); each
   demo's numbers print on lines of their own.
12. Dry run: ``launch/dryrun.py`` on olmo-1b ``train_4k`` and qwen2-72b
   ``decode_32k`` on the production mesh, in a child process that sees no
   card (started after the build, collected at the end): each cell's
   sharded step runs as rank 0 of a fake process group of 256 ranks.
   Both records ``ok``, their collective bytes by kind and their dot
   FLOPs equal to the CPU container's (:data:`DRYRUN_COLLECTIVES`,
   :data:`DRYRUN_DOT_FLOPS`), rendered through
   ``launch/roofline.py``.  The same child counts phases (g)'s and (h)'s
   olmo-1b steps on fake tensors, off the card's path; their roofline
   lines print at the end.

The second-to-last line is the ``kernels`` JSON (kernel 1, kernel 2, the
sharded kernel 3 and the fused launch; launches from the olmoe-1b-7b bf16
TP=1 run for kernels 1 and 2 and the fused launch, from its bf16 TP=2 run
for kernel 3 — paligemma's are in its own log lines; kernel 1 counts
its launches with and without the append, kernel 2 is off the serving path
and counts 0); the last line is ``{"ok": true, "device": {...}}``.  Exits
nonzero without CUDA.  ``--profile`` adds a torch.profiler breakdown of
steady full-width decode steps, eager and then replaying the captured
step (olmo-1b at TP=1 and TP=2, olmoe-1b-7b at TP=1 with its expert
layer alone at the step's shapes, paligemma-3b at TP=2) after the fleet
phase, the device time of the fleet's drain beside the fleet phase's
wall times, and 5 steady non-paged decode steps of olmo-1b bf16 (phase
(g)'s shapes), eager and replaying ``graph_decode_step``'s graph: wall
and device ms a step, busy share.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import pathlib
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))  # split_cases: numpy only

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, per data sheet
PA_SRC = "src/repro_torch/kernels/csrc/paged_attention.cu"
KA_SRC = "src/repro_torch/kernels/csrc/kv_append.cu"
PA_TPU = "src/repro/kernels/paged_attention.py:156"
KA_TPU = "src/repro/kernels/kv_append.py:46"
PS_TPU = "src/repro/kernels/paged_attention.py:218"
TP = 2  # shards of the tensor-parallel checks, all on this card
#: [registers, stack-frame bytes, spill-store bytes, spill-load bytes] of
#: each paged-attention instantiation as built before the split rule, when
#: one split count served every launch (commit fa569a4:
#: ``tools/ptxas_report.py`` on its source, nvcc 12.8; kv_append.cu is
#: unchanged since)
PTXAS_FIXED_SPLITS = {
    "paged_attention_kernel<bf16,bf16,128,0>": [125, 0, 0, 0],
    "paged_attention_kernel<bf16,bf16,128,1>": [128, 0, 0, 0],
    "paged_attention_kernel<bf16,bf16,16,0>": [96, 16, 12, 12],
    "paged_attention_kernel<bf16,bf16,16,1>": [96, 16, 12, 12],
    "paged_attention_kernel<bf16,bf16,256,0>": [192, 0, 0, 0],
    "paged_attention_kernel<bf16,bf16,256,1>": [216, 0, 0, 0],
    "paged_attention_kernel<bf16,bf16,32,0>": [96, 16, 12, 12],
    "paged_attention_kernel<bf16,bf16,32,1>": [109, 0, 0, 0],
    "paged_attention_kernel<bf16,bf16,64,0>": [96, 16, 16, 24],
    "paged_attention_kernel<bf16,bf16,64,1>": [125, 0, 0, 0],
    "paged_attention_kernel<bf16,f32,128,0>": [146, 0, 0, 0],
    "paged_attention_kernel<bf16,f32,16,0>": [96, 16, 12, 12],
    "paged_attention_kernel<bf16,f32,256,0>": [228, 0, 0, 0],
    "paged_attention_kernel<bf16,f32,32,0>": [116, 0, 0, 0],
    "paged_attention_kernel<bf16,f32,64,0>": [126, 0, 0, 0],
    "paged_attention_kernel<f32,bf16,128,0>": [128, 0, 0, 0],
    "paged_attention_kernel<f32,bf16,128,1>": [154, 0, 0, 0],
    "paged_attention_kernel<f32,bf16,16,0>": [96, 16, 12, 12],
    "paged_attention_kernel<f32,bf16,16,1>": [103, 0, 0, 0],
    "paged_attention_kernel<f32,bf16,256,0>": [238, 0, 0, 0],
    "paged_attention_kernel<f32,bf16,256,1>": [236, 0, 0, 0],
    "paged_attention_kernel<f32,bf16,32,0>": [96, 16, 12, 12],
    "paged_attention_kernel<f32,bf16,32,1>": [111, 0, 0, 0],
    "paged_attention_kernel<f32,bf16,64,0>": [114, 0, 0, 0],
    "paged_attention_kernel<f32,bf16,64,1>": [126, 0, 0, 0],
    "paged_attention_kernel<f32,f32,128,0>": [146, 0, 0, 0],
    "paged_attention_kernel<f32,f32,128,1>": [168, 0, 0, 0],
    "paged_attention_kernel<f32,f32,16,0>": [96, 16, 12, 12],
    "paged_attention_kernel<f32,f32,16,1>": [96, 8, 16, 20],
    "paged_attention_kernel<f32,f32,256,0>": [228, 0, 0, 0],
    "paged_attention_kernel<f32,f32,256,1>": [232, 0, 0, 0],
    "paged_attention_kernel<f32,f32,32,0>": [116, 0, 0, 0],
    "paged_attention_kernel<f32,f32,32,1>": [120, 0, 0, 0],
    "paged_attention_kernel<f32,f32,64,0>": [126, 0, 0, 0],
    "paged_attention_kernel<f32,f32,64,1>": [126, 0, 0, 0],
}


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def live_err(got, want, cl, label, share=None):
    """Kernel 1's output ``got`` against its plain version ``want``: the
    largest difference over the live query slots, after checking that
    every padded slot (c >= ``cl``) is exactly zero (the kernel's header
    note, point 8; ``tests/split_cases.py::live_error``) and, with
    ``share``, that no row's difference passes ``share`` of its live RMS
    (``split_cases.live_share``, logged)."""
    from split_cases import live_error, live_share

    err, stray, _ = live_error(got, want, cl)
    check(stray == 0, f"{label}: {stray} elements of padded query slots "
          f"are not zero")
    if share is not None:
        worst = live_share(got, want, cl)
        log(f"{label}: a row's live max err at most {worst:.2%} of its live "
            f"RMS (limit {share:.0%})")
        check(worst <= share, f"{label}: a row's max err is {worst} of its "
              f"live RMS, above {share}")
    return err


def time_ms(fn, iters=20, warmup=3):
    """Call time: mean time of one call of ``fn`` in ms over ``iters``
    back-to-back calls (CUDA events around the loop), which the host's
    enqueue time sets when a call's device work is shorter."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_FLUSH = []


def device_ms(fn, match=None, iters=20):
    """Device time: mean device time of one call of ``fn`` in ms, from
    torch.profiler's kernel records, each call after a 256 MB write that
    leaves the 50 MB L2 cold (as each layer's arena slab is in the engine).
    Counts the kernels whose name holds ``match``, or with ``match=None``
    every device op of the call; never the flush's.  A trace with no such
    device time (the profiler has returned one on the H100, for 20 calls
    that launched 40 of the kernels it looked for) is logged and taken
    again, three traces at most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not _FLUSH:
        _FLUSH.append(torch.zeros(256 * 2**20, dtype=torch.uint8,
                                  device="cuda"))
    flush = _FLUSH[0]
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        total = 0.0
        seen = []
        for ev in prof.key_averages():
            dev = getattr(ev, "self_device_time_total",
                          getattr(ev, "self_cuda_time_total", 0))
            if dev > 0 and str(ev.device_type).endswith("CUDA"):
                seen.append(ev.key[:40])
                if "bitwise_not" not in ev.key and (match is None
                                                    or match in ev.key):
                    total += dev
        if total > 0:
            return total / 1e3 / iters
        log(f"device_ms: trace {attempt} of 3 holds no device time for "
            f"{match}; its device ops: {seen}")
    check(False, f"the profiler recorded no device time for {match}")


# ---------------------------------------------------------------------------
# phase 2: kernels


def attention_case(B, C, Hq, Hkv, D, page, P, M, dtype, seed, lens=None):
    """Random paged-attention inputs: ragged lengths, chunks straddling
    pages, rows finishing mid-chunk, -1 holes, one row of length 0."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    kp = torch.randn((P, page, Hkv, D), generator=g, device="cuda").to(dtype)
    vp = torch.randn((P, page, Hkv, D), generator=g, device="cuda").to(dtype)
    q = torch.randn((B, C, Hq, D), generator=g, device="cuda").to(dtype)
    bt = np.full((B, M), -1, np.int32)
    perm = rng.permutation(P)
    used = 0
    ln = np.zeros(B, np.int32)
    cl = np.ones(B, np.int32)
    for b in range(B):
        n = int(rng.integers(1, M + 1)) if lens is None else \
            -(-int(lens[b]) // page)
        bt[b, :n] = perm[used:used + n] if used + n <= P else \
            rng.integers(0, P, n)
        used += n
        ln[b] = rng.integers(1, n * page + 1) if lens is None else lens[b]
        cl[b] = rng.integers(1, min(C, max(int(ln[b]), 1)) + 1)
        if lens is None and n > 2 and b % 3 == 1:
            bt[b, rng.integers(0, n - 1)] = -1  # an interior unmapped page
    if lens is None:
        ln[-1], cl[-1] = 0, 1  # a row of length 0 gives zeros
    T = lambda a: torch.as_tensor(a, device="cuda")
    return q, kp, vp, T(bt), T(ln), T(cl)


def attention_work(q, kp, bt, ln, cl, window=0):
    """(bytes, ops) this call must move and do, from this run's data: each
    live query slot's q read and output written once, each mapped K/V
    token of a row read once (with a window W, only from the page of the
    chunk's first window start on), those block table entries and the
    lengths read; 4*D ops per live (query, key) pair."""
    import numpy as np

    B, C, Hq, D = q.shape
    page, Hkv = kp.shape[1], kp.shape[2]
    el = kp.element_size()
    bt_h, ln_h, cl_h = (t.cpu().numpy() for t in (bt, ln, cl))
    kv_tokens = pairs = bt_reads = slots = 0
    for b in range(B):
        L, CL = int(ln_h[b]), min(max(int(cl_h[b]), 0), C)
        n = min(-(-L // page), bt_h.shape[1])
        p_lo = min(max(L - CL + 1 - window, 0) // page, n) if window else 0
        bt_reads += n - p_lo
        mapped = np.repeat(bt_h[b, :n] >= 0, page)[:L]
        kv_tokens += int(mapped[p_lo * page:].sum())
        slots += CL
        for c in range(CL):
            lim = max(min(L - CL + c + 1, L), 0)
            pairs += int(mapped[max(lim - window, 0) if window else 0:lim]
                         .sum())
    byts = (2 * slots * Hq * D * q.element_size()
            + 2 * kv_tokens * Hkv * D * el + 4 * (bt_reads + 2 * B))
    ops = 4 * D * pairs * Hq
    return byts, ops


def bound_ms(byts, ops, dtype_name):
    return max(byts / H100_BYTES_PER_S, ops / PEAK_OPS[dtype_name]) * 1e3, \
        "bytes" if byts / H100_BYTES_PER_S >= ops / PEAK_OPS[dtype_name] \
        else "operations"


def sdpa_yardstick(q, kp, vp, bt, ln, cl):
    """One gather plus ``scaled_dot_product_attention`` computing the same
    function (timed only; the port never calls it).  The gather keeps only
    the block-table columns this run's longest row reaches."""
    import torch
    import torch.nn.functional as F

    B, C, Hq, D = q.shape
    page, Hkv = kp.shape[1], kp.shape[2]
    n = min(-(-int(ln.max().item()) // page), bt.shape[1])
    bt_n = bt[:, :n].long()
    S = n * page
    pos = torch.arange(S, device="cuda")
    qpos = (ln - cl)[:, None].long() + torch.arange(C, device="cuda")[None]
    lim = torch.minimum(qpos + 1, ln[:, None].long())
    mapped = (bt_n >= 0).repeat_interleave(page, dim=1)
    mask = (pos[None, None] < lim[:, :, None]) & mapped[:, None]  # [B,C,S]
    qh = q.transpose(1, 2)  # [B, Hq, C, D]

    def call():
        idx = bt_n.clamp(min=0)
        k = kp[idx].reshape(B, S, Hkv, D).transpose(1, 2)
        v = vp[idx].reshape(B, S, Hkv, D).transpose(1, 2)
        gqa = {} if Hq == Hkv else {"enable_gqa": True}
        return F.scaled_dot_product_attention(qh, k, v,
                                              attn_mask=mask[:, None], **gqa)
    return call


def append_case(lens):
    """Kernel 2's inputs at the serving path's shapes: one new bf16 token
    for each of 8 rows of ``lens`` tokens into a zeroed 512-page arena of
    16 heads of 128.  Returns (arena k, arena v), k_new, v_new, block
    tables, lengths, n_new, write_ok."""
    import numpy as np
    import torch

    B, C, Hkv, D, page, P, M = 8, 1, 16, 128, 16, 512, 512
    bt = torch.as_tensor(np.random.default_rng(8).permutation(P)[: B * 32]
                         .reshape(B, 32).astype(np.int32), device="cuda")
    bt = torch.cat([bt, torch.full((B, M - 32), -1, dtype=torch.int32,
                                   device="cuda")], 1)
    ln = torch.as_tensor(lens.astype(np.int32), device="cuda")
    n_new = torch.ones(B, dtype=torch.int32, device="cuda")
    ok = torch.ones(B, dtype=torch.bool, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(8)
    kn, vn = (torch.randn((B, C, Hkv, D), generator=g, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    arena = [torch.zeros((P, page, Hkv, D), dtype=torch.bfloat16,
                         device="cuda") for _ in range(2)]
    return arena, kn, vn, bt, ln, n_new, ok


def attention_row(case, label, plain_iters=5):
    """Kernel 1 on ``case`` against its plain version, timed beside its
    bound and the gather + SDPA yardstick, in call time and device time;
    then its device time with every row forced to 1, 2, 4 and 8 splits,
    beside the split rule's (``row_splits``: the row's own count).  Logs
    and returns the row."""
    import numpy as np
    import torch

    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_plain,
                                                     row_splits)

    err = live_err(paged_attention_cuda(*case), paged_attention_plain(*case),
                   case[5], label)
    byts, ops = attention_work(case[0], case[1], *case[3:])
    b_ms, by = bound_ms(byts, ops, "bfloat16")
    yard = sdpa_yardstick(*case)
    row = dict(
        max_abs_err=err,
        ms=time_ms(lambda: paged_attention_cuda(*case)),
        device_ms=device_ms(lambda: paged_attention_cuda(*case),
                            "paged_attention_kernel"),
        plain_ms=time_ms(lambda: paged_attention_plain(*case),
                         iters=plain_iters),
        bound_ms=b_ms, bound_by=by, library_ms=time_ms(yard),
        library_device_ms=device_ms(yard))
    row["bound_share"] = b_ms / row["device_ms"]
    sweep = {S: device_ms(lambda: paged_attention_cuda(*case, _splits=S),
                          "paged_attention_kernel") for S in (1, 2, 4, 8)}
    torch.cuda.synchronize()
    q, kp, _, bt, ln, _ = case
    page, D = kp.shape[1], kp.shape[3]
    pages = np.minimum(-(-ln.cpu().numpy() // page), bt.shape[1])
    rule = sorted({row_splits(int(n), D, page) for n in pages})
    log(f"{label}: " + json.dumps(row))
    log(f"{label}: device ms with every row forced to S splits "
        + json.dumps(sweep) + f"; the rule's {row['device_ms']:.5f} (its "
        f"rows' split counts {rule}); {byts / 1e6:.1f} MB moved")
    return row


#: trinity-mini's mixed [64, 32] step at kernel level (kernel table row
#: 1m): 32 query heads on 4 KV heads of 128, rows of 6-8k tokens of which
#: 29 prefill a chunk of 32 and the rest decode one token, the block table
#: as wide as the cell's (``max_pages_per_seq``); 8 full layers and 24 of
#: window 2048 a step
MIXED_STEP = dict(B=64, C=32, Hq=32, Hkv=4, D=128, prefilling=29, M=1088,
                  layers={0: 8, 2048: 24})


def mixed_step_row():
    """Kernel 1 with the fused append (the serving launch) at
    :data:`MIXED_STEP`: checked by :func:`fused_check` at W = 0 and 2048,
    each row's live slots within ``split_cases.LIVE_RMS_SHARE`` of their
    RMS, then
    timed at both beside the bound of the live work (each live slot's
    pairs, the K/V a row's launch must read, the appended tokens written),
    and the step's kernel-1 time and bound from its layers.  Logs and
    returns the row."""
    import numpy as np
    import torch
    from split_cases import LIVE_RMS_SHARE

    from repro_torch.kernels.paged_attention import (
        paged_attention_append_cuda)

    m = MIXED_STEP
    B, C = m["B"], m["C"]
    lens = np.random.default_rng(21).integers(6000, 8193, B)
    case = attention_case(B, C, m["Hq"], m["Hkv"], m["D"], 16,
                          int((-(-lens // 16)).sum()) + 8, m["M"],
                          torch.bfloat16, seed=21, lens=lens)
    q, kp, vp, bt, ln, cl = case
    prefill = np.random.default_rng(22).permutation(B) < m["prefilling"]
    cl.copy_(torch.as_tensor(np.where(prefill, C, 1).astype(np.int32)))
    kn, vn, ok = append_inputs(case, seed=21, deny=None)
    row = {"prefilling": int(prefill.sum()), "decoding": int(B - prefill.sum())}
    arena = [kp.clone(), vp.clone()]  # the timed launches append into it
    step_ms = step_bound = 0.0
    for W, layers in m["layers"].items():
        err = fused_check(q, kp, vp, kn, vn, bt, ln, cl, ok,
                          f"mixed step W={W}", window=W,
                          share=LIVE_RMS_SHARE)
        byts, ops = attention_work(q, kp, bt, ln, cl, window=W)
        byts += 2 * int(cl.sum()) * m["Hkv"] * m["D"] * kp.element_size() + B
        b_ms, by = bound_ms(byts, ops, "bfloat16")

        def launch():
            paged_attention_append_cuda(q, *arena, kn, vn, bt, ln, cl, ok,
                                        window=W)
        dev = device_ms(launch, "paged_attention_kernel")
        row[f"w{W}"] = dict(max_abs_err=err, ms=time_ms(launch),
                            device_ms=dev, bound_ms=b_ms, bound_by=by,
                            bound_share=b_ms / dev)
        step_ms += layers * dev
        step_bound += layers * b_ms
    row.update(step_device_ms=step_ms, step_bound_ms=step_bound,
               step_bound_share=step_bound / step_ms)
    log("paged_attention_append mixed step [64, 32] (trinity-mini's "
        "shapes): " + json.dumps(row))
    return row


def kernel_phase(results):
    import numpy as np
    import torch

    from repro_torch.kernels.kv_append import kv_append_cuda, kv_append_plain
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_plain)

    # -- kernel 1: correctness sweep -----------------------------------------
    # tolerance: float32 differs from the plain version only by summation
    # order (1e-4 abs on outputs of order 1); bfloat16 outputs may round to
    # neighbouring bf16 values (one ulp is 2^-7 relative: 2e-2 abs)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    worst = 0.0
    n_cases = 0
    sweep = []
    for dtype in (torch.bfloat16, torch.float32):
        for C in (1, 16):
            for ppcb in (1, 2, 4):
                sweep.append((8, C, 16, 16, 128, 16, 512, 24, dtype, ppcb))
        sweep.append((8, 16, 32, 8, 128, 16, 256, 20, dtype, 2))  # GQA 4:1
        sweep.append((5, 16, 16, 16, 128, 16, 64, 7, dtype, 4))  # M % 4 != 0
    for i, (B, C, Hq, Hkv, D, page, P, M, dtype, ppcb) in enumerate(sweep):
        q, kp, vp, bt, ln, cl = attention_case(B, C, Hq, Hkv, D, page, P, M,
                                               dtype, seed=100 + i)
        got = paged_attention_cuda(q, kp, vp, bt, ln, cl, ppcb)
        want = paged_attention_plain(q, kp, vp, bt, ln, cl)
        err = live_err(got, want, cl, f"paged_attention case {i}")
        check(math.isfinite(err) and err <= tol[dtype],
              f"paged_attention case {i} {sweep[i]}: max err {err}")
        check(bool((got[-1] == 0).all()) or int(ln[-1]) > 0,
              "a row of length 0 must give zeros")
        worst = max(worst, err) if dtype == torch.bfloat16 else worst
        n_cases += 1
    log(f"paged_attention: {n_cases} cases match the plain version "
        f"(bf16 tol 2e-2, f32 tol 1e-4); worst bf16 err {worst:.3g}")

    # -- kernel 1: the split design's edge cases, at every split count -------
    # (the cases of the tests, ``tests/split_cases.py``, at page 16, D 128)
    from split_cases import split_edge_case

    n_cases = 0
    for S in (1, 2, 4, 8):
        for C, Hq, Hkv in ((1, 16, 16), (16, 16, 16), (16, 32, 8)):
            arrays = [torch.as_tensor(a, device="cuda") for a in
                      split_edge_case(S, 16, C, Hq, Hkv, 128,
                                      seed=400 + 10 * S + C)]
            for dtype in (torch.bfloat16, torch.float32):
                case = [a.to(dtype) for a in arrays[:3]] + arrays[3:]
                got = paged_attention_cuda(*case, _splits=S)
                want = paged_attention_plain(*case)
                err = live_err(got, want, case[5], f"split edge S={S}")
                check(math.isfinite(err) and err <= tol[dtype],
                      f"paged_attention split edge S={S} C={C} Hq={Hq} "
                      f"Hkv={Hkv} {dtype}: max err {err}")
                check(bool((got[4] == 0).all()), "a row of length 0 must "
                      "give zeros")
                n_cases += 1
    log(f"paged_attention: {n_cases} split edge cases (S in 1, 2, 4, 8; "
        f"1-token row, row shorter than S pages, a split of -1 pages, a "
        f"horizon across a split boundary, length 0, a clamped page id) "
        f"match the plain version")

    # -- kernel 1 timed at the serving path's shapes ---------------------------
    # full olmo-1b engine: B=8 rows, block table width 512 (= num_pages),
    # 16 heads of 128, bf16 arena of 512 pages of 16 tokens; lengths as in
    # the engine phase mid-decode (prompt 64..256 plus 16 generated)
    lens = np.random.default_rng(7).integers(64, 257, 8) + 16
    rows = {}
    for C in (1, 16):
        case = attention_case(8, C, 16, 16, 128, 16, 512, 512, torch.bfloat16,
                              seed=7, lens=lens)
        case[5].fill_(C)
        rows[C] = attention_row(case, f"paged_attention C={C}")
    # the same kernel on long rows, where bytes dominate: 8 rows of
    # 3072..4096 tokens over a 2048-page arena (~0.24 GB a launch)
    long_lens = np.random.default_rng(9).integers(3072, 4097, 8)
    case = attention_case(8, 1, 16, 16, 128, 16, 2048, 512, torch.bfloat16,
                          seed=9, lens=long_lens)
    case[5].fill_(1)
    attention_row(case, "paged_attention long rows C=1", plain_iters=2)
    results["paged_attention"] = dict(
        name="paged_attention", route="cuda", source=PA_SRC, replaces=PA_TPU,
        **rows[1])
    results["paged_attention_c16"] = rows[16]
    results["paged_attention_mixed_step"] = mixed_step_row()

    sharded_kernel(results, lens)

    # -- kernel 2: bit-exact sweep ---------------------------------------------
    # Hkv=16 is the TP=1 arena; Hkv=8 with a table of 512 pages is the
    # per-shard slab the TP=2 engine hands the kernel (2048-byte rows)
    cases = [(1, torch.bfloat16, 16, 12), (16, torch.bfloat16, 16, 12),
             (16, torch.float32, 16, 12), (1, torch.float32, 16, 12),
             (1, torch.bfloat16, 8, 512), (16, torch.bfloat16, 8, 512)]
    for i, (C, dtype, Hkv, M) in enumerate(cases):
        B, D, page, P = 8, 128, 16, 512
        rng = np.random.default_rng(200 + i)
        bt = np.full((B, M), -1, np.int32)
        bt[:, :10] = rng.permutation(P)[: B * 10].reshape(B, 10)
        bt[2, 3] = -1  # an unmapped page inside a chunk
        ln = rng.integers(0, 9 * page, B).astype(np.int32)
        ln[5] = M * page - 3  # tokens past the table width are skipped
        n_new = rng.integers(1, C + 1, B).astype(np.int32)
        ok = rng.random(B) > 0.2
        T = lambda a: torch.as_tensor(a, device="cuda")
        g = torch.Generator(device="cuda")
        g.manual_seed(i)
        kn = torch.randn((B, C, Hkv, D), generator=g, device="cuda").to(dtype)
        vn = torch.randn((B, C, Hkv, D), generator=g, device="cuda").to(dtype)
        arena = [torch.randn((P, page, Hkv, D), generator=g,
                             device="cuda").to(dtype) for _ in range(2)]
        mine = [a.clone() for a in arena]
        kv_append_cuda(*mine, kn, vn, T(bt), T(ln), T(n_new), T(ok))
        kv_append_plain(*arena, kn, vn, T(bt), T(ln), T(n_new), T(ok))
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(mine, arena)),
              f"kv_append case {i} {cases[i]}: not bit-exact")
    log(f"kv_append: {len(cases)} cases bit-exact against the plain version "
        f"(Hkv 16 and the TP={TP} slab's 8)")

    # -- kernel 2 timed at the serving path's shapes ---------------------------
    B, C, Hkv, D = 8, 1, 16, 128
    mine, kn, vn, bt, ln, n_new, ok = append_case(lens)
    arena = [a.clone() for a in mine]
    kv_append_cuda(*mine, kn, vn, bt, ln, n_new, ok)
    kv_append_plain(*arena, kn, vn, bt, ln, n_new, ok)
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(mine, arena))
    check(err == 0, f"kv_append at the serving shapes: max err {err}")
    pos = ln.long()
    page = mine[0].shape[1]
    pidx = bt.long().gather(1, (pos // page)[:, None])[:, 0]
    sidx = pos % page

    def library():
        arena[0].index_put_((pidx, sidx), kn[:, 0])
        arena[1].index_put_((pidx, sidx), vn[:, 0])

    def mine_call():
        kv_append_cuda(*mine, kn, vn, bt, ln, n_new, ok)
    row_bytes = Hkv * D * 2
    byts = 2 * 2 * B * C * row_bytes + 4 * 3 * B
    b_ms, by = bound_ms(byts, 0, "bfloat16")
    results["kv_append"] = dict(
        name="kv_append", route="cuda", source=KA_SRC, replaces=KA_TPU,
        max_abs_err=err, ms=time_ms(mine_call),
        device_ms=device_ms(mine_call, "kv_append_kernel"),
        plain_ms=time_ms(lambda: kv_append_plain(*arena, kn, vn, bt, ln,
                                                 n_new, ok)),
        bound_ms=b_ms, bound_by=by, library_ms=time_ms(library),
        library_device_ms=device_ms(library))
    log("kv_append C=1: " + json.dumps(
        {k: v for k, v in results["kv_append"].items()
         if k not in ("name", "route", "source", "replaces")}))

    fused_kernel(results, lens)
    mqa_kernel(results, lens)
    gqa_slab_kernel(lens)


def append_inputs(case, seed, deny=1):
    """The fused append's k_new, v_new [B, C, Hkv, D] (the arena's dtype)
    and write_ok [B] (row ``deny`` False, None for none) for an
    :func:`attention_case`; its row of length 0 gets chunk length 0 (rows
    need ``chunk_lens <= lengths``)."""
    import torch

    q, kp, vp, bt, ln, cl = case
    B, C = q.shape[:2]
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    kn, vn = (torch.randn((B, C) + tuple(kp.shape[2:]), generator=g,
                          device="cuda").to(kp.dtype) for _ in range(2))
    cl.masked_fill_(ln == 0, 0)
    ok = torch.ones(B, dtype=torch.bool, device="cuda")
    if deny is not None:
        ok[deny] = False
    return kn, vn, ok


def fused_check(q, kp, vp, kn, vn, bt, ln, cl, ok, label, S=None,
                window=0, share=None):
    """The fused launch on copies of the arena against ``kv_append_cuda`` +
    ``paged_attention_cuda`` (bitwise, arena and output) and against the
    plain version (arena bit-exact, output within kernel 1's tolerance on
    the live query slots, and within ``share`` of their RMS when given;
    padded slots zero), with a window W when given.  Returns the max abs
    error against the plain version."""
    import torch

    from repro_torch.kernels.kv_append import kv_append_cuda
    from repro_torch.kernels.paged_attention import (
        paged_attention_append_cuda, paged_attention_append_plain,
        paged_attention_cuda)

    pair, mine, plain = ([kp.clone(), vp.clone()] for _ in range(3))
    kv_append_cuda(*pair, kn, vn, bt, ln - cl, cl, ok)
    want = paged_attention_cuda(q, *pair, bt, ln, cl, _splits=S,
                                window=window)
    got = paged_attention_append_cuda(q, *mine, kn, vn, bt, ln, cl, ok,
                                      _splits=S, window=window)
    ref = paged_attention_append_plain(q, *plain, kn, vn, bt, ln, cl, ok,
                                       window=window)
    torch.cuda.synchronize()
    check(torch.equal(got, want) and all(
        torch.equal(a, b) for a, b in zip(mine, pair)),
        f"{label}: the fused launch differs from kv_append_cuda + "
        f"paged_attention_cuda")
    check(all(torch.equal(a, b) for a, b in zip(mine, plain)),
          f"{label}: the fused launch's arena is not bit-exact against the "
          f"plain version")
    check(not ok.any() or not torch.equal(mine[0], kp),
          f"{label}: the fused launch wrote nothing")
    err = live_err(got, ref, cl, label, share)
    tol = 2e-2 if torch.bfloat16 in (q.dtype, kp.dtype) else 1e-4
    check(math.isfinite(err) and err <= tol,
          f"{label}: max err {err} against the plain version (tol {tol})")
    return err


def fused_row(case, label, seed):
    """The fused launch on ``case`` (every row appending its chunk) checked
    by :func:`fused_check`, then timed beside its bound, its plain
    version, the library yardstick (``index_put_`` of the new K/V, then
    the gather + SDPA call) and the two-launch pair.  Logs and returns the
    row."""
    import torch

    from repro_torch.kernels.kv_append import kv_append_cuda
    from repro_torch.kernels.paged_attention import (
        paged_attention_append_cuda, paged_attention_append_plain,
        paged_attention_cuda)

    q, kp, vp, bt, ln, cl = case
    C = q.shape[1]
    kn, vn, ok = append_inputs(case, seed=seed, deny=None)
    err = fused_check(q, kp, vp, kn, vn, bt, ln, cl, ok, f"{label} timed case")
    old = ln - cl
    byts, ops = attention_work(q, kp, bt, ln, cl)
    # the append's reads are kernel 1's reads of those positions; its
    # writes and write_ok come on top
    byts += 2 * kn.numel() * kn.element_size() + q.shape[0]
    b_ms, by = bound_ms(byts, ops, "bfloat16")
    page = kp.shape[1]
    pos = old.long()[:, None] + torch.arange(C, device="cuda")[None]
    pidx = bt.long().gather(1, pos // page)
    sidx = pos % page
    yard = sdpa_yardstick(q, kp, vp, bt, ln, cl)

    def library():
        kp.index_put_((pidx, sidx), kn)
        vp.index_put_((pidx, sidx), vn)
        return yard()

    def mine():
        paged_attention_append_cuda(q, kp, vp, kn, vn, bt, ln, cl, ok)

    def pair():
        kv_append_cuda(kp, vp, kn, vn, bt, old, cl, ok)
        paged_attention_cuda(q, kp, vp, bt, ln, cl)
    row = dict(
        max_abs_err=err, ms=time_ms(mine),
        device_ms=device_ms(mine, "paged_attention_kernel"),
        plain_ms=time_ms(lambda: paged_attention_append_plain(
            q, kp, vp, kn, vn, bt, ln, cl, ok), iters=5),
        bound_ms=b_ms, bound_by=by, library_ms=time_ms(library),
        library_device_ms=device_ms(library),
        pair_ms=time_ms(pair), pair_device_ms=device_ms(pair))
    row["bound_share"] = b_ms / row["device_ms"]
    log(f"{label}: " + json.dumps(row))
    return row


def fused_kernel(results, lens):
    """Kernel 2 fused into kernel 1's launch: bitwise against the
    two-launch pair over kernel 1's cases, then timed at the serving
    path's shapes beside the pair, the plain version and the library."""
    import numpy as np
    import torch

    from split_cases import append_edge_case

    bf16, f32 = torch.bfloat16, torch.float32
    n_cases = 0
    worst = 0.0
    # kernel 1's sweep shapes, a GQA 8:1 case with two query groups of 64
    # (C * G = 128), and float32 q over the bf16 arena (float32 weights)
    for qd, kd in ((bf16, bf16), (f32, f32), (f32, bf16)):
        for i, (B, C, Hq, Hkv, M, P) in enumerate((
                (8, 1, 16, 16, 24, 512), (8, 16, 16, 16, 24, 512),
                (8, 16, 32, 8, 20, 256), (8, 16, 64, 8, 20, 256),
                (5, 16, 16, 16, 7, 64))):
            case = attention_case(B, C, Hq, Hkv, 128, 16, P, M, kd,
                                  seed=500 + i)
            kn, vn, ok = append_inputs(case, seed=i)
            q, kp, vp, bt, ln, cl = case
            err = fused_check(q.to(qd), kp, vp, kn, vn, bt, ln, cl, ok,
                              f"fused case {i} {qd} q, {kd} arena")
            worst = max(worst, err) if qd == bf16 else worst
            n_cases += 1
    for S in (1, 2, 4, 8):
        for C, Hq, Hkv in ((1, 16, 16), (16, 16, 16), (16, 32, 8),
                           (16, 64, 8)):
            arrays = [torch.as_tensor(a, device="cuda") for a in
                      append_edge_case(S, 16, C, Hq, Hkv, 128,
                                       seed=600 + 10 * S + C + Hq)]
            for dtype in (bf16, f32):
                case = [a.to(dtype) for a in arrays[:5]] + arrays[5:]
                fused_check(*case, f"fused split edge S={S} C={C} Hq={Hq} "
                            f"Hkv={Hkv} {dtype}", S=S)
                n_cases += 1
    long_lens = np.random.default_rng(9).integers(3072, 4097, 8)
    case = attention_case(8, 1, 16, 16, 128, 16, 2048, 512, bf16, seed=9,
                          lens=long_lens)
    case[5].fill_(1)
    kn, vn, ok = append_inputs(case, seed=9)
    fused_check(*case[:3], kn, vn, *case[3:], ok, "fused long rows")
    n_cases += 1
    log(f"paged_attention_append: {n_cases} cases (kernel 1's sweep, GQA "
        f"with two query groups, float32 q over a bf16 arena, split edge "
        f"cases at S in 1, 2, 4, 8, long rows; denied rows, -1 pages, page "
        f"ids past the arena) bitwise equal to kv_append_cuda + "
        f"paged_attention_cuda in arena and output, arena bit-exact against "
        f"the plain version; worst bf16 output err {worst:.3g} (tol 2e-2)")

    # -- timed at the serving path's shapes (kernel 1's cases, one new
    # token per row at C=1 and a 16-token chunk at C=16, every row live)
    rows = {}
    for C in (1, 16):
        case = attention_case(8, C, 16, 16, 128, 16, 512, 512, bf16, seed=7,
                              lens=lens)
        case[5].fill_(C)
        rows[C] = fused_row(case, f"paged_attention_append C={C}", seed=7)
    results["paged_attention_append"] = dict(
        name="paged_attention_append", route="cuda", source=PA_SRC,
        replaces=KA_TPU, **rows[1])
    results["paged_attention_append_c16"] = rows[16]


def sharded_kernel(results, lens):
    """Kernel 3: kernel 1 launched once per shard on the shard's KV-head
    slab, against the plain version over the joined arena, then timed at
    the serving path's shapes split over ``TP`` shards."""
    import torch

    from repro_torch.kernels.paged_attention import (
        paged_attention_append_cuda, paged_attention_cuda,
        paged_attention_plain, paged_attention_sharded,
        paged_attention_sharded_plain)
    from repro_torch.launch.mesh import make_serving_mesh

    mesh = make_serving_mesh(TP, ["cuda:0"] * TP)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # as kernel 1's

    def split(a):  # [.., H, D] -> TP contiguous head slabs
        return [t.contiguous() for t in a.chunk(TP, dim=2)]

    def run(q, kp, vp, bt, ln, cl):
        before = paged_attention_sharded.launches
        outs = paged_attention_sharded(split(q), split(kp), split(vp), bt, ln,
                                       cl, mesh=mesh, n_kv_heads=kp.shape[2])
        check(paged_attention_sharded.launches - before == TP,
              f"paged_attention_sharded made "
              f"{paged_attention_sharded.launches - before} launches, want "
              f"{TP}")
        got = torch.cat(outs, dim=2)
        want = paged_attention_plain(q, kp, vp, bt, ln, cl)
        # the split rule reads only each row's page count, D and the page
        # size: every head of one launch over the whole arena, bit for bit
        check(torch.equal(got, paged_attention_cuda(q, kp, vp, bt, ln, cl)),
              f"{q.dtype}: per-shard launches differ from the full launch")
        return live_err(got, want, cl, f"paged_attention_sharded {q.dtype}")

    def run_append(case, seed):
        """The fused append per shard against one fused launch over the
        whole arena: every head's output and arena slab bit for bit."""
        q, kp, vp, bt, ln, cl = case
        kn, vn, ok = append_inputs(case, seed)
        full = [kp.clone(), vp.clone()]
        want = paged_attention_append_cuda(q, *full, kn, vn, bt, ln, cl, ok)
        ks, vs = split(kp), split(vp)
        outs = paged_attention_sharded(split(q), ks, vs, bt, ln, cl, mesh=mesh,
                                       n_kv_heads=kp.shape[2],
                                       append=(split(kn), split(vn), ok))
        torch.cuda.synchronize()
        check(torch.equal(torch.cat(outs, dim=2), want)
              and torch.equal(torch.cat(ks, dim=2), full[0])
              and torch.equal(torch.cat(vs, dim=2), full[1]),
              f"{q.dtype}: per-shard fused launches differ from the full "
              f"fused launch")

    sweep = [(8, C, 16, 16, 128, 16, 512, 512, torch.bfloat16, lens)
             for C in (1, 16)]
    sweep += [(8, 16, 16, 16, 128, 16, 512, 512, torch.float32, lens),
              (8, 1, 16, 16, 128, 16, 512, 512, torch.float32, lens),
              (8, 16, 32, 8, 128, 16, 256, 20, torch.bfloat16, None)]
    for i, (B, C, Hq, Hkv, D, page, P, M, dtype, ln_) in enumerate(sweep):
        case = attention_case(B, C, Hq, Hkv, D, page, P, M, dtype,
                              seed=300 + i, lens=ln_)
        err = run(*case)
        check(math.isfinite(err) and err <= tol[dtype],
              f"paged_attention_sharded case {i}: max err {err}")
        run_append(case, seed=300 + i)
    log(f"paged_attention_sharded: {len(sweep)} cases over {TP} shards match "
        f"the plain version over the joined arena (bf16 tol 2e-2, f32 tol "
        f"1e-4) and the full-arena launch bit for bit (bf16 and f32), {TP} "
        f"launches per call; with the fused append, each shard's output and "
        f"arena slab equal the full fused launch's bit for bit")

    rows = {}
    for C in (1, 16):
        q, kp, vp, bt, ln, cl = attention_case(8, C, 16, 16, 128, 16, 512,
                                               512, torch.bfloat16, seed=7,
                                               lens=lens)
        cl.fill_(C)
        err = run(q, kp, vp, bt, ln, cl)
        qs, ks, vs = split(q), split(kp), split(vp)
        byts = ops = 0
        for qq, kk in zip(qs, ks):  # each shard's launch reads its inputs
            b_, o_ = attention_work(qq, kk, bt, ln, cl)
            byts, ops = byts + b_, ops + o_
        b_ms, by = bound_ms(byts, ops, "bfloat16")
        yard = [sdpa_yardstick(qq, kk, vv, bt, ln, cl)
                for qq, kk, vv in zip(qs, ks, vs)]

        def mine():
            paged_attention_sharded(qs, ks, vs, bt, ln, cl, mesh=mesh,
                                    n_kv_heads=16)

        def library():
            for f in yard:
                f()
        rows[C] = dict(
            max_abs_err=err, ms=time_ms(mine),
            device_ms=device_ms(mine, "paged_attention_kernel"),
            plain_ms=time_ms(lambda: paged_attention_sharded_plain(
                qs, ks, vs, bt, ln, cl, mesh=mesh, n_kv_heads=16), iters=5),
            bound_ms=b_ms, bound_by=by, library_ms=time_ms(library),
            library_device_ms=device_ms(library))
        rows[C]["bound_share"] = b_ms / rows[C]["device_ms"]
        log(f"paged_attention_sharded C={C}, {TP} shards: "
            + json.dumps(rows[C]))
        if C == 16:  # C=1's call time again, after C=16: the order's part
            rows[1]["ms_after_c16"] = time_ms(c1_call)
            log(f"paged_attention_sharded C=1, {TP} shards, call ms timed "
                f"again after C=16: {rows[1]['ms_after_c16']:.4g} (first "
                f"{rows[1]['ms']:.4g})")
        else:
            c1_call = mine
    results["paged_attention_sharded"] = dict(
        name="paged_attention_sharded", route="cuda", source=PA_SRC,
        replaces=PS_TPU, **rows[1])
    results["paged_attention_sharded_c16"] = rows[16]


#: one-KV-head decoders: (arch, query heads at TP=1, head dim, seeds of the
#: timed kernel 1 / fused and kernel 3 cases).  paligemma-3b is served end
#: to end; granite-20b is held and timed at kernel level only.
MQA_SHAPES = (("paligemma-3b", 8, 256, 11, 12), ("granite-20b", 48, 128, 14,
                                                  15))


def mqa_kernel(results, lens):
    """Kernels 1 and 3 and the fused launch at multi-query shapes, one KV
    head: paligemma-3b's decoder (8 query heads of 256, 4 per shard at
    TP=2, the arena replicated) and granite-20b's (48 query heads of 128,
    24 per shard).  Checked against the plain versions on the split edge
    cases (at 1 and 2 splits and at the split rule's count) and at the
    serving shapes, then timed there (bf16 pages, C = 1 and 16); kernel 3
    as two shard launches over two copies of the arena, each appending the
    same new K/V, bit for bit one launch over all query heads."""
    import torch

    from repro_torch.kernels.paged_attention import (
        paged_attention_append_cuda, paged_attention_cuda,
        paged_attention_plain, paged_attention_sharded,
        paged_attention_sharded_plain)
    from repro_torch.launch.mesh import make_serving_mesh
    from split_cases import append_edge_case

    bf16, f32 = torch.bfloat16, torch.float32
    tol = {f32: 1e-4, bf16: 2e-2}
    mesh = make_serving_mesh(TP, ["cuda:0"] * TP)
    for arch, HQ, D, seed, seed3 in MQA_SHAPES:
        n_cases = 0
        for S in (1, 2, None):
            for C in (1, 16):
                for Hq in (HQ, HQ // TP):
                    arrays = [torch.as_tensor(a, device="cuda") for a in
                              append_edge_case(S or 2, 16, C, Hq, 1, D,
                                               seed=700 + 10 * (S or 3) + C
                                               + Hq)]
                    for qd, kd in ((bf16, bf16), (f32, f32), (f32, bf16)):
                        q = arrays[0].to(qd)
                        k, v, kn, vn = (a.to(kd) for a in arrays[1:5])
                        bt, ln, cl, ok = arrays[5:]
                        label = (f"mqa {arch} D={D} S={S or 'rule'} C={C} "
                                 f"Hq={Hq} {qd} q, {kd} arena")
                        if qd == kd:
                            got = paged_attention_cuda(q, k, v, bt, ln, cl,
                                                       _splits=S)
                            want = paged_attention_plain(q, k, v, bt, ln, cl)
                            err = live_err(got, want, cl, label)
                            check(math.isfinite(err) and err <= tol[kd],
                                  f"{label}: max err {err}")
                        fused_check(q, k, v, kn, vn, bt, ln, cl, ok, label,
                                    S=S)
                        n_cases += 1
        log(f"mqa {arch}: {n_cases} head-dim-{D} one-KV-head cases (split "
            f"edge cases at S = 1, 2 and the rule's; C = 1, 16; {HQ} and "
            f"{HQ // TP} query heads; bf16, float32 and float32 q over a "
            f"bf16 arena) match the plain versions; the fused launch "
            f"bitwise the two-launch pair")

        key = "mqa" if arch == "paligemma-3b" else "granite"
        for C in (1, 16):
            for Hq in ((HQ, HQ // TP) if arch == "paligemma-3b" else (HQ,)):
                case = attention_case(8, C, Hq, 1, D, 16, 512, 512, bf16,
                                      seed=seed, lens=lens)
                case[5].fill_(C)
                label = f"mqa D={D} Hq={Hq}" if key == "mqa" else \
                    f"mqa {arch} D={D} Hq={Hq}"
                results[f"{key}_attention_c{C}_hq{Hq}"] = attention_row(
                    case, f"paged_attention {label} C={C}")
                results[f"{key}_append_c{C}_hq{Hq}"] = fused_row(
                    [a.clone() for a in case],
                    f"paged_attention_append {label} C={C}", seed=seed)

            # kernel 3 over the replicated arena: HQ query heads, HQ/TP a
            # shard, each launch on its own copy
            q, kp, vp, bt, ln, cl = attention_case(8, C, HQ, 1, D, 16, 512,
                                                   512, bf16, seed=seed3,
                                                   lens=lens)
            cl.fill_(C)
            kn, vn, ok = append_inputs((q, kp, vp, bt, ln, cl), seed=seed3,
                                       deny=None)
            qs = [t.contiguous() for t in q.chunk(TP, dim=2)]
            full = [kp.clone(), vp.clone()]
            want = paged_attention_append_cuda(q, *full, kn, vn, bt, ln, cl,
                                               ok)
            copies = [[kp.clone(), vp.clone()] for _ in range(TP)]
            before = paged_attention_sharded.launches
            outs = paged_attention_sharded(
                qs, [c[0] for c in copies], [c[1] for c in copies], bt, ln,
                cl, mesh=mesh, n_kv_heads=TP,
                append=([kn] * TP, [vn] * TP, ok))
            torch.cuda.synchronize()
            check(paged_attention_sharded.launches - before == TP,
                  f"mqa {arch} kernel 3: one launch per shard")
            check(torch.equal(torch.cat(outs, dim=2), want)
                  and all(torch.equal(c[0], full[0])
                          and torch.equal(c[1], full[1]) for c in copies),
                  f"mqa {arch} kernel 3 C={C}: per-shard launches over the "
                  f"replicated arena differ from one launch over all query "
                  f"heads")
            err = live_err(torch.cat(outs, dim=2), paged_attention_plain(
                q, *full, bt, ln, cl), cl, f"mqa {arch} kernel 3 C={C}")
            check(err <= tol[bf16], f"mqa {arch} kernel 3 C={C}: max err "
                  f"{err}")
            log(f"mqa {arch} kernel 3 C={C}: {TP} shard launches of "
                f"{HQ // TP} query heads over their copies bitwise one "
                f"launch over all {HQ}, arena copies bitwise its arena")
            # timed over the two distinct copies: each launch streams its own
            # arena from memory, as the bound counts it
            ks, vs = [c[0] for c in copies], [c[1] for c in copies]
            byts = ops = 0
            for qq, kk in zip(qs, ks):  # each shard's launch reads its inputs
                b_, o_ = attention_work(qq, kk, bt, ln, cl)
                byts, ops = byts + b_, ops + o_
            b_ms, by = bound_ms(byts, ops, "bfloat16")
            yard = [sdpa_yardstick(qq, kk, vv, bt, ln, cl)
                    for qq, kk, vv in zip(qs, ks, vs)]

            def mine():
                paged_attention_sharded(qs, ks, vs, bt, ln, cl, mesh=mesh,
                                        n_kv_heads=TP)

            def library():
                for f in yard:
                    f()
            row = dict(
                max_abs_err=err, ms=time_ms(mine),
                device_ms=device_ms(mine, "paged_attention_kernel"),
                plain_ms=time_ms(lambda: paged_attention_sharded_plain(
                    qs, ks, vs, bt, ln, cl, mesh=mesh, n_kv_heads=TP),
                    iters=5),
                bound_ms=b_ms, bound_by=by, library_ms=time_ms(library),
                library_device_ms=device_ms(library))
            row["bound_share"] = b_ms / row["device_ms"]
            results[f"{key}_sharded_c{C}"] = row
            log(f"paged_attention_sharded {'mqa' if key == 'mqa' else arch} "
                f"D={D} C={C}, {TP} shards over a replicated arena: "
                + json.dumps(row))


GQA_T = 4  # shards of the KV-head-slab case: Hq=8, Hkv=2 over 4 shards


def gqa_slab_kernel(lens):
    """Kernel 3 over the per-shard KV-head slabs of a head count the TP
    degree does not divide (``sharding/rules.py::kv_heads``): Hq=8, Hkv=2,
    D=128 over 4 shards of this card, shards 0-1 on a one-head copy of KV
    head 0 and shards 2-3 of head 1, each launch on its 2 query heads
    (G=2 against the whole launch's G=4), bf16, C = 1 and 16, without and
    with the fused append (each shard appending its head's new K/V to its
    own copy).  Every copy bit for bit its head of the whole launch's
    arena, the output within kernel 1's tolerance of the plain version,
    and bit for bit one launch over the whole arena at C = 1 and 16: a
    query row's key order reads no head count (header note, point 3), so
    the shard's 2 query tiles at C=16 sum as the whole launch's 4 do."""
    import torch

    from repro_torch.kernels.paged_attention import (
        paged_attention_append_cuda, paged_attention_cuda,
        paged_attention_plain, paged_attention_sharded)
    from repro_torch.launch.mesh import make_serving_mesh

    mesh = make_serving_mesh(GQA_T, ["cuda:0"] * GQA_T)
    heads = [s * 2 // GQA_T for s in range(GQA_T)]  # the KV head of shard s

    def slabs(t):  # [.., Hkv, D] -> each shard's one-head copy
        return [t[:, :, h:h + 1].contiguous() for h in heads]

    for C in (1, 16):
        q, kp, vp, bt, ln, cl = attention_case(8, C, 8, 2, 128, 16, 512, 512,
                                               torch.bfloat16, seed=13,
                                               lens=lens)
        cl.fill_(C)
        qs = [t.contiguous() for t in q.chunk(GQA_T, dim=2)]
        for fused in (False, True):
            before = paged_attention_sharded.launches
            if fused:
                kn, vn, ok = append_inputs((q, kp, vp, bt, ln, cl), seed=13,
                                           deny=None)
                full = [kp.clone(), vp.clone()]
                want = paged_attention_append_cuda(q, *full, kn, vn, bt, ln,
                                                   cl, ok)
                copies = [slabs(kp), slabs(vp)]
                outs = paged_attention_sharded(
                    qs, *copies, bt, ln, cl, mesh=mesh, n_kv_heads=GQA_T,
                    append=(slabs(kn), slabs(vn), ok))
                plain = paged_attention_plain(q, *full, bt, ln, cl)
            else:
                want = paged_attention_cuda(q, kp, vp, bt, ln, cl)
                copies = [slabs(kp), slabs(vp)]
                outs = paged_attention_sharded(qs, *copies, bt, ln, cl,
                                               mesh=mesh, n_kv_heads=GQA_T)
                full = [kp, vp]
                plain = paged_attention_plain(q, kp, vp, bt, ln, cl)
            torch.cuda.synchronize()
            label = (f"kernel 3 on KV-head slabs (Hq=8, Hkv=2, {GQA_T} shards, "
                     f"C={C}{', fused append' if fused else ''})")
            check(paged_attention_sharded.launches - before == GQA_T,
                  f"{label}: one launch per shard")
            got = torch.cat(outs, dim=2)
            off = (got.float() - want.float()).abs()
            check(torch.equal(got, want),
                  f"{label}: differs from one launch over the whole arena in "
                  f"{int((off > 0).sum())} elements (max "
                  f"{off.max().item()})")
            check(all(torch.equal(c[s], f[:, :, h:h + 1])
                      for c, f in zip(copies, full)
                      for s, h in enumerate(heads)),
                  f"{label}: a shard's copy differs from its head of the arena")
            err = live_err(got, plain, cl, label)
            check(err <= 2e-2, f"{label}: max err {err} against the plain "
                  f"version")
            log(f"{label}: against one launch over the whole arena bitwise; "
                f"copies bitwise its heads; max err {err:.3g} against the "
                f"plain version")
    straddle_slab_kernel(lens)


#: a query slab that straddles KV-head groups: Hq=6, Hkv=3 over 2 shards
STRADDLE_HEADS = [(0, 2), (1, 3)]  # the KV heads of shard s
STRADDLE_WINDOWS = [(0, 4), (1, 4)]  # its query slab in its launch's heads


def straddle_slab_kernel(lens):
    """Kernel 3 where a shard's query slab straddles KV-head groups
    (``sharding/rules.py::query_window``): Hq=6, Hkv=3, D=128 over 2
    shards of this card, shard 0 on KV heads 0-1 and shard 1 on heads 1-2,
    each launch on its 3 query heads padded with zero heads to 4 (at
    offsets 0 and 1), bf16, C = 1 and 16, without and with the fused
    append.  Held to the plain version within kernel 1's tolerance; every
    copy bit for bit its heads of one launch over the whole arena, so the
    shared head's two copies are bitwise equal; and the output against
    that launch's, bit for bit (printed and held: the padded launch's
    query groups are the whole launch's, G=2)."""
    import torch

    from repro_torch.kernels.paged_attention import (
        paged_attention_append_cuda, paged_attention_cuda,
        paged_attention_plain, paged_attention_sharded)
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving.paged_decode import pad_window, window_heads

    mesh = make_serving_mesh(2, ["cuda:0"] * 2)

    def slabs(t):  # [.., Hkv, D] -> each shard's heads
        return [t[:, :, a:b].contiguous() for a, b in STRADDLE_HEADS]

    for C in (1, 16):
        q, kp, vp, bt, ln, cl = attention_case(8, C, 6, 3, 128, 16, 512, 512,
                                               torch.bfloat16, seed=17,
                                               lens=lens)
        cl.fill_(C)
        qs = [pad_window(t.contiguous(), w)
              for t, w in zip(q.chunk(2, dim=2), STRADDLE_WINDOWS)]
        for fused in (False, True):
            copies = [slabs(kp), slabs(vp)]
            if fused:
                kn, vn, ok = append_inputs((q, kp, vp, bt, ln, cl), seed=17,
                                           deny=None)
                full = [kp.clone(), vp.clone()]
                want = paged_attention_append_cuda(q, *full, kn, vn, bt, ln,
                                                   cl, ok)
                before = paged_attention_cuda.launches
                outs = paged_attention_sharded(
                    qs, *copies, bt, ln, cl, mesh=mesh, n_kv_heads=4,
                    append=(slabs(kn), slabs(vn), ok))
            else:
                full = [kp, vp]
                want = paged_attention_cuda(q, kp, vp, bt, ln, cl)
                before = paged_attention_cuda.launches
                outs = paged_attention_sharded(
                    qs, *copies, bt, ln, cl, mesh=mesh, n_kv_heads=4)
            torch.cuda.synchronize()
            launches = paged_attention_cuda.launches - before
            plain = paged_attention_plain(q, *full, bt, ln, cl)
            label = (f"kernel 3 on straddling slabs (Hq=6, Hkv=3, 2 shards, "
                     f"C={C}{', fused append' if fused else ''})")
            check(launches == 2, f"{label}: {launches} launches, want one "
                  f"per shard")
            got = torch.cat([window_heads(o, w, 3) for o, w in
                             zip(outs, STRADDLE_WINDOWS)], dim=2)
            err = live_err(got, plain, cl, label)
            check(err <= 2e-2, f"{label}: max err {err} against the plain "
                  f"version")
            check(all(torch.equal(c[s], f[:, :, a:b])
                      for c, f in zip(copies, full)
                      for s, (a, b) in enumerate(STRADDLE_HEADS)),
                  f"{label}: a shard's copy differs from its heads of the "
                  f"arena")
            check(all(torch.equal(c[0][:, :, 1], c[1][:, :, 0])
                      for c in copies),
                  f"{label}: the shared head's two copies differ")
            off = (got.float() - want.float()).abs()
            check(torch.equal(got, want),
                  f"{label}: differs from one launch over the whole arena in "
                  f"{int((off > 0).sum())} elements (max {off.max().item()})")
            log(f"{label}: max err {err:.3g} against the plain version; "
                f"copies bitwise their heads, the shared head's two copies "
                f"bitwise equal; output bitwise one launch over the whole "
                f"arena")


# ---------------------------------------------------------------------------
# phase 3: parity of the card against the CPU on a small model


def parity_phase():
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.models.transformer import init_decoder_lm
    from repro_torch.serving import PagedServingEngine

    for arch in ("olmo-1b", "olmoe-1b-7b"):
        cfg = reduced(get_config(arch))
        params = init_decoder_lm(cfg, seed=3, dtype=torch.float32,
                                 device="cpu")
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
                   for n in rng.integers(3, 20, 6)]
        out = {}
        for dev in ("cpu", "cuda"):
            eng = PagedServingEngine(cfg, params, num_pages=24, page_size=4,
                                     max_batch=3, prefill_chunk=8, device=dev)
            reqs = [eng.submit(p, 8) for p in prompts]
            st = eng.run()
            check(all(r.state == "finished" for r in reqs),
                  f"{arch} {dev}: unfinished")
            check(st.warnings_fired == int(eng.pool.clock.cpu()),
                  f"{arch} {dev}: clock mirror {st.warnings_fired} != pool "
                  f"clock")
            out[dev] = ([r.generated for r in reqs], st.steps, st.preemptions)
        check(out["cpu"] == out["cuda"],
              f"card and CPU disagree on reduced {arch}: {out}")
        log(f"parity: reduced {arch}, 6 requests, card == CPU (tokens, "
            f"{out['cpu'][1]} steps, {out['cpu'][2]} preemptions)")
    # the non-paged families: build_model's prefill and 8 greedy steps
    for arch in ("whisper-tiny", "recurrentgemma-9b", "mamba2-780m"):
        cfg = reduced(get_config(arch))
        run = {dev: model_run(cfg, 40, torch.float32, dev=dev, steps=8,
                              seed=3, init_dev="cpu")
               for dev in ("cpu", "cuda")}
        err = float((run["cuda"]["logits"].cpu()
                     - run["cpu"]["logits"]).abs().max())
        check(torch.allclose(run["cuda"]["logits"].cpu(), run["cpu"]["logits"],
                             atol=1e-3, rtol=1e-3),
              f"card and CPU logits of reduced {arch} differ by {err:.3g}")
        check(torch.equal(run["cuda"]["tokens"], run["cpu"]["tokens"]),
              f"card and CPU disagree on reduced {arch}'s tokens")
        log(f"parity: reduced {arch} through build_model, prefill + 8 steps, "
            f"card == CPU (tokens; logits max abs {err:.3g}, limit 1e-3)")


# ---------------------------------------------------------------------------
# phase 4: the full-width engine


def row_kv(eng, r):
    """K and V [L, n, Hkv, D] at the ``n = r.committed`` positions request
    ``r`` has written, read from the (joined) arena through its block
    table."""
    import numpy as np
    import torch

    kvm = eng.kv_manager
    pos = np.arange(r.committed)
    page = np.asarray(kvm.row_pages(r.slot))[pos // kvm.page_size]
    idx = [torch.as_tensor(a, device=kvm.device)
           for a in (page, pos % kvm.page_size)]
    kv = kvm.gather_kv()
    return {n: kv[n][:, idx[0], idx[1]].float() for n in ("k", "v")}


def first_divergence(run, base):
    """Per request, the index of the first generated token where ``run``
    and ``base`` (results of :func:`engine_phase`) differ."""
    return [next((i for i, (x, y) in enumerate(zip(p, q)) if x != y), len(q))
            for p, q in zip(run[0], base[0])]


def kv_distance(run, base, depth):
    """How far ``run``'s K/V are from ``base``'s, at positions where both
    fed the model the same tokens: every prompt position, and generated
    positions ``j < depth[i]`` of request i.  Returns {part: (mean abs
    difference, elements beyond 2e-2 + 2e-2|x| — the reference's TP
    tolerance —, elements)} for the parts "prompt" (chunked prefill) and
    "decode" (C=1 steps), K and V together."""
    import torch

    out = {}
    for part in ("prompt", "decode"):
        diffs, bad = [], 0
        for i, plen in enumerate(run[3]):
            lo, hi = (0, plen) if part == "prompt" else (plen, plen + depth[i])
            for n in ("k", "v"):
                a, b = (x[1][i][n][:, lo:hi] for x in (run, base))
                d = (a - b).abs()
                diffs.append(d.flatten())
                bad += int((d > 2e-2 + 2e-2 * b.abs()).sum())
        d = torch.cat(diffs)
        out[part] = (d.mean().item() if d.numel() else float("nan"), bad,
                     d.numel())
        n_pos = sum(run[3]) if part == "prompt" else sum(depth)
        log(f"{run[2]}: {part} K/V against {base[2]} at {n_pos} positions: "
            f"mean abs diff {out[part][0]:.4g}, {bad} of {d.numel()} "
            f"elements beyond 2e-2 + 2e-2|x|")
    return out


@contextlib.contextmanager
def route_trace(records, slots):
    """While open, every fused step appends to ``records`` its rows'
    ``lengths`` and live chunk lengths and ``slots()`` (row -> request
    index), and every MoE router call of that step the top-k expert set
    of each (row, chunk) token, sorted, and the gap between the router's
    k-th and (k+1)-th probability.  Device tensors only: the step keeps
    its one host read."""
    import torch

    from repro_torch.models import moe
    from repro_torch.serving import paged_decode

    core, route = paged_decode._chunk_core, moe._route

    def traced_core(model, kv, block_tables, lengths, tokens, n_new, **kw):
        records.append((lengths.clone(), n_new.clone(), slots(), []))
        return core(model, kv, block_tables, lengths, tokens, n_new, **kw)

    def traced_route(cfg, x, w_router):
        probs, gate, expert = route(cfg, x, w_router)
        top = torch.sort(probs, dim=-1, descending=True).values
        k = cfg.top_k
        records[-1][3].append((expert.sort(dim=-1).values.to(torch.int16),
                               top[..., k - 1] - top[..., k]))
        return probs, gate, expert

    paged_decode._chunk_core, moe._route = traced_core, traced_route
    try:
        yield records
    finally:
        paged_decode._chunk_core, moe._route = core, route


def routes_by_position(records, cfg, n_req, tag):
    """:func:`route_trace`'s records per request and position: (sel [n_req,
    L, n, k] int16 top-k sets, -1 where unwritten; gap [n_req, L, n]
    float32).  Under TP every shard routes (the router is replicated):
    their sets must be equal; shard 0's are kept."""
    import numpy as np
    import torch

    L, k = cfg.n_layers, cfg.top_k
    n = max(int((ln + nn).max()) for ln, nn, _, _ in records)
    sel = np.full((n_req, L, n, k), -1, np.int16)
    gap = np.full((n_req, L, n), np.nan, np.float32)
    for lengths, n_new, slots, calls in records:
        lengths, n_new = lengths.cpu().numpy(), n_new.cpu().numpy()
        shards = len(calls) // L
        check(len(calls) == shards * L, f"{tag}: {len(calls)} router calls "
              f"in a step of {L} layers")
        s_all = torch.stack([c[0] for c in calls]).cpu().numpy()
        g_all = torch.stack([c[1] for c in calls]).cpu().numpy()
        s_all = s_all.reshape(L, shards, *s_all.shape[1:])
        check((s_all == s_all[:, :1]).all(),
              f"{tag}: the shards' routers chose different experts")
        g_all = g_all.reshape(L, shards, *g_all.shape[1:])[:, 0]
        for b, i in slots.items():
            for j in range(int(n_new[b])):
                p = int(lengths[b]) + j
                sel[i, :, p], gap[i, :, p] = s_all[:, 0, b, j], g_all[:, b, j]
    return sel, gap


def routing_check(run, base, names=(f"TP={TP}", "TP=1")):
    """Hold MoE K/V across two runs of the same tokens by their routing.
    A position's K/V at layer l follow from the hidden states of layers
    < l at it and at the positions before it, and from those tokens'
    routing: where a router's top-k set differs between the runs (a
    flip) the K/V downstream of it may differ beyond tolerance.  So the
    check: (i) every K/V element beyond 2e-2 + 2e-2|x| lies downstream of
    a flip (layer > the flip's, position >= its position, same request);
    (ii) every flip that no other flip reaches is a near tie: its k-th
    minus (k+1)-th probability is below 1e-4 in one of the runs.  It also
    prints, at each request's first position off, the flips there
    with both runs' gaps, the gaps at flips against all gaps, and the
    elements beyond tolerance at positions whose own routing agrees at
    every layer."""
    import numpy as np
    import torch

    tag = run[2]
    (sel_a, gap_a), (sel_b, gap_b) = run[4], base[4]
    beyond = cone_beyond = agree_beyond = agree_elems = n_elems = 0
    flip_gaps, root_gaps, all_gaps, firsts = [], [], [], []
    n_flips = n_agree = n_pos = 0
    for i, (ka, kb) in enumerate(zip(run[1], base[1])):
        L, n = ka["k"].shape[:2]
        bad = torch.zeros((L, n), dtype=torch.int64, device=ka["k"].device)
        for nm in ("k", "v"):
            d = (ka[nm] - kb[nm]).abs() > 2e-2 + 2e-2 * kb[nm].abs()
            bad += d.flatten(2).sum(-1)
        bad = bad.cpu().numpy()  # [L, n] elements beyond tolerance
        per = 2 * ka["k"][0, 0].numel()  # K/V elements of one (layer, pos)
        flip = (sel_a[i, :, :n] != sel_b[i, :, :n]).any(-1)  # [L, n]
        check((sel_a[i, :, :n] >= 0).all() and (sel_b[i, :, :n] >= 0).all(),
              f"{tag}: request {i}: a written position has no routing")
        # a flip at (l', p') reaches layers > l' at positions >= p'
        reach = np.logical_or.accumulate(
            np.logical_or.accumulate(flip, axis=0), axis=1)
        cone = np.zeros_like(reach)
        cone[1:] = reach[:-1]
        agree = ~flip.any(0)  # positions whose own routing agrees
        beyond += int(bad.sum())
        cone_beyond += int(bad[~cone].sum())
        agree_beyond += int(bad[:, agree].sum())
        agree_elems += int(agree.sum()) * L * per
        n_elems += L * n * per
        n_flips += int(flip.sum())
        n_agree += int(agree.sum())
        n_pos += n
        both = np.minimum(gap_a[i, :, :n], gap_b[i, :, :n])
        all_gaps.append(both.ravel())
        flip_gaps += both[flip].tolist()
        root_gaps += both[flip & ~cone].tolist()  # no flip upstream of it
        off = np.nonzero(bad.any(0))[0]
        if len(off):
            p = int(off[0])
            lb = int(np.nonzero(bad[:, p])[0][0])
            ls, ps = np.nonzero(flip[:lb, :p + 1])  # the flips reaching it
            near = sorted(zip(ps.tolist(), ls.tolist()), reverse=True)[:3]
            firsts.append((i, p, lb, [(q, l, float(gap_a[i, l, q]),
                                       float(gap_b[i, l, q]))
                                      for q, l in near]))
    all_gaps = np.concatenate(all_gaps)
    log(f"{tag}: float32 {names[0]} against {names[1]}: {n_flips} (layer, "
        f"position) "
        f"router flips (top-k sets differ) over {n_pos} positions x "
        f"{sel_a.shape[1]} layers; {beyond} of {n_elems} K/V elements beyond "
        f"2e-2 + 2e-2|x|, {cone_beyond} of them outside every flip's "
        f"downstream")
    if flip_gaps:
        q = np.quantile(all_gaps, [0.01, 0.5])
        log(f"{tag}: k-th minus (k+1)-th router probability, the smaller "
            f"of the two runs': at flips max {max(flip_gaps):.3g}, median "
            f"{float(np.median(flip_gaps)):.3g}; at the {len(root_gaps)} "
            f"flips no other flip reaches max {max(root_gaps):.3g}; over all "
            f"(layer, position) 1% quantile {q[0]:.3g}, median {q[1]:.3g}")
    for i, p, lb, near in firsts:
        log(f"{tag}: request {i}: first K/V off at position {p}, layer {lb}; "
            f"the nearest flips reaching it (position, layer, gap "
            f"{names[0]}, gap {names[1]}): "
            f"{[(q, l, f'{a:.3g}', f'{b:.3g}') for q, l, a, b in near]}")
    log(f"{tag}: at the {n_agree} positions whose own routing agrees at "
        f"every layer: {agree_beyond} of {agree_elems} K/V elements beyond "
        f"tolerance")
    check(cone_beyond == 0, f"{tag} float32: {cone_beyond} K/V elements "
          f"beyond tolerance where no router flip reaches")
    # a flip no other flip reaches saw inputs equal up to rounding, so it
    # must sit at a near tie: a wrong router or expert split would flip
    # wide margins too (the median gap is ~1e-3 at olmoe's random init)
    widest = max(root_gaps, default=0.0)
    check(widest < 1e-4, f"{tag} float32: a router flip no other flip "
          f"reaches has a gap of {widest:.3g}, wider than rounding can cross")


def expert_bytes(tree):
    """Bytes of the MoE expert weights (``w_gate``, ``w_up``, ``w_down``)
    of a decoder's nested parameter dicts."""
    return sum(t.numel() * t.element_size() for blk in tree["blocks"]
               for n, t in blk["moe"].items() if n != "w_router")


def step_attention_work(cfg, eng, tp, dtype):
    """(dict for ``op_analysis.analyze``'s ``extra``) the work of a steady
    decode step's fused append + attention launches, which a dispatch mode
    does not see: by :func:`attention_work`'s rules, per layer and shard
    each live row's K/V of its length + 1 read, its new K/V written, q read
    and the output written; 4*D operations per (query, key) pair."""
    import numpy as np

    from repro_torch.sharding.rules import kv_heads

    st = eng.kv_manager.step_state()
    act, ln = st.active.cpu().numpy(), st.lengths.cpu().numpy()
    keys, rows = int((ln[act] + 1).sum()), int(act.sum())
    D = cfg.head_dim
    hkv, hq = kv_heads(cfg, tp, 0)[1], cfg.n_heads // tp
    el = (eng.kv[0] if tp > 1 else eng.kv)["k"].element_size()
    qel = 4 if dtype == "float32" else 2  # q and the output: the weights'
    per = (2 * keys * hkv * D * el + 2 * rows * hkv * D * el
           + 2 * rows * hq * D * qel)
    return {"dot_flops": 4 * D * keys * hq * cfg.n_layers * tp,
            "hbm_bytes": per * cfg.n_layers * tp}


def roofline_line(tag, what, cost, dtype, measured_ms, name):
    """Log ``op_analysis``'s FLOPs and bytes of one ``what``, the H100
    bound they give (the larger of bytes at the HBM rate and FLOPs at the
    ``dtype`` peak) and the measured time's share of it."""
    b_ms, by = bound_ms(cost["hbm_bytes"], cost["dot_flops"], dtype)
    log(f"roofline {tag} {what}: {cost['dot_flops'] / 1e9:.4f} GFLOP of "
        f"products, {cost['hbm_bytes'] / 1e9:.4f} GB of operand traffic "
        f"({cost['n_ops']} ops), bound {b_ms:.4f} ms ({by}); measured "
        f"{measured_ms:.3f} ms, the bound {100 * b_ms / measured_ms:.2f}% of "
        f"it, on {name}")


#: the steady steps (0-based) of an engine run traced by torch.profiler for
#: its device time; the roofline's op count runs at steady step 2
PROFILED_STEADY = (4, 5)


def engine_state(eng):
    """Everything a step writes, cloned on the card: the block tables,
    snapshots, lengths and last tokens, the pool's tensors (its clock
    among them) and every shard's arena."""
    from repro_torch.core.pagepool import PagePool

    kvm = eng.kv_manager
    out = {"block_tables": kvm._bt, "snapshot": kvm._snap,
           "lengths": kvm._len, "last_tok": kvm._last}
    out.update({f"pool.{f}": t for f, t in zip(PagePool._fields, eng.pool)})
    kvs = eng.kv if isinstance(eng.kv, list) else [eng.kv]
    out.update({f"arena{s}.{n}": kv[n] for s, kv in enumerate(kvs)
                for n in ("k", "v")})
    return {k: v.clone() for k, v in out.items()}


def first_state_difference(a, b):
    """(name, index, a's value, b's value) of the first element where two
    :func:`engine_state` snapshots differ, or None where they are equal."""
    import torch

    for k in a:
        if not torch.equal(a[k], b[k]):
            at = tuple((a[k] != b[k]).nonzero()[0].tolist())
            return k, at, a[k][at].item(), b[k][at].item()
    return None


def graph_pool_bytes(pool):
    """Bytes of the device segments in the graph memory pool ``pool`` (a
    runner's ``_mempool``, a decode step's; 0 for None, before a first
    capture)."""
    import torch

    if pool is None:
        return 0
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == tuple(pool))


def serve(eng, tag, per_step, *, rows=None, roofline=None):
    """Drain ``eng``'s requests step by step (admit, step, maintain), with
    the phase's gates: every step adds ``per_step`` (wrapper -> launches)
    once, and once more for each capture it ran (a capture's dry step
    launches what an eager step does); a steady step (nothing queued,
    every row decoding, each two or more tokens from its end) makes
    exactly one device->host transfer (sync debug mode).  Steady steps
    :data:`PROFILED_STEADY` run under torch.profiler (the steady step
    before them its warm-up, traced and dropped): device ms and ops a
    step, and the fused launch's count a step, which must equal
    ``per_step``'s.  ``rows``: called with the requests a step before
    their last one, untimed (the K/V reads).  ``roofline``: a
    :func:`step_attention_work` callable; steady step 2 then runs under
    ``op_analysis.analyze``.  Returns a dict: steps, steady, transfers,
    wall s (without ``rows``), mean steady wall ms (the unprofiled,
    uncounted steady steps), device ms and ops a step, and the cost."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.launch.op_analysis import analyze
    from repro_torch.serving.runner import ModelRunner

    sched = eng.scheduler
    steps = steady = transfers = 0
    walls, untimed, cost, prof, device = [], 0.0, None, None, None
    t0 = time.perf_counter()
    while True:
        sched.admit()
        if not sched.running and not sched.queue:
            break
        last = [r for r in sched.running
                if len(r.generated) == r.max_new_tokens - 1]
        if rows is not None and last:
            t1 = time.perf_counter()
            rows(last)
            torch.cuda.synchronize()
            untimed += time.perf_counter() - t1
        before = {fn: fn.launches for fn in per_step}
        dry = ModelRunner.dry_steps
        is_steady = (not sched.queue and all(
            r.committed >= len(r.prompt)
            and len(r.generated) + 2 < r.max_new_tokens
            for r in sched.running))
        if is_steady:
            count = roofline is not None and steady == 2
            profiled = steady in PROFILED_STEADY
            # the profiler's warm-up step, traced and dropped: a trace
            # begun just before a graph replay could miss its first kernels
            warm = steady == PROFILED_STEADY[0] - 1
            if count:
                work = roofline()
            if warm:
                prof = profile(activities=[ProfilerActivity.CUDA],
                               schedule=schedule(
                                   wait=0, warmup=1,
                                   active=len(PROFILED_STEADY), repeat=1))
                prof.__enter__()
            t1 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    if count:  # the step's own read ends it
                        cost = analyze(eng.step, extra=work)
                    else:
                        eng.step()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            if not (count or profiled or warm):
                walls.append(time.perf_counter() - t1)
            syncs = [w for w in caught
                     if "called a synchronizing" in str(w.message)]
            check(len(syncs) == 1, f"{tag}: steady step {steps} made "
                  f"{len(syncs)} device->host transfers: "
                  f"{[str(w.message)[:80] for w in syncs]}")
            steady += 1
            transfers += len(syncs)
            if prof is not None:
                torch.cuda.synchronize()
                prof.step()
            if prof is not None and steady == PROFILED_STEADY[-1] + 1:
                prof.__exit__(None, None, None)
                device = profiled_step(prof, len(PROFILED_STEADY))
                prof = None
        else:
            eng.step()
        sched.maintain()
        steps += 1
        times = 1 + ModelRunner.dry_steps - dry
        got = {fn.__name__: fn.launches - before[fn] for fn in per_step}
        check(all(fn.launches - before[fn] == n * times
                  for fn, n in per_step.items()),
              f"{tag} step {steps}: kernel launches {got}, want "
              f"{ {fn.__name__: n * times for fn, n in per_step.items()} }"
              f" (the step and {times - 1} capture dry steps)")
    torch.cuda.synchronize()
    check(steady >= PROFILED_STEADY[-1] + 2 and device is not None,
          f"{tag}: only {steady} steady steps were checked")
    fused = next(n for fn, n in per_step.items()
                 if fn.__name__ == "paged_attention_append_cuda")
    check(device["fused"] == fused, f"{tag}: the profiler counts "
          f"{device['fused']} fused launches a steady step, want {fused}")
    return {"steps": steps, "steady": steady, "transfers": transfers,
            "wall": time.perf_counter() - t0 - untimed,
            "steady_ms": 1e3 * sum(walls) / len(walls),
            "device_ms": device["ms"], "ops": device["ops"], "cost": cost}


def profiled_step(prof, steps):
    """Device ms, device ops and fused-kernel launches a step from a
    torch.profiler trace of ``steps`` steps (kernels and copies)."""
    ms = ops = fused = 0.0
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0))
        if dev > 0 and str(ev.device_type).endswith("CUDA"):
            ms += dev / 1e3
            ops += ev.count
            if "paged_attention_kernel" in ev.key:
                fused += ev.count
    return {"ms": ms / steps, "ops": ops / steps, "fused": fused / steps}


def engine_phase(results, name, tp=1, dtype="bfloat16", arch="olmo-1b",
                 record=(), routes=False, moe_shard=None, roofline=False):
    """Serve the 8 requests on full-width ``arch`` with ``dtype`` weights,
    twice: once with the runner's eager step, then through its captured
    CUDA graphs (the card's default, the main path); ``tp`` > 1 serves
    them on ``tp`` shards of this card (over replicated arena copies
    where ``tp`` does not divide the KV heads: then the copies must be
    bitwise equal after the run, each the whole arena's bytes).  Both runs
    are held by :func:`serve`'s gates, and the graph run's tokens, block
    tables, snapshots, lengths, last tokens, pool (clock included) and
    arena bitwise against the eager run's (the first difference printed
    if any).  ``moe_shard`` sets ``REPRO_MOE_SHARD`` while the engines cut
    their weights (then each shard's expert bytes are held: half the
    whole set under ``ep``, all of it under ``data`` and ``none``).
    ``record`` names the ``results`` rows whose ``launches`` take the
    graph run's counts.  With ``roofline`` one steady step of the eager
    run goes through ``op_analysis.analyze`` (a dispatch mode sees no
    graph replay; the fused launches' work added from
    :func:`step_attention_work`) and its bound is logged beside the graph
    run's mean steady wall time.  With ``routes`` the eager run records
    the MoE routing of every position (:func:`route_trace`: a Python
    patch, which a replay does not run).  Returns (generated tokens, per
    request the K/V of every position it wrote — read just before its
    last step —, the phase's tag, prompt lengths, and with ``routes`` the
    MoE routing of every position: :func:`routes_by_position`)."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.kv_append import kv_append_cuda
    from repro_torch.kernels.paged_attention import (
        paged_attention_append_cuda, paged_attention_cuda,
        paged_attention_sharded)
    from repro_torch.models.transformer import init_decoder_lm
    from repro_torch.serving import PagedServingEngine

    gc.collect()  # an earlier phase's engine (a reference cycle) and weights
    torch.cuda.empty_cache()
    tag = ("engine" if arch == "olmo-1b" else arch) + (
        "" if tp == 1 else f" tp={tp}") + (
        "" if moe_shard is None else f" {moe_shard}") + (
        "" if dtype == "bfloat16" else f" {dtype}")
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_decoder_lm(cfg, seed=0, dtype=getattr(torch, dtype),
                             device="cuda")
    where = (dict(device="cuda") if tp == 1 else
             dict(tensor_parallel=tp, devices=["cuda:0"] * tp))

    def build():
        if moe_shard is not None:  # read where the engine cuts the weights
            os.environ["REPRO_MOE_SHARD"] = moe_shard
        try:
            return PagedServingEngine(cfg, params, num_pages=512,
                                      page_size=16, max_batch=8,
                                      prefill_chunk=16, **where)
        finally:
            os.environ.pop("REPRO_MOE_SHARD", None)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(64, 257, 8)]
    moe = (f", {cfg.n_experts} experts top-{cfg.top_k} of d_ff {cfg.d_ff}"
           if cfg.moe else "")
    # every kernel wrapper's count, and what one step must add to it: the
    # fused launch once per layer and shard (counted by kernel 1's wrapper
    # too, which it launches through), the standalone append never
    per_step = {paged_attention_cuda: tp * cfg.n_layers,
                paged_attention_append_cuda: tp * cfg.n_layers,
                kv_append_cuda: 0,
                paged_attention_sharded: (tp if tp > 1 else 0) * cfg.n_layers}

    # -- the eager step: the reference state, routes, the op count --------
    eng = build()
    eng.runner.graphs = False
    reqs = [eng.submit(p, 32) for p in prompts]
    records = []
    index = {id(r): i for i, r in enumerate(reqs)}
    trace = (route_trace(records, lambda: {r.slot: index[id(r)]
                                           for r in eng.scheduler.running})
             if routes else contextlib.nullcontext())
    with trace:
        eager = serve(eng, f"{tag} eager", per_step, roofline=(
            (lambda: step_attention_work(cfg, eng, tp, dtype))
            if roofline else None))
    eager_tokens = [list(r.generated) for r in reqs]
    eager_state = engine_state(eng)
    del eng, reqs
    gc.collect()

    # -- the main path: the captured step ----------------------------------
    eng = build()
    check(eng.runner.graphs, f"{tag}: the engine does not serve through "
          f"CUDA graphs on the card")
    if moe_shard is not None:
        whole = expert_bytes(params.tree() if hasattr(params, "tree")
                             else params)
        per = [expert_bytes(m.tree()) for m in eng.params]
        want = whole // tp if moe_shard == "ep" else whole
        check(eng.mesh.moe_shard == moe_shard and per == [want] * tp,
              f"{tag}: expert bytes per shard {per}, want {want} "
              f"(the whole set {whole})")
        log(f"{tag}: {per[0] / 2**30:.3f} GiB of experts on each of {tp} "
            f"shards, the whole set {whole / 2**30:.3f} GiB")
    del params  # under tp the engine holds its own shard copies
    reqs = [eng.submit(p, 32) for p in prompts]
    torch.cuda.synchronize()
    log(f"{tag}: {arch} full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, "
        f"{cfg.n_kv_heads} KV heads, vocab {cfg.vocab_padded}{moe}), set-up "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    kv_rows = {}
    for fn in per_step:
        fn.launches = 0
    graph = serve(eng, tag, per_step, rows=lambda last: kv_rows.update(
        (id(r), row_kv(eng, r)) for r in last if id(r) not in kv_rows))
    launches = {fn.__name__: fn.launches for fn in per_step}
    wrappers = {"paged_attention": paged_attention_cuda,
                "kv_append": kv_append_cuda,
                "paged_attention_append": paged_attention_append_cuda,
                "paged_attention_sharded": paged_attention_sharded}
    for key in record:
        results[key]["launches"] = wrappers[key].launches
    runner = eng.runner
    replayed = {fn.__name__: sum(g.launches.get(fn, 0) * g.replays
                                 for g in runner.step_graphs.values())
                for fn in per_step}
    check(all(replayed[fn.__name__] == n * graph["steps"]
              for fn, n in per_step.items()),
          f"{tag}: the graphs' recorded launches times their replays "
          f"{replayed}, want {graph['steps']} steps' worth of {per_step}")

    st = eng.stats
    gen = sum(len(r.generated) for r in reqs)
    check(all(r.state == "finished" for r in reqs),
          f"{tag}: a request did not finish")
    check(all(len(r.generated) == 32 for r in reqs), f"{tag}: short generation")
    check(all(0 <= t < cfg.vocab_padded for r in reqs for t in r.generated),
          f"{tag}: token id out of range")
    clock = int(eng.pool.clock.cpu())
    check(st.warnings_fired == clock,
          f"{tag}: clock mirror {st.warnings_fired} != pool clock {clock}")
    tokens = [list(r.generated) for r in reqs]
    diff = first_state_difference(eager_state, engine_state(eng))
    check(tokens == eager_tokens and graph["steps"] == eager["steps"]
          and diff is None,
          f"{tag}: the graph run differs from the eager run: tokens "
          f"{'equal' if tokens == eager_tokens else 'differ'}, steps "
          f"{graph['steps']} against {eager['steps']}, first state "
          f"difference {diff}")
    del eager_state
    log(f"{tag}: {len(reqs)} requests finished, {graph['steps']} steps, "
        f"{gen} generated tokens, warnings_fired == clock == {clock}, "
        f"{graph['steady']} steady steps with {graph['transfers']} "
        f"device->host transfers, launches {json.dumps(launches)} "
        f"({graph['steps']} replays and {len(runner.step_graphs)} dry "
        f"steps); tokens, block tables, snapshots, lengths, last tokens, "
        f"pool and arena bitwise equal to the eager run's")
    pool_mb = graph_pool_bytes(runner._mempool) / 2**20
    capture = sum(g.capture_ms for g in runner.step_graphs.values())
    log(f"{tag}: eager {1e3 * eager['wall'] / eager['steps']:.2f} ms/step "
        f"({gen / eager['wall']:.1f} tokens/s), graph "
        f"{1e3 * graph['wall'] / graph['steps']:.2f} ms/step "
        f"({gen / graph['wall']:.1f} tokens/s); steady step wall eager "
        f"{eager['steady_ms']:.3f} ms, graph {graph['steady_ms']:.3f} ms; "
        f"device eager {eager['device_ms']:.3f} ms in {eager['ops']:.0f} "
        f"ops ({100 * eager['device_ms'] / eager['steady_ms']:.1f}% busy), "
        f"graph {graph['device_ms']:.3f} ms in {graph['ops']:.0f} ops "
        f"({100 * graph['device_ms'] / graph['steady_ms']:.1f}% busy); "
        f"{len(runner.step_graphs)} graphs {sorted(runner.step_graphs)} "
        f"captured in {capture:.1f} ms, graph pool {pool_mb:.1f} MiB; on "
        f"{name}; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"allocated")
    if roofline:
        roofline_line(tag, "steady step", eager["cost"], dtype,
                      graph["steady_ms"], name)
    if tp > 1 and eng.kv_manager.kv_replicated:
        whole = 2 * cfg.n_layers * 512 * 16 * cfg.n_kv_heads * cfg.head_dim \
            * eng.kv[0]["k"].element_size()
        per = [sum(c[n].numel() * c[n].element_size() for n in ("k", "v"))
               for c in eng.kv]
        check(all(p == whole for p in per), f"{tag}: shard arena bytes {per}, "
              f"want the whole arena's {whole} each")
        check(all(torch.equal(c[n], eng.kv[0][n]) for c in eng.kv[1:]
                  for n in ("k", "v")),
              f"{tag}: the shards' replicated arena copies differ")
        log(f"{tag}: {tp} replicated arena copies of {whole / 2**20:.1f} MiB "
            f"each (the whole arena), bitwise equal after the run")
    check(all(id(r) in kv_rows for r in reqs),
          f"{tag}: a request's K/V was not read before its last step")
    return (tokens, [kv_rows[id(r)] for r in reqs], tag,
            [len(r.prompt) for r in reqs],
            routes_by_position(records, cfg, len(reqs), tag)
            if routes else None)


# ---------------------------------------------------------------------------
# phase 5: the serving fleet

FLEET_KW = dict(num_pages=512, page_size=16, max_batch=8, prefill_chunk=16)
CHAOS = dict(grant_denial_p=0.1, spurious_invalid_p=0.05, delayed_free_p=0.1,
             unmap_under_reader_p=0.05)
ON_CARD = ["cuda:0", "cuda:0"]  # two replicas, or two shards, on this card


def kernel_wrappers():
    from repro_torch.kernels.kv_append import kv_append_cuda
    from repro_torch.kernels.paged_attention import (
        paged_attention_append_cuda, paged_attention_cuda,
        paged_attention_sharded)
    return (paged_attention_cuda, paged_attention_append_cuda,
            kv_append_cuda, paged_attention_sharded)


def want_launches(layers, steps, shards=1):
    """Each wrapper's launches for ``steps`` engine steps of a model of
    ``layers`` layers at ``shards`` shards: the fused launch once per
    layer and shard (kernel 1's wrapper counts it too), kernel 3 once per
    layer and shard under tensor parallelism, the standalone append
    never."""
    n = layers * shards * steps
    return dict(zip((fn.__name__ for fn in kernel_wrappers()),
                    (n, n, 0, n if shards > 1 else 0)))


def reset_launches():
    """Every kernel wrapper's count, and the count of capture dry steps,
    to 0."""
    from repro_torch.serving.runner import ModelRunner

    for fn in kernel_wrappers():
        fn.launches = 0
    ModelRunner.dry_steps = 0


def read_launches(tag, layers, steps, shards=1):
    """The counts of the path just driven (set to 0 just before it): each
    wrapper exactly :func:`want_launches` of the engine steps (graph
    replays or eager steps) and the captures' dry steps, the fused launch
    at least once."""
    from repro_torch.serving.runner import ModelRunner

    got = {fn.__name__: fn.launches for fn in kernel_wrappers()}
    dry = ModelRunner.dry_steps
    want = want_launches(layers, steps + dry, shards)
    check(got == want and steps > 0,
          f"{tag}: kernel launches {got}, want {want} ({steps} steps, {dry} "
          f"capture dry steps)")
    return got


def fleet_steps(fleet, tag, layers, shards=1):
    """Drive ``fleet`` to a drain in ``step()`` mode, one thread: every
    fleet step must add :func:`want_launches` for the replicas that
    stepped, and a steady step (nothing queued, every row decoding and two
    or more tokens from its end) exactly one device->host transfer per
    replica at work (a step that captures a graph adds its dry step's
    launches too).  Returns (fleet steps, steady steps)."""
    import torch

    from repro_torch.serving.runner import ModelRunner

    wrappers = kernel_wrappers()
    n = steady = 0
    while not fleet.drained():
        live = [e for e, a in zip(fleet.replicas, fleet.alive) if a]
        working = sum(bool(e.scheduler.running) for e in live)
        is_steady = working and all(
            not e.scheduler.queue and all(
                r.committed >= len(r.prompt)
                and len(r.generated) + 2 < r.max_new_tokens
                for r in e.scheduler.running) for e in live)
        steps = [e.stats.steps for e in live]
        before = {fn: fn.launches for fn in wrappers}
        dry = ModelRunner.dry_steps
        if is_steady:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    fleet.step()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs = [w for w in caught
                     if "called a synchronizing" in str(w.message)]
            check(len(syncs) == working, f"{tag}: steady fleet step {n} "
                  f"made {len(syncs)} device->host transfers for {working} "
                  f"replicas at work: "
                  f"{[str(w.message)[:80] for w in syncs]}")
            steady += 1
        else:
            fleet.step()
        stepped = [e.stats.steps - s for e, s in zip(live, steps)]
        check(set(stepped) <= {0, 1}, f"{tag}: replica steps {stepped}")
        got = {fn.__name__: fn.launches - before[fn] for fn in wrappers}
        want = want_launches(layers, sum(stepped) + ModelRunner.dry_steps
                             - dry, shards)
        check(got == want, f"{tag} fleet step {n}: kernel launches {got}, "
              f"want {want}")
        n += 1
        check(n < 5000, f"{tag}: the fleet did not drain")
    return n, steady


def mirrors_hold(tag, engines):
    """The clock mirror per replica.  Under chaos, as in the reference's
    chaos layer: the frees it still defers are applied first (the default
    policy's end-of-drain flush does not reach it), and the clock ticks of
    its spontaneous releases, made behind the KV manager, are added to the
    mirror."""
    for i, e in enumerate(engines):
        alloc = e.kv_manager.allocator
        ticks = 0
        if hasattr(alloc, "faults"):
            alloc.flush()
            ticks = alloc.unmap_clock_ticks
        clock = int(e.pool.clock.cpu())
        check(e.stats.warnings_fired + ticks == clock,
              f"{tag}: replica {i} clock mirror {e.stats.warnings_fired} + "
              f"{ticks} spontaneous releases != pool clock {clock}")


def timed(fn):
    """(fn(), its wall seconds, ending when the card is idle)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def warm_drain(server, prompts, drive, tag, layers, shards=1):
    """``prompts`` (32 new tokens each) served twice on ``server`` (an
    engine or a fleet) by ``drive()``: the first drain warms it (its step
    graphs captured), the second is timed, its launch counts set to 0 just
    before it and held just after.  Returns (the second drain's tokens,
    its wall seconds, its steps)."""
    for second in (False, True):
        s0 = server.stats.steps
        reqs = [server.submit(p, 32) for p in prompts]
        if second:
            reset_launches()
        _, wall = timed(drive)
        check(all(r.state == "finished" for r in reqs), f"{tag}: unfinished")
    steps = server.stats.steps - s0
    read_launches(tag, layers, steps, shards)
    return [list(r.generated) for r in reqs], wall, steps


def kill_after(n):
    """A step hook that raises on replica 0's ``n``-th driver iteration."""
    calls = [0]

    def hook(_eng):
        calls[0] += 1
        if calls[0] == n:
            raise RuntimeError(f"injected kill at driver iteration {n}")
    return hook


def prefix_equal(run, base):
    """Tokens of ``run`` equal to ``base``'s before each request's first
    difference, and their total."""
    same = sum(next((i for i, (x, y) in enumerate(zip(p, q)) if x != y),
                    min(len(p), len(q))) for p, q in zip(run, base))
    return same, sum(map(len, base))


def fleet_failover(cfg, params, prompts, tag, kill_at=20, **kw):
    """A warmed 2-replica fleet with ``auto_revive``: replica 0 is killed at
    its ``kill_at``-th driver iteration while it serves ``prompts`` (32 new
    tokens each).  Returns (fleet, requests, requests first routed to
    replica 0, wall seconds, every engine that served)."""
    from repro_torch.serving import DataParallelEngine, WatchdogConfig

    fleet = DataParallelEngine(
        cfg, params, replicas=2, devices=ON_CARD,
        watchdog=WatchdogConfig(auto_revive=True), **{**FLEET_KW, **kw})
    warm = [fleet.submit(p[:16], 2) for p in prompts[:2]]
    fleet.run()  # warm (first steps) before the watchdog times anything
    check(all(r.state == "finished" for r in warm), f"{tag}: warm-up")
    s0 = fleet.stats.steps
    reqs = [fleet.submit(p, 32) for p in prompts]
    victims = [r for r in reqs if r._engine is fleet.replicas[0]]
    engines = list(fleet.replicas)
    fleet.step_hooks[0] = kill_after(kill_at)
    reset_launches()
    _, wall = timed(fleet.run)
    read_launches(tag, cfg.n_layers, fleet.stats.steps - s0)
    engines.append(fleet.replicas[0])  # the revived replica
    st = fleet.stats
    check(all(r.state == "finished" for r in reqs), f"{tag}: a request was "
          f"lost ({[r.state for r in reqs]})")
    check(st.replica_failures == 1 and st.replica_revivals == 1,
          f"{tag}: {st.replica_failures} failures, {st.replica_revivals} "
          f"revivals, want 1 and 1")
    check(st.requests_migrated >= len(victims) > 0,
          f"{tag}: {st.requests_migrated} requests migrated, "
          f"{len(victims)} were on the killed replica")
    return fleet, reqs, victims, wall, engines


STALL_S = 30.0  # the stalled replica's sleep on its stream


def fleet_stall(cfg, params, prompts, base, name, stall_at=20,
                sleep_s=STALL_S):
    """Failover on one card: a warmed float32 2-replica fleet under a 2 s
    stall timeout with ``auto_revive``; at its ``stall_at``-th driver
    iteration replica 0 enqueues a ``sleep_s`` sleep on its own stream and
    its thread blocks in the step's read.  The watchdog abandons it,
    migrates its requests and revives it on a new stream; the fleet must
    finish every request, stitched tokens equal to one engine's
    (``base``), while the stalled stream still sleeps (an event recorded
    after the sleep has not completed).  The round after the stall
    captures nothing: every step whose graph is missing runs eagerly
    (``DataParallelEngine.eager_steps_held``, which must have counted some:
    the revived replica has no graph).  Then the sleep is waited out and
    the abandoned thread joined."""
    import threading

    import torch

    from repro_torch.serving import DataParallelEngine, WatchdogConfig

    tag = f"fleet (b) float32 stall at {stall_at}"
    fleet = DataParallelEngine(
        cfg, params, replicas=2, devices=ON_CARD,
        watchdog=WatchdogConfig(stall_timeout=2.0, auto_revive=True),
        **FLEET_KW)
    warm = [fleet.submit(p[:16], 2) for p in prompts[:2]]
    fleet.run()
    check(all(r.state == "finished" for r in warm), f"{tag}: warm-up")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(100_000_000)
    end.record()
    end.synchronize()
    cycles = int(sleep_s * 1e8 / (start.elapsed_time(end) / 1e3))
    stalled, calls = {}, [0]

    def stall(_eng):
        calls[0] += 1
        if calls[0] == stall_at:
            stream = torch.cuda.current_stream()
            torch.cuda._sleep(cycles)
            stalled.update(stream=stream, done=stream.record_event(),
                           thread=threading.current_thread())
    old = fleet.streams[0]
    reqs = [fleet.submit(p, 32) for p in prompts]
    victims = [r for r in reqs if r._engine is fleet.replicas[0]]
    fleet.step_hooks[0] = stall
    t0 = time.perf_counter()
    fleet.run()
    wall = time.perf_counter() - t0
    asleep = "done" in stalled and not stalled["done"].query()
    try:
        check(asleep, f"{tag}: the stalled stream woke before the fleet "
              f"finished ({wall:.1f} s of a {sleep_s} s sleep)")
        check(stalled["stream"] == old and fleet.streams[0] is not old,
              f"{tag}: the stall was not on replica 0's stream, or the "
              f"revived replica kept it")
        st = fleet.stats
        check(all(r.state == "finished" for r in reqs),
              f"{tag}: a request was lost ({[r.state for r in reqs]})")
        check(st.replica_failures == 1 and st.replica_revivals == 1,
              f"{tag}: {st.replica_failures} failures, "
              f"{st.replica_revivals} revivals, want 1 and 1")
        check(st.requests_migrated >= len(victims) > 0,
              f"{tag}: {st.requests_migrated} requests migrated, "
              f"{len(victims)} were on the stalled replica")
        check([r.output_tokens for r in reqs] == base,
              f"{tag}: stitched tokens differ from one engine's "
              f"({prefix_equal([r.output_tokens for r in reqs], base)})")
        held = fleet.eager_steps_held
        check(held > 0, f"{tag}: no step ran eagerly while the stalled "
              f"stream slept")
    finally:
        if "done" in stalled:
            stalled["done"].synchronize()
            stalled["thread"].join(timeout=120)
    check(not stalled["thread"].is_alive(),
          f"{tag}: the abandoned driver thread did not end")
    mirrors_hold(tag, fleet.replicas)
    log(f"{tag}: replica 0 slept {sleep_s} s on its stream at its "
        f"{stall_at}th iteration; the fleet finished all {len(reqs)} "
        f"requests in {wall:.2f} s, the sleep still running ({len(victims)} "
        f"on the stalled replica, {fleet.stats.requests_migrated} migrated, "
        f"1 failure, 1 revival on a new stream, {held} steps eager while "
        f"captures were held), stitched tokens == one engine's; on {name}")


def fleet_phase(name):
    """Phase 5: full-width olmo-1b served by ``DataParallelEngine`` fleets
    on this card, then open-loop replay and the serving CLI (module
    docstring).  Nothing here is caught."""
    import gc

    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.core import ChaosConfig
    from repro_torch.launch.serve import _replay_trace, main as serve_main
    from repro_torch.models.transformer import init_decoder_lm
    from repro_torch.serving import (DataParallelEngine, PagedServingEngine,
                                     dump_trace, synthesize_trace)

    cfg = get_config("olmo-1b")
    L = cfg.n_layers
    sixteen = fleet_requests(cfg)

    def single(params, tag, graphs=True, **where):
        """One engine (on this card, or as ``where`` says) serving the 16
        requests (32 new tokens each) on a warm engine, timed
        (:func:`warm_drain`); through its step graphs, or with the eager
        step."""
        eng = PagedServingEngine(cfg, params, **(where or {"device": "cuda"}),
                                 **FLEET_KW)
        eng.runner.graphs = graphs
        out = warm_drain(eng, sixteen, eng.run, tag, L, eng.tensor_parallel)
        mirrors_hold(tag, [eng])
        return out

    # -- (a) bf16, the main path: 2 replicas on this card -------------------
    gc.collect()
    torch.cuda.empty_cache()
    params = init_decoder_lm(cfg, seed=0, dtype=torch.bfloat16,
                             device="cuda")
    fleet = DataParallelEngine(cfg, params, replicas=2, devices=ON_CARD,
                               **FLEET_KW)
    check(len({e.params.embed["tok"].data_ptr() for e in fleet.replicas})
          == 1, "fleet (a): replicas on one card must share the weights")
    handles = [st.cuda_stream for st in fleet.streams]
    check(len(set(handles)) == 2 and torch.cuda.default_stream().cuda_stream
          not in handles, f"fleet (a): the replicas' streams {handles} are "
          f"not two of their own beside the default stream")
    reqs = [fleet.submit(p, 32) for p in sixteen]
    reset_launches()
    n, steady = fleet_steps(fleet, "fleet (a) step()", L)
    launches = read_launches("fleet (a) step()", L, fleet.stats.steps)
    check(steady >= 4, f"fleet (a): only {steady} steady fleet steps")
    check(all(r.state == "finished" for r in reqs), "fleet (a): unfinished")
    mirrors_hold("fleet (a) step()", fleet.replicas)
    step_tokens = [list(r.generated) for r in reqs]
    log(f"fleet (a) bf16 step(): 2 replicas on one card, 16 requests, {n} "
        f"fleet steps, {steady} steady with one read per replica each, "
        f"replica steps {[e.stats.steps for e in fleet.replicas]}, "
        f"launches {json.dumps(launches)}")
    base, wall1, steps1 = single(params, "fleet (a) single engine")
    # warm drains from here on (:func:`warm_drain`): the timed drain of
    # a fleet or an engine holds no capture
    fleet = DataParallelEngine(cfg, params, replicas=2, devices=ON_CARD,
                               **FLEET_KW)
    tokens, wall2, run_steps = warm_drain(fleet, sixteen, fleet.run,
                                          "fleet (a) run()", L)
    launches = {fn.__name__: fn.launches for fn in kernel_wrappers()}
    mirrors_hold("fleet (a) run()", fleet.replicas)
    check(tokens == step_tokens,
          "fleet (a): threaded run() and step() generate different tokens")
    # the same drain from one thread in step() mode, timed: what the two
    # driver threads cost beyond it
    fleet = DataParallelEngine(cfg, params, replicas=2, devices=ON_CARD,
                               **FLEET_KW)

    def drain():
        while not fleet.drained():
            fleet.step()
    tokens, wall3, _ = warm_drain(fleet, sixteen, drain,
                                  "fleet (a) timed step()", L)
    check(tokens == step_tokens,
          "fleet (a): two step() drains generate different tokens")
    # the same fleet and engine on the eager step: what the graphs gain
    fleet = DataParallelEngine(cfg, params, replicas=2, devices=ON_CARD,
                               **FLEET_KW)
    for e in fleet.replicas:
        e.runner.graphs = False
    tokens, wall2e, _ = warm_drain(fleet, sixteen, fleet.run,
                                   "fleet (a) eager run()", L)
    check(tokens == step_tokens,
          "fleet (a): the eager run() and the graphs' step() generate "
          "different tokens")
    base_e, wall1e, _ = single(params, "fleet (a) eager single engine",
                               graphs=False)
    check(base_e == base, "fleet (a): the eager engine and the graph engine "
          "generate different tokens")
    gen = 16 * 32
    log(f"fleet (a) bf16 run(): 2 driver threads, {run_steps} "
        f"replica steps, launches {json.dumps(launches)}; generated "
        f"tokens/s on the same 16 requests, each server's second drain: "
        f"fleet run() {gen / wall2:.1f}, "
        f"fleet step() from one thread {gen / wall3:.1f}, one engine "
        f"{gen / wall1:.1f} ({steps1} steps; run() {wall2 / wall1:.3f}x and "
        f"step() {wall3 / wall1:.3f}x its wall time); on the eager step: "
        f"fleet run() {gen / wall2e:.1f}, one engine {gen / wall1e:.1f} "
        f"(run() {wall2e / wall1e:.3f}x its wall time); graphs against "
        f"eager: one engine {wall1e / wall1:.3f}x, fleet run() "
        f"{wall2e / wall2:.3f}x the tokens/s; on {name}")
    log(f"fleet (a) bf16, each replica on a stream of its own: fleet "
        f"tokens/s over one engine's: run() {wall1 / wall2:.3f}x, step() "
        f"{wall1 / wall3:.3f}x; on the eager step run() "
        f"{wall1e / wall2e:.3f}x; on {name}")
    same, total = prefix_equal(step_tokens, base)
    log(f"fleet (a): {same} of {total} bf16 fleet tokens equal the single "
        f"engine's before each request's first difference")
    _, reqs, victims, wall, _ = fleet_failover(
        cfg, params, sixteen, "fleet (b) bf16 failover")
    same, total = prefix_equal([r.output_tokens for r in reqs], base)
    log(f"fleet (b) bf16 failover: {len(victims)} requests on the killed "
        f"replica, {same} of {total} stitched tokens equal the single "
        f"engine's before each request's first difference (not held: bf16 "
        f"meets near ties)")

    # -- (c) bf16 chaos: step() on the roomy pool, then a kill on 64 pages --
    fault_engines = []
    fleet = DataParallelEngine(cfg, params, replicas=2, devices=ON_CARD,
                               chaos=ChaosConfig(seed=1, **CHAOS), **FLEET_KW)
    reqs = [fleet.submit(p, 32) for p in sixteen]
    reset_launches()
    n, steady = fleet_steps(fleet, "fleet (c) chaos step()", L)
    read_launches("fleet (c) chaos step()", L, fleet.stats.steps)
    check(steady >= 1, f"fleet (c): only {steady} steady fleet steps")
    check(all(r.state == "finished" for r in reqs), "fleet (c): unfinished")
    mirrors_hold("fleet (c) chaos step()", fleet.replicas)
    fault_engines += fleet.replicas
    log(f"fleet (c) chaos step(): {n} fleet steps, {steady} steady with one "
        f"read per replica each, faults "
        f"{[e.kv_manager.allocator.faults for e in fleet.replicas]}")
    # 64 pages a replica (1024 tokens for 8 rows of up to 288): ~45
    # preemptions over the 16 requests, so every fault kind fires; at 96
    # pages the pool churned only 5-10 times and a kind could fire never
    tight = dict(num_pages=64)
    fleet = DataParallelEngine(cfg, params, replicas=2, devices=ON_CARD,
                               **{**FLEET_KW, **tight})
    reqs = [fleet.submit(p, 32) for p in sixteen]
    reset_launches()
    _, wall0 = timed(fleet.run)
    read_launches("fleet (c) fault-free", L, fleet.stats.steps)
    check(all(r.state == "finished" for r in reqs), "fleet (c): unfinished")
    pre0 = fleet.stats.preemptions
    fleet, reqs, victims, wall, engines = fleet_failover(
        cfg, params, sixteen, "fleet (c) chaos + kill",
        chaos=ChaosConfig(seed=11, **CHAOS), **tight)
    mirrors_hold("fleet (c) chaos + kill", fleet.replicas)
    fault_engines += engines
    faults = {k: sum(e.kv_manager.allocator.faults[k] for e in fault_engines)
              for k in fault_engines[0].kv_manager.allocator.faults}
    check(all(v > 0 for v in faults.values()),
          f"fleet (c): a fault kind never fired: {faults}")
    gen = 16 * 32
    log(f"fleet (c) chaos + kill, 64 pages a replica, 16 requests: 0 lost, "
        f"faults {json.dumps(faults)}, {fleet.stats.preemptions} "
        f"preemptions (fault-free {pre0}), {fleet.stats.requests_migrated} "
        f"migrated; goodput {gen / wall:.1f} tokens/s against "
        f"{gen / wall0:.1f} fault-free ({wall0 / wall:.3f}x), on {name}")

    # -- (e) open-loop replay of a bursty two-class trace at ~0.6x ----------
    rate = 0.6 * 16 / wall1
    events = synthesize_trace(7, duration_s=10.0, rate_rps=rate,
                              process="bursty",
                              class_mix={"interactive": 0.7, "batch": 0.3},
                              prompt_mean=128, prompt_cap=256,
                              max_new_mean=32, max_new_cap=64)
    eng = PagedServingEngine(cfg, params, device="cuda", **FLEET_KW)
    reset_launches()
    reqs, wall = timed(lambda: _replay_trace(eng, events, cfg.vocab))
    read_launches("fleet (e) replay", L, eng.stats.steps)
    lost = sum(r.state not in ("finished", "shed", "rejected") for r in reqs)
    check(lost == 0 and len(reqs) == len(events),
          f"fleet (e): {lost} of {len(reqs)} requests lost")
    mirrors_hold("fleet (e) replay", [eng])
    log(f"fleet (e) open-loop replay: {len(events)} arrivals in 10 s at "
        f"{rate:.2f} req/s (0.6x the single engine's {16 / wall1:.2f}), "
        f"drained in {wall:.1f} s, 0 lost, on {name}")
    for cls, cs in sorted(eng.stats.class_stats.items()):
        p = cs.percentiles()
        log(f"fleet (e) class {cls}: finished {cs.finished}/{cs.submitted}, "
            f"shed {cs.shed}, rejected {cs.rejected}, TTFT p50 "
            f"{p['ttft_p50']:.4f} s, p95 {p['ttft_p95']:.4f} s, p99 "
            f"{p['ttft_p99']:.4f} s")
    del params, fleet, eng, reqs, victims, engines, fault_engines

    # -- (b) float32 failover, token-exact; (d) the float32 2D fleet --------
    gc.collect()
    torch.cuda.empty_cache()
    params = init_decoder_lm(cfg, seed=0, dtype=torch.float32, device="cuda")
    base32, _, _ = single(params, "fleet (b) float32 single engine")
    _, reqs, victims, _, _ = fleet_failover(
        cfg, params, sixteen, "fleet (b) float32 failover")
    check([r.output_tokens for r in reqs] == base32,
          f"fleet (b): float32 stitched tokens differ from one engine's "
          f"({prefix_equal([r.output_tokens for r in reqs], base32)})")
    check(all(r.migrations == 1 for r in victims),
          "fleet (b): a request of the killed replica did not migrate")
    log(f"fleet (b) float32 failover: replica 0 killed at its 20th "
        f"iteration, {len(victims)} requests migrated and re-prefilled, "
        f"1 failure, 1 revival, stitched tokens == one engine's "
        f"({sum(map(len, base32))} tokens)")
    fleet_stall(cfg, params, sixteen, base32, name)
    # the card test's point (tests/test_torch_fleet_streams.py): mid-prefill
    fleet_stall(cfg, params, sixteen, base32, name, stall_at=4,
                sleep_s=20.0)
    # the 2D fleet against one TP=2 engine: the fleet layer must change no
    # token.  TP=2 against TP=1 is the engine phase's check; over these 16
    # requests float32 TP=2 can meet a near tie against TP=1 (the bf16
    # arena rounds the two reductions' K/V apart; 508 of 512 tokens equal
    # on an H100), so agreement with TP=1 is printed here, not held
    base_tp, _, _ = single(params, "fleet (d) float32 TP=2 engine",
                           tensor_parallel=2, devices=ON_CARD)
    fleet = DataParallelEngine(cfg, params, replicas=2, tensor_parallel=2,
                               devices=ON_CARD * 2, **FLEET_KW)
    del params  # each replica holds its own shard copies
    reqs = [fleet.submit(p, 32) for p in sixteen]
    reset_launches()
    n, steady = fleet_steps(fleet, "fleet (d) 2D", L, shards=2)
    launches = read_launches("fleet (d) 2D", L, fleet.stats.steps, shards=2)
    mirrors_hold("fleet (d) 2D", fleet.replicas)
    tokens = [list(r.generated) for r in reqs]
    check(tokens == base_tp, f"fleet (d): the 2D fleet's float32 tokens "
          f"differ from one TP=2 engine's "
          f"({prefix_equal(tokens, base_tp)})")
    same, total = prefix_equal(tokens, base32)
    log(f"fleet (d) float32 2 replicas x TP=2 on one card: tokens == one "
        f"TP=2 engine's ({total}); {same} of {total} equal TP=1's before "
        f"each request's first difference; {n} fleet steps ({steady} "
        f"steady, one read per replica each), 2 x 16 shard launches per "
        f"replica step, launches {json.dumps(launches)}")
    del fleet, reqs, victims
    gc.collect()
    torch.cuda.empty_cache()

    # -- (f) the serving CLI at its reduced size, on the card ---------------
    reduced_layers = reduced(cfg).n_layers
    trace = ROOT / "build" / "chip_smoke_trace.jsonl"
    trace.parent.mkdir(parents=True, exist_ok=True)
    dump_trace(synthesize_trace(3, duration_s=1.0, rate_rps=8.0,
                                class_mix={"interactive": 0.6, "batch": 0.4},
                                prompt_mean=5, max_new_mean=3, prompt_cap=8,
                                max_new_cap=4), str(trace))
    tiny = ["--num-pages", "24", "--page-size", "4", "--max-batch", "2",
            "--prompt-len", "6", "--max-new", "3"]
    for argv in (["--requests", "4", "--replicas", "2"] + tiny,
                 ["--requests", "3", "--classes", "interactive:0.7,batch:0.3",
                  "--stream"] + tiny,
                 ["--num-pages", "32", "--page-size", "4", "--max-batch", "2",
                  "--trace", str(trace)]):
        reset_launches()
        st = serve_main(argv)  # asserts zero lost itself
        read_launches(f"cli {argv[:2]}", reduced_layers, st.steps)
    log("cli: --replicas 2, --classes --stream and --trace served on the "
        "card at the reduced size, 0 lost")
    return {"one engine": wall1, "fleet run()": wall2, "fleet step()": wall3,
            "eager one engine": wall1e, "eager fleet run()": wall2e}


def heads_tp4_phase(name):
    """Phase 5 (l): query heads the TP degree does not divide (module
    docstring).  Nothing here is caught."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_decoder_lm
    from repro_torch.serving import PagedServingEngine
    from repro_torch.sharding.rules import heads_split

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("olmo-1b"), n_heads=6, n_kv_heads=3)
    check(not heads_split(cfg, 4), "(l): 4 must not divide 6 query heads")
    params = init_decoder_lm(cfg, seed=0, dtype=torch.float32, device="cuda")
    prompts = fleet_requests(cfg)[:8]
    runs = {}
    for tp, where in ((1, dict(device="cuda")),
                      (4, dict(tensor_parallel=4,
                               devices=["cuda:0"] * 4))):
        tag = f"(l) olmo-1b Hq=6 Hkv=3 float32 TP={tp}"
        eng = PagedServingEngine(cfg, params, **where, **FLEET_KW)
        reqs = [eng.submit(p, 32) for p in prompts]
        reset_launches()
        _, wall = timed(eng.run)
        launches = read_launches(tag, cfg.n_layers, eng.stats.steps, tp)
        check(all(r.state == "finished" for r in reqs), f"{tag}: unfinished")
        mirrors_hold(tag, [eng])
        runs[tp] = [list(r.generated) for r in reqs]
        log(f"{tag}: 8 requests, {eng.stats.steps} steps in {wall:.2f} s "
            f"(captures included), launches {json.dumps(launches)}; on "
            f"{name}")
    for n in ("k", "v"):
        copies = [kv[n] for kv in eng.kv]
        check(all(torch.equal(c, copies[0]) for c in copies[1:]),
              f"(l): the shards' arena copies of {n} differ")
    check(runs[4] == runs[1], f"(l): TP=4 tokens differ from TP=1's "
          f"({prefix_equal(runs[4], runs[1])})")
    log(f"(l) olmo-1b Hq=6 Hkv=3 float32: TP=4 (the attention block whole "
        f"on every shard) tokens == TP=1's ({sum(map(len, runs[1]))} "
        f"tokens), the 4 arena copies bitwise equal")
    del eng, params


def examples_phase(name):
    """Phase (m): the port's four examples on the card (module
    docstring).  Nothing here is caught."""
    import gc

    import torch

    from repro_torch.configs import get_config, reduced

    sys.path.insert(0, str(ROOT / "examples"))
    import quickstart_torch
    import reclaim_demo_torch
    import serve_paged_torch
    import train_lm_torch

    gc.collect()
    torch.cuda.empty_cache()
    L = reduced(get_config("olmo-1b")).n_layers

    def no_launches(tag):
        got = {fn.__name__: fn.launches for fn in kernel_wrappers()}
        check(not any(got.values()), f"{tag}: kernels launched: {got}")

    s, wall = timed(quickstart_torch.host_layer_demo)
    log(f"examples quickstart host layer: warnings {s['warnings_fired']}, "
        f"restarts {s['reader_restarts']}, freed {s['nodes_freed']}, "
        f"{wall:.2f} s")
    reset_launches()
    (reqs, reqs2), wall = timed(quickstart_torch.serving_demo)
    engines = [reqs[0]._engine, reqs2[0]._engine]
    read_launches("examples quickstart serving", L,
                  sum(e.stats.steps for e in engines))
    mirrors_hold("examples quickstart serving", engines)
    log(f"examples quickstart serving: tokens "
        f"{[e.stats.tokens_committed for e in engines]}, steps "
        f"{[e.stats.steps for e in engines]}, preemptions "
        f"{engines[0].stats.preemptions}, prefix hits "
        f"{engines[1].stats.prefix_hits}, {wall:.2f} s; on {name}")
    reset_launches()
    out, wall = timed(quickstart_torch.train_demo)
    no_launches("examples quickstart train")
    # uniform random tokens (the JAX demo's data source): nothing to learn,
    # the loss stays near ln V; train_lm's ramp data must lower it
    losses = [h["loss"] for h in out["history"]]
    ln_v = math.log(reduced(get_config("olmo-1b")).vocab)
    check(all(abs(x - ln_v) < 0.1 for x in losses), f"examples quickstart "
          f"train: losses {losses} not within 0.1 of ln V = {ln_v:.4f}")
    log(f"examples quickstart train: 40 steps on random tokens, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (ln V {ln_v:.4f}), "
        f"{wall:.2f} s; on {name}")

    reset_launches()
    runs, wall = timed(serve_paged_torch.demo)
    read_launches("examples serve_paged", L,
                  sum(st.steps for st in runs.values()))
    for what, st in runs.items():
        log(f"examples serve_paged {what}: {st.tokens_committed} tokens in "
            f"{st.steps} steps, preemptions {st.preemptions}, restarts "
            f"{st.reader_restarts}, prefix hits {st.prefix_hits}")
    log(f"examples serve_paged: four workloads in {wall:.2f} s; on {name}")

    reset_launches()
    out, wall = timed(train_lm_torch.run)
    no_launches("examples train_lm")
    losses = [h["loss"] for h in out["history"]]
    log(f"examples train_lm: 300 steps, 1 injected failure, "
        f"{out['restarts']} restart, loss {losses[0]:.4f} -> "
        f"{out['final_loss']:.4f}, {wall:.2f} s; on {name}")

    rows, wall = timed(reclaim_demo_torch.strategy_rows)
    for r in rows:
        check(r[3] > 0 and r[4] == 16, f"examples reclaim_demo {r[0]}: "
              f"{r[3]} superblocks released, {r[4]} reads")
    keep = next(r for r in rows if r[0] == "keep")
    check(keep[2] >= 0.9 * keep[1], f"examples reclaim_demo keep: "
          f"{keep[2]} of {keep[1]} KiB resident after the deletes")
    log(f"examples reclaim_demo strategies (name, peak KiB, after KiB, "
        f"superblocks released, reads): {rows}, {wall:.2f} s")
    reset_launches()
    pool, wall = timed(reclaim_demo_torch.device_pool_demo)
    read_launches("examples reclaim_demo device pool", 1, pool["steps"])
    check(pool["after shrink"][0] < pool["after burst"][0]
          and pool["remapped"] > 0, f"examples reclaim_demo: {pool}")
    log(f"examples reclaim_demo device pool (mapped, resident superblocks, "
        f"mapped pages): {pool}, {wall:.2f} s; on {name}")


def fleet_requests(cfg):
    """The fleet phase's 16 prompts of 64-256 tokens."""
    import numpy as np

    rng = np.random.default_rng(5)
    return [rng.integers(0, cfg.vocab, int(n)).tolist()
            for n in rng.integers(64, 257, 16)]


def profile_fleet(name, walls):
    """``--profile``: the device time of the bf16 fleet's drain of the 16
    requests (2 replicas on this card, ``step()`` from one thread; the
    device work of ``run()`` is the same launches), beside the unprofiled
    wall times of the fleet phase (a): the share of each the card is busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_decoder_lm
    from repro_torch.serving import DataParallelEngine

    cfg = get_config("olmo-1b")
    params = init_decoder_lm(cfg, seed=0, dtype=torch.bfloat16,
                             device="cuda")
    fleet = DataParallelEngine(cfg, params, replicas=2, devices=ON_CARD,
                               **FLEET_KW)
    for p in fleet_requests(cfg):
        fleet.submit(p, 32)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        while not fleet.drained():
            fleet.step()
        torch.cuda.synchronize()
    busy = sum(getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0))
               for ev in prof.key_averages()
               if str(ev.device_type).endswith("CUDA")) / 1e6
    log(f"profile fleet: the 16-request drain holds {busy:.3f} s of device "
        f"time on {name}; busy " + ", ".join(
            f"{100 * busy / w:.1f}% of {k}'s {w:.2f} s"
            for k, w in walls.items()))


#: substrings of the matrix-product kernels' names (cuBLAS, cuBLASLt, CUTLASS)
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")


def device_rows(fn, calls):
    """(device ms per call, launches per call, name) of every device op of
    ``calls`` calls of ``fn``, from one torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = []  # device-side events only: kernels and copies
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0))
        if dev > 0 and str(ev.device_type).endswith("CUDA"):
            rows.append((dev / 1e3 / calls, ev.count / calls, ev.key))
    return rows


def profile_phase(name, tp=1, steps=5, arch="olmo-1b"):
    """``--profile``: torch.profiler traces of ``steps`` steady decode steps
    of the full-width engine at ``tp`` shards (a fresh one, after the main
    path's counts were read), with the eager step and then replaying its
    captured graph: wall and device-busy time per step and the fused
    launches the profiler counts (layers x shards, held), then the
    kernels that take the graph step's device time.  For an MoE model also the expert
    layer alone at the step's shapes (decode, and a 16-token prefill
    chunk): its device time per step and its matrix products' share."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe_apply
    from repro_torch.models.transformer import init_decoder_lm
    from repro_torch.serving import PagedServingEngine

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    params = init_decoder_lm(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    where = (dict(device="cuda") if tp == 1 else
             dict(tensor_parallel=tp, devices=["cuda:0"] * tp))
    eng = PagedServingEngine(cfg, params, num_pages=512, page_size=16,
                             max_batch=8, prefill_chunk=16, **where)
    del params
    rng = np.random.default_rng(1)
    for n in rng.integers(64, 257, 8):
        eng.submit(rng.integers(0, cfg.vocab, int(n)).tolist(), 64)
    eng.scheduler.admit()
    while any(r.committed < len(r.prompt) for r in eng.scheduler.running):
        eng.step()
    for _ in range(3):  # warm the decode path (its graph captured)
        eng.step()
    tag = f"profile {arch} tp={tp}"
    for graphs in (False, True):
        eng.runner.graphs = graphs
        eng.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()  # wall time without the profiler
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
        rows = device_rows(eng.step, steps)
        busy = sum(r[0] for r in rows)
        mode = "graph" if graphs else "eager"
        log(f"{tag} {mode}: {steps} steady decode steps on {name}: "
            f"{wall:.2f} ms/step wall (unprofiled), {busy:.2f} ms/step of "
            f"device time in {sum(r[1] for r in rows):.0f} device ops "
            f"({100 * busy / wall:.1f}% busy)")
        attn = sum(r[0] for r in rows if "paged_attention_kernel" in r[2])
        n_attn = sum(r[1] for r in rows if "paged_attention_kernel" in r[2])
        log(f"{tag} {mode}: kernel 1 with the fused append {attn:.3f} "
            f"ms/step in {n_attn:.0f} launches, {100 * attn / busy:.1f}% of "
            f"the device time")
        check(n_attn == tp * cfg.n_layers, f"{tag} {mode}: the profiler "
              f"counts {n_attn} fused launches a step, want "
              f"{tp * cfg.n_layers}")
        check(not any("kv_append_kernel" in r[2] for r in rows),
              f"{tag}: a standalone kv_append launch in the steady step")
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        log(f"  {ms:8.3f} ms/step  {count:6.0f}/step  {key[:90]}")
    if not cfg.moe or tp != 1:
        return
    moe = eng.params.blocks[0].moe
    for C in (1, 16):
        h = torch.randn((8, C, cfg.d_model), device="cuda").to(torch.bfloat16)
        layer = device_rows(lambda: moe_apply(cfg, h, moe, dropless=True), 10)
        total = sum(r[0] for r in layer)
        gemm = sum(r[0] for r in layer
                   if any(g in r[2] for g in GEMM_NAMES))
        rows_ = 8 * cfg.n_experts * C * cfg.top_k
        flops = 2 * 3 * rows_ * cfg.d_model * cfg.d_ff
        log(f"{tag}: expert layer at C={C} (8 rows, dropless capacity "
            f"{C * cfg.top_k} a row and expert): {total:.3f} ms a layer, "
            f"{cfg.n_layers * total:.3f} ms a step"
            + (f" ({100 * cfg.n_layers * total / busy:.1f}% of the steady "
               f"step's device time)" if C == 1 else "")
            + f"; matrix products {gemm:.3f} ms ({100 * gemm / total:.1f}%), "
            f"{flops / 1e9:.1f} GFLOP of padded expert products a layer "
            f"({flops / gemm / 1e9:.1f} TFLOP/s)")
        for ms, count, key in sorted(layer, reverse=True)[:6]:
            log(f"  {ms:8.3f} ms/layer  {count:4.0f}/layer  {key[:90]}")


def sass_check():
    """What the paged-attention library compiled to: which kernel
    instantiations issue tensor-core (HMMA) and cp.async (LDGSTS)
    instructions, from ``cuobjdump -sass`` where the toolkit has it."""
    from repro_torch.kernels import build

    tool = pathlib.Path(build.nvcc_path()).parent / "cuobjdump"
    if not tool.exists():
        log("sass: no cuobjdump in the toolkit; not checked")
        return
    sass = subprocess.run([str(tool), "-sass", str(build._target(
        "paged_attention"))], capture_output=True, text=True,
        check=True).stdout
    funcs = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = {"HMMA": 0, "LDGSTS": 0}
        elif name is not None:
            for op in ("HMMA", "LDGSTS"):
                funcs[name][op] += f" {op}" in line
    kern = {n: c for n, c in funcs.items() if "paged_attention_kernel" in n}
    # the fused-append instantiations: kAppend = true, mangled Lb1E
    n_append = sum("Lb1E" in n or ", true>" in n for n in kern)
    check(n_append == 15 and len(kern) == 35,
          f"want 35 paged_attention_kernel instantiations, 15 of them with "
          f"the append: {len(kern)}, {n_append}")
    mma = [n for n, c in kern.items() if c["HMMA"]]
    # the bf16 x bf16 instantiations: mangled, the bf16 type named for TQ
    # and substituted for T; or demangled
    bf16 = [n for n in kern if "I13__nv_bfloat16S" in n
            or "__nv_bfloat16, __nv_bfloat16" in n]
    log(f"sass: {len(kern)} paged_attention_kernel instantiations "
        f"({n_append} with the append); HMMA in "
        f"{len(mma)} ({sum(kern[n]['HMMA'] for n in mma)} instructions), "
        f"LDGSTS in {sum(1 for c in kern.values() if c['LDGSTS'])}")
    check(sorted(mma) == sorted(bf16) and mma,
          f"tensor-core instructions must be in exactly the bf16 x bf16 "
          f"instantiations: HMMA in {mma}, bf16 x bf16 {bf16}")
    check(all(c["LDGSTS"] for c in kern.values()),
          "every instantiation must load through cp.async (LDGSTS)")


def tp_phase(results, name, arch, record=False):
    """Full-width ``arch`` served four times (float32 and bf16 weights, each
    at TP=1 and at ``tensor_parallel=TP`` on this card; module docstring,
    phase 4), then held across runs.  float32 TP=2 against TP=1: the tokens
    must be equal, and the K/V of every position written within 2e-2 +
    2e-2|x| — for MoE, wherever no router flip reaches
    (:func:`routing_check`).  bf16: TP=2's K/V must stay within 1.25x of
    TP=1's distance from float32, at the positions where both still feed
    the model float32's tokens.  With ``record`` the bf16 TP=1 run gives
    kernels 1 and 2 and the fused launch their ``launches``, the bf16 TP=2
    run kernel 3's."""
    from repro_torch.configs import get_config

    moe = get_config(arch).moe
    f32 = engine_phase(results, name, dtype="float32", arch=arch, routes=moe)
    f32_tp = engine_phase(results, name, tp=TP, dtype="float32", arch=arch,
                          routes=moe)
    one = engine_phase(results, name, arch=arch, record=(
        ("paged_attention", "kv_append", "paged_attention_append")
        if record else ()), roofline=(arch == "olmo-1b"))
    tp = engine_phase(results, name, tp=TP, arch=arch, record=(
        ("paged_attention_sharded",) if record else ()), roofline=moe)
    tag = tp[2]
    # in float32 the two reductions round ~1e-7 apart and the arena's bf16
    # rounding turns that into a K/V element one bf16 step apart now and
    # then; random weights meet near ties
    full = [kv["k"].shape[1] - plen for kv, plen in zip(f32[1], f32[3])]
    agree = first_divergence(f32_tp, f32)
    log(f"{tag}: float32 TP={TP} tokens equal TP=1's before each request's "
        f"first difference: {sum(agree)} of {sum(map(len, f32[0]))} (at "
        f"{agree})")
    check(f32_tp[0] == f32[0], f"{tag} float32: TP={TP} tokens differ from "
          f"TP=1's (equal before divergences: {agree})")
    dist = kv_distance(f32_tp, f32, full)
    if moe:
        # such a one-bf16-step difference moves a router's k-th choice
        # where its k-th and (k+1)-th probabilities nearly tie (ROADMAP C)
        routing_check(f32_tp, f32)
    else:
        check(all(b == 0 for _, b, _ in dist.values()),
              f"{tag} float32: TP={TP} K/V differ from TP=1's beyond "
              f"tolerance: {dist}")
    # in bf16 the row-parallel partials round apart, and greedy decoding
    # over random weights meets near ties, so tokens are counted, not held;
    # what is held is that TP=2 stays as close to float32 as TP=1 does, in
    # prefill and in decode, at the positions where both still feed the
    # model float32's tokens
    depth = [min(a, b, n) for a, b, n in zip(first_divergence(one, f32),
                                              first_divergence(tp, f32), full)]
    check(sum(depth) > 0, f"{tag} bf16: no generated position of TP=1 and "
          f"TP={TP} shares float32's tokens")
    d_one, d_tp = kv_distance(one, f32, depth), kv_distance(tp, f32, depth)
    same = first_divergence(tp, one)
    log(f"{tag}: {sum(same)} of {sum(map(len, one[0]))} bf16 tokens equal "
        f"TP=1's before each request's first divergence (at {same})")
    for part in ("prompt", "decode"):
        e1, e2 = d_one[part][0], d_tp[part][0]
        check(e2 <= 1.25 * e1, f"{tag}: bf16 TP={TP} {part} K/V are {e2:.4g} "
              f"from float32 against TP=1's {e1:.4g} (limit 1.25x)")
        log(f"{tag}: bf16 {part} K/V {e2:.4g} from float32 against TP=1's "
            f"{e1:.4g} ({e2 / e1:.3f}x, limit 1.25x)")
    return f32_tp


def moe_layout_phase(results, name, f32_tp):
    """Full-width olmoe-1b-7b at ``tensor_parallel=TP`` on this card under
    the reference's other expert layouts: ``REPRO_MOE_SHARD=ep`` (whole
    experts a shard: 32 of 64 each) in float32 and bf16, ``none``
    (replicated: the layer runs once, on the lead) in bf16.  Each run is
    held as :func:`engine_phase` holds the ``tp`` runs (every request
    finishes, the clock mirror, layers x shards fused launches a step and
    no standalone append, one read per steady step) and by its expert
    bytes per shard; float32 ``ep`` against float32 ``tp`` (``f32_tp``,
    each expert's hidden axis split): the tokens equal, the K/V held by
    :func:`routing_check` (the partial sums reassociate, so a router may
    flip at a near tie).  The bf16 ``ep`` step runs under the roofline."""
    arch = "olmoe-1b-7b"
    ep32 = engine_phase(results, name, tp=TP, dtype="float32", arch=arch,
                        routes=True, moe_shard="ep")
    engine_phase(results, name, tp=TP, arch=arch, moe_shard="ep",
                 roofline=True)
    engine_phase(results, name, tp=TP, arch=arch, moe_shard="none")
    agree = first_divergence(ep32, f32_tp)
    log(f"{ep32[2]}: float32 tokens equal tp's before each request's first "
        f"difference: {sum(agree)} of {sum(map(len, f32_tp[0]))}")
    check(ep32[0] == f32_tp[0], f"{ep32[2]} float32: tokens differ from the "
          f"tp layout's (equal before divergences: {agree})")
    routing_check(ep32, f32_tp, names=("ep", "tp"))


# ---------------------------------------------------------------------------
# phase 6 (g): the non-paged model path, ``build_model`` at full width

#: arch -> prompt tokens: mamba2-780m's 1000 is no multiple of its 128-token
#: SSD chunk; recurrentgemma-9b's 2560 passes its 2048-token window,
#: misaligned with it, and is a multiple of 512, so the chunked RG-LRU
#: branch runs; whisper-tiny also encodes 1500 seeded frames
MODEL_PROMPTS = {"olmo-1b": 512, "mamba2-780m": 1000,
                 "recurrentgemma-9b": 2560, "whisper-tiny": 64}
MODEL_B, MODEL_STEPS = 4, 64


def model_batch(cfg, S, dev, seed=0, B=MODEL_B):
    """Seeded prompts [B, S] int32 (and whisper's frames [B, F, d], the
    VLM's patches [B, P, d], float32) on ``dev``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.prefix_tokens:
        b["patches"] = rng.standard_normal(
            (B, cfg.prefix_tokens, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def no_host_reads(dev):
    """On the card, any synchronising call inside raises (sync debug mode
    "error")."""
    import torch

    if dev.type != "cuda":
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def decode_loop(step, params, cache, first, S, steps, dev, free, warm=2):
    """``steps`` greedy decode steps of ``step`` (``decode_step``'s
    signature) from a prefill's ``cache`` and last logits ``first`` [B, V]:
    every step from the ``free``-th on under :func:`no_host_reads`, the
    steps from the ``warm``-th on timed.  Returns the tokens [B, steps +
    1], the logits [B, steps + 1, V], the final cache and the timed
    seconds."""
    import torch

    rows = [first]
    toks = [first.argmax(-1).to(torch.int32)]
    pos = torch.full((MODEL_B,), S, dtype=torch.int32, device=dev)
    for i in range(steps):
        if i == warm:
            _sync(dev)
            t0 = time.perf_counter()
        with no_host_reads(dev) if i >= free else contextlib.nullcontext():
            logits, cache = step(params, cache, {"token": toks[-1],
                                                 "pos": pos})
            toks.append(logits.argmax(-1).to(torch.int32))
            pos = pos + 1
        rows.append(logits)
    _sync(dev)
    return (torch.stack(toks, dim=1), torch.stack(rows, dim=1), cache,
            time.perf_counter() - t0)


def model_run(cfg, S, dtype, dev="cuda", steps=MODEL_STEPS, seed=0,
              paged=False, init_dev=None):
    """One model through ``build_model`` on ``dev``: seeded ``dtype``
    weights, a prefill of B=4 prompts of S tokens into a cache of S +
    ``steps`` slots, then ``steps`` greedy decode steps twice from that
    prefill, over two copies of its cache: eagerly (all but the first two
    steps under :func:`no_host_reads`), and through
    ``models/graphs.py::graph_decode_step`` (one captured graph, replayed;
    every call, the capturing one included, under :func:`no_host_reads`);
    then
    teacher forcing over the prompts and the fed tokens, unembedding only
    the decoded positions.  Checks (raising): finite logits and states,
    ``len``, no kernel launch (the capture recording none), the graph run
    bitwise the eager run (tokens, logits, final cache).  Returns the
    tokens [B, steps + 1], the decoded logits [B, steps + 1, V] (on
    ``dev``), the teacher-forcing error and the times (the graph run's
    too, with its capture ms and graph pool bytes); with ``paged`` (a
    decoder LM) also the paged engine's tokens on the same prompts and
    weights.  The weights are drawn on ``init_dev`` (default ``dev``), so
    two runs with the same ``init_dev`` share them."""
    import gc

    import torch

    from repro_torch.models import build_model, graph_decode_step
    from repro_torch.models.transformer import unembed

    dev = torch.device(dev)
    gc.collect()  # an earlier run's weights and caches
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=seed, dtype=dtype,
                        device=init_dev or dev).placed(dev)
    batch = model_batch(cfg, S, dev, seed)
    _sync(dev)
    init_s = time.perf_counter() - t0
    reset_launches()
    times = []
    for _ in range(2):  # cold (first use at these shapes), then warm
        t0 = time.perf_counter()
        cache, logits = model.prefill(params, batch, S + steps)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    gcache = {k: v.clone() for k, v in cache.items()}  # the graph run's
    toks, dec, cache, decode_s = decode_loop(
        model.decode_step, params, cache, logits[:, -1], S, steps, dev,
        free=2)
    step = graph_decode_step(model)
    gtoks, gdec, gcache, graph_s = decode_loop(
        step, params, gcache, logits[:, -1], S, steps, dev, free=0)
    launches = {fn.__name__: fn.launches for fn in kernel_wrappers()}
    check(not any(launches.values()),
          f"{cfg.name}: the non-paged path launched kernels {launches}")
    graphs = list(step.graphs.values())  # none on the CPU: eager there
    check(len(graphs) == (dev.type == "cuda") and all(
        g.replays == steps and not g.launches for g in graphs),
          f"{cfg.name}: {len(graphs)} decode graphs, replays "
          f"{[g.replays for g in graphs]}, recorded launches "
          f"{[g.launches for g in graphs]}; want 1 on a card, {steps}, "
          f"none")
    check(torch.equal(gtoks, toks) and torch.equal(gdec, dec),
          f"{cfg.name}: the graph run's tokens or logits differ from the "
          f"eager run's (tokens equal: {torch.equal(gtoks, toks)})")
    check(set(gcache) == set(cache) and all(
        torch.equal(gcache[k], cache[k]) for k in cache),
          f"{cfg.name}: the graph run's final cache differs from the eager "
          f"run's in {[k for k in cache if not torch.equal(gcache[k], cache[k])]}")
    check(bool(torch.isfinite(dec).all()), f"{cfg.name}: non-finite logits")
    for k, v in cache.items():
        check(k == "len" or bool(torch.isfinite(v).all()),
              f"{cfg.name}: non-finite cache {k}")
    check(bool((cache["len"] == S + steps).all()),
          f"{cfg.name}: len {cache['len'].tolist()}, want {S + steps}")
    pool = sum(graph_pool_bytes(pool) for _, pool in step.streams.values())
    capture_ms = sum(g.capture_ms for g in graphs)
    del cache, gcache, gdec, step, graphs  # the graph and its pool
    hidden, _ = model.forward(params, {**batch, "tokens": torch.cat(
        [batch["tokens"], toks[:, :steps]], dim=1)})
    tf = unembed(cfg, params, hidden[:, S - 1:]).float()
    del hidden
    diff = (dec - tf).abs()
    out = {"tokens": toks.cpu(), "logits": dec, "init_s": init_s,
           "prefill_s": times, "decode_s": decode_s, "graph_s": graph_s,
           "capture_ms": capture_ms, "pool_bytes": pool,
           "timed_steps": steps - 2, "tf_max_abs": float(diff.max()),
           # the least tol with |decode - teacher| <= tol + tol |teacher|
           "tf_tol": float((diff / (1 + tf.abs())).max()),
           "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                        if dev.type == "cuda" else None)}
    if paged:
        from repro_torch.serving import PagedServingEngine

        del tf, diff
        eng = PagedServingEngine(cfg, params, num_pages=256, page_size=16,
                                 max_batch=MODEL_B, prefill_chunk=16,
                                 device=dev)
        reqs = [eng.submit(p, steps + 1) for p in batch["tokens"].tolist()]
        eng.run()
        check(all(r.state == "finished" for r in reqs),
              f"{cfg.name}: a paged request did not finish")
        out["paged_tokens"] = [list(r.generated) for r in reqs]
    return out


def fake_counts(cfg, kind, B, S, dtype, cache_size=None):
    """``op_analysis.analyze`` of one ``build_model(cfg)`` step on fake
    tensors (the CPU, no memory) at the shapes a phase runs on the card:
    ``kind`` "prefill" (B prompts of S tokens into ``cache_size`` slots),
    "decode" (one token a row against ``cache_size`` slots) or "train"
    (``make_train_step`` on a B x S batch); ``dtype`` the parameters'."""
    import torch

    from repro_torch.configs import ShapeSpec, input_specs
    from repro_torch.launch.abstract import (abstract_cache,
                                             abstract_opt_state,
                                             abstract_params, fake_mode)
    from repro_torch.launch.op_analysis import analyze
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig

    mode = fake_mode()
    model = build_model(cfg)
    params = abstract_params(cfg, mode, dtype)
    batch = input_specs(cfg, ShapeSpec(kind, S, B, kind), mode)
    with mode:
        if kind == "train":
            opt = abstract_opt_state(params, mode)
            params.requires_grad_(True)
            return analyze(make_train_step(model, AdamWConfig()), params,
                           opt, batch)
        with torch.no_grad():
            if kind == "prefill":
                return analyze(model.prefill, params, batch, cache_size)
            cache = abstract_cache(cfg, B, cache_size, mode)
            return analyze(model.decode_step, params, cache, batch)


def profile_decode_graph(name, steps=5):
    """``--profile``: torch.profiler traces of ``steps`` steady non-paged
    decode steps of full-width olmo-1b in bf16 (phase (g)'s B=4 and
    512-token prompts), eager and then replaying
    ``graph_decode_step``'s graph: wall ms/step (unprofiled), device ms
    and ops a step, busy share, and the kernels that take the graph
    step's device time."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, graph_decode_step

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("olmo-1b")
    S = MODEL_PROMPTS["olmo-1b"]
    model = build_model(cfg)
    params = model.init(seed=0, dtype=torch.bfloat16, device="cuda")
    cache, logits = model.prefill(params, model_batch(cfg, S, "cuda"),
                                  S + MODEL_STEPS)
    state = {"cache": cache, "tok": logits[:, -1].argmax(-1).to(torch.int32),
             "pos": torch.full((MODEL_B,), S, dtype=torch.int32,
                               device="cuda")}
    tag = "profile olmo-1b bf16 non-paged decode"
    for mode, step in (("eager", model.decode_step),
                       ("graph", graph_decode_step(model))):
        def one():
            logits, state["cache"] = step(params, state["cache"], {
                "token": state["tok"], "pos": state["pos"]})
            state["tok"] = logits.argmax(-1).to(torch.int32)
            state["pos"] = state["pos"] + 1
        for _ in range(3):  # warm (the graph captured)
            one()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            one()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
        rows = device_rows(one, steps)
        busy = sum(r[0] for r in rows)
        log(f"{tag} {mode}: {steps} steady steps (B={MODEL_B}) on {name}: "
            f"{wall:.3f} ms/step wall (unprofiled), {busy:.3f} ms/step of "
            f"device time in {sum(r[1] for r in rows):.0f} device ops "
            f"({100 * busy / wall:.1f}% busy)")
    for ms, count, key in sorted(rows, reverse=True)[:8]:
        log(f"  {ms:8.3f} ms/step  {count:6.0f}/step  {key[:90]}")


def models_phase(name, measured):
    """Phase 6 (g): olmo-1b, mamba2-780m, recurrentgemma-9b and
    whisper-tiny at full width and depth through ``build_model``, float32
    then bf16, decoding eagerly and through captured graphs (module
    docstring); olmo-1b bf16's warm prefill and eager and graph decode
    ms/step go into ``measured`` for their roofline lines."""
    import torch

    from repro_torch.configs import get_config

    for arch, S in MODEL_PROMPTS.items():
        cfg = get_config(arch)
        # decode against teacher forcing: the reference's tests' bounds
        # (tests/test_models_smoke.py, tests/test_ring_cache.py)
        tol = 5e-2 if cfg.family == "hybrid" else 3e-2
        runs = {}
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"models: {arch} {str(dtype)[6:]}"
            r = model_run(cfg, S, dtype, paged=(
                arch == "olmo-1b" and dtype == torch.bfloat16))
            del r["logits"]
            runs[dtype] = r
            n = MODEL_B * r["timed_steps"]
            log(f"{tag}: B={MODEL_B} prompt {S}, {MODEL_STEPS} greedy steps "
                f"({cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
                f"{cfg.vocab_padded}); init {r['init_s']:.2f} s, prefill "
                f"{1e3 * r['prefill_s'][0]:.2f} ms cold, "
                f"{1e3 * r['prefill_s'][1]:.2f} ms warm, decode eager "
                f"{1e3 * r['decode_s'] / r['timed_steps']:.3f} ms/step "
                f"({n / r['decode_s']:.1f} tokens/s), graph "
                f"{1e3 * r['graph_s'] / r['timed_steps']:.3f} ms/step "
                f"({n / r['graph_s']:.1f} tokens/s; capture "
                f"{r['capture_ms']:.1f} ms, graph pool "
                f"{r['pool_bytes']} bytes), peak {r['peak_gib']:.2f} GiB "
                f"allocated, on {name}; decode vs teacher forcing max abs "
                f"{r['tf_max_abs']:.3g}, abs+rel {r['tf_tol']:.3g} (limit "
                f"{tol} in float32); the graph run bitwise the eager run "
                f"(tokens, logits, final cache), 0 host reads in its "
                f"capture and replays, 0 kernel launches")
            if arch == "olmo-1b" and dtype == torch.bfloat16:
                measured["prefill"] = 1e3 * r["prefill_s"][1]
                measured["decode"] = 1e3 * r["decode_s"] / r["timed_steps"]
                measured["decode_graph"] = (1e3 * r["graph_s"]
                                            / r["timed_steps"])
            if dtype == torch.float32:
                check(r["tf_tol"] <= tol,
                      f"{tag}: decode vs teacher forcing needs tolerance "
                      f"{r['tf_tol']:.3g} abs+rel, limit {tol}")
        bf = runs[torch.bfloat16]["tokens"].tolist()
        same, total = prefix_equal(bf, runs[torch.float32]["tokens"].tolist())
        log(f"models: {arch} bf16 greedy tokens equal to float32's before "
            f"each row's first difference: {same} of {total}")
        if "paged_tokens" in runs[torch.bfloat16]:
            same, total = prefix_equal(runs[torch.bfloat16]["paged_tokens"],
                                       bf)
            log(f"models: {arch} bf16 non-paged greedy tokens equal to the "
                f"paged engine's (bf16 arena) before each row's first "
                f"difference: {same} of {total}")


# ---------------------------------------------------------------------------
# phase 7 (h): training


TRAIN_B, TRAIN_S = 2, 24  # the reduced card-vs-CPU batch
TRAIN_LR = 1e-3  # the card-vs-CPU AdamW step
#: full-width olmo-1b's learning rate: with no warmup (8 steps give the
#: reference's ``min(50, steps // 10 + 1)`` = 1), the CLI's 1e-3 moves
#: every weight by ~1e-3 a step and the loss does not fall within 8 steps
TRAIN_FULL_LR = 1e-4
TRAIN_FULL_B, TRAIN_FULL_S = 4, 1024  # full-width olmo-1b's batch
#: full width through make_train_step: arch -> tokens per row
TRAIN_WIDE = {"mamba2-780m": 1024, "whisper-tiny": 448}


def train_parity():
    """(h) 1: on every reduced config, float32 with TF32 off, the card's
    ``Model.loss``, every gradient leaf and one AdamW step against the
    CPU's from the same weights and batch.  Loss within 1e-5 + 1e-4|x|,
    gradients within 1e-5 + 1e-3|x| (summation order only).  The step's
    update (new minus old parameter) within 1e-5 where the CPU's gradient
    is above 1e-6 in magnitude (100x the gradients' error, so its sign is
    the card's too); below that, where AdamW's first step (about lr times
    the gradient's sign) may take the other sign, within 2 lr."""
    import torch

    from repro_torch.configs import ARCH_IDS, get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    for arch in ARCH_IDS:
        cfg = reduced(get_config(arch))
        model = build_model(cfg)
        host = model_batch(cfg, TRAIN_S, "cpu", B=TRAIN_B)
        out = {}
        for dev in ("cpu", "cuda"):
            # the same seeded CPU draw each time (the step updates in place)
            params = model.init(seed=0, dtype=torch.float32, device="cpu")
            params = params.placed(dev).requires_grad_(True)
            loss, _ = model.loss(params, {k: v.to(dev)
                                          for k, v in host.items()})
            names, leaves = zip(*params.named_parameters())
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
            before = [p.detach().clone() for p in leaves]
            adamw_update(AdamWConfig(lr=TRAIN_LR, warmup_steps=1), params,
                         dict(zip(names, grads)), adamw_init(params))
            out[dev] = (float(loss.detach()), [g.cpu() for g in grads],
                        [(p.detach() - b).cpu()
                         for p, b in zip(leaves, before)])
        (closs, cg, cu), (gloss, gg, gu) = out["cpu"], out["cuda"]
        check(abs(gloss - closs) <= 1e-5 + 1e-4 * abs(closs),
              f"train parity {arch}: loss card {gloss} CPU {closs}")
        gerr = uerr = 0.0
        flips = 0
        for n, c, g, a, b in zip(names, cg, gg, cu, gu):
            gerr = max(gerr, float(((g - c).abs() / (1e-5 + 1e-3 * c.abs()))
                                   .max()))
            check(torch.allclose(g, c, atol=1e-5, rtol=1e-3),
                  f"train parity {arch}: gradient {n} differs by "
                  f"{float((g - c).abs().max()):.3g}")
            big = c.abs() > 1e-6
            d = (b - a).abs()
            uerr = max(uerr, float(torch.where(big, d, 0).max()))
            flips += int((~big & (d > 1e-5)).sum())
            check(bool((d[big] <= 1e-5).all() and (d <= 2 * TRAIN_LR).all()),
                  f"train parity {arch}: update of {n} differs by "
                  f"{float(d.max()):.3g}")
        log(f"train parity: reduced {arch}, loss card {gloss:.7f} CPU "
            f"{closs:.7f}; {len(names)} gradient leaves within 1e-5 + "
            f"1e-3|x| (worst at {gerr:.3g} of the limit); one AdamW step's "
            f"update max abs difference {uerr:.3g} (limit 1e-5) where "
            f"|grad| > 1e-6, {flips} elements below it past 1e-5")


@contextlib.contextmanager
def training_probe(steps_checked):
    """Patches ``launch/train.py`` for one ``train()`` call: CUDA events
    around every step function call (ms per step without host reads),
    sync debug mode "error" from each checked step's batch upload to the
    end of its step (a non-log, non-checkpoint step must make no
    device->host transfer), and a record of every checkpoint manager and
    restore.  Yields the record."""
    import torch

    import repro_torch.launch.train as tr

    rec = {"events": [], "saves": [], "restores": 0, "checked": []}
    orig_batch, orig_make = tr._device_batch, tr.make_train_step
    orig_mgr = tr.CheckpointManager
    attempt = [0]

    def device_batch(cfg, host, step, bs, dev):
        if step in steps_checked and attempt[0] == 0:
            torch.cuda.set_sync_debug_mode("error")
            rec["checked"].append(step)
        return orig_batch(cfg, host, step, bs, dev)

    def make(model, opt_cfg, **kw):
        inner = orig_make(model, opt_cfg, **kw)

        def step(params, state, batch):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            out = inner(params, state, batch)
            b.record()
            rec["events"].append((attempt[0], a, b))
            torch.cuda.set_sync_debug_mode("default")
            return out
        return step

    class Manager(orig_mgr):
        def save(self, *a, **k):
            super().save(*a, **k)
            # the write thread fills in write_s when it is done
            rec["saves"].append(self.last_save)

        def restore(self, *a, **k):
            rec["restores"] += 1
            attempt[0] += 1
            return super().restore(*a, **k)

    tr._device_batch, tr.make_train_step = device_batch, make
    tr.CheckpointManager = Manager
    try:
        yield rec
    finally:
        tr._device_batch, tr.make_train_step = orig_batch, orig_make
        tr.CheckpointManager = orig_mgr
        torch.cuda.set_sync_debug_mode("default")


def train_full(name, measured):
    """(h) 2: full-width olmo-1b through ``launch/train.py::train`` (module
    docstring); its mean steady ms/step goes into ``measured``."""
    import argparse
    import shutil
    import tempfile

    import torch

    import repro_torch.launch.train as tr
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.optim import adamw_init

    steps, B, S = 8, TRAIN_FULL_B, TRAIN_FULL_S
    (ROOT / "build").mkdir(exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="train_ckpt_", dir=ROOT / "build")
    free = shutil.disk_usage(ckdir).free
    log(f"train: checkpoint directory {ckdir}, {free / 1e9:.1f} GB free "
        f"before the run")
    args = argparse.Namespace(
        arch="olmo-1b", reduced=False, steps=steps, batch=B, seq=S,
        lr=TRAIN_FULL_LR,
        seed=0, log_every=4, ckpt_dir=ckdir, ckpt_every=4, fail_at_step=6,
        grad_compression="none", data_source="ramp", device="cuda")
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        with training_probe({2, 3}) as rec:
            out = tr.train(args)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = {fn.__name__: fn.launches for fn in kernel_wrappers()}
        check(not any(launches.values()),
              f"train: the training path launched kernels {launches}")
        losses = [h["loss"] for h in out["history"]]
        check(all(math.isfinite(x) for x in losses),
              f"train: non-finite loss {losses}")
        check(out["restarts"] == 1 and rec["restores"] == 1,
              f"train: {out['restarts']} failures, {rec['restores']} "
              f"restores, want 1 and 1")
        check(losses[-1] < losses[0],
              f"train: final loss {losses[-1]} not below the first "
              f"{losses[0]}")
        check(rec["checked"] == [2, 3], f"train: sync-checked steps "
              f"{rec['checked']}, want [2, 3]")
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for _, a, b in rec["events"]]
        steady = ms[1:]  # the first step includes the autograd warm-up
        step_ms = sum(steady) / len(steady)
        saves = rec["saves"]
        params, state = out["params"], out["opt_state"]
        fresh = tr.build_model(params.cfg).init(
            seed=1, dtype=tr.PARAM_DTYPE, device="cuda")
        t1 = time.perf_counter()
        (got, got_state), at, _ = CheckpointManager(ckdir).restore(
            (fresh, adamw_init(fresh)))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        check(at == steps, f"train: the last checkpoint is step {at}")
        for (n, p), (_, q) in zip(params.named_parameters(),
                                  got.named_parameters()):
            check(p.dtype == q.dtype == torch.bfloat16 and torch.equal(p, q),
                  f"train: restored parameter {n} differs")
        for part in ("m", "v"):
            for n, t in state[part].items():
                check(got_state[part][n].dtype == torch.float32
                      and torch.equal(t, got_state[part][n]),
                      f"train: restored {part} of {n} differs")
        check(torch.equal(state["step"], got_state["step"]),
              "train: restored step differs")
        nbytes = sum(x.numel() * x.element_size() for x in
                     [*params.parameters(), *state["m"].values(),
                      *state["v"].values()])
        log(f"train: olmo-1b full width ({params.cfg.n_layers} layers, "
            f"d_model {params.cfg.d_model}, vocab {params.cfg.vocab_padded}"
            f", remat {params.cfg.remat}), B={B} S={S}, {steps} steps with "
            f"a failure at step 6, ramp data, bf16 parameters and float32 "
            f"moments, on {name}: losses {[round(x, 4) for x in losses]} "
            f"at steps {[h['step'] for h in out['history']]}; 1 failure, 1 "
            f"restore; {step_ms:.1f} ms/step (CUDA events, mean of "
            f"{len(steady)} steps after the first; all: "
            f"{[round(x, 1) for x in ms]}), {B * S / step_ms * 1e3:.0f} "
            f"tokens/s, peak {peak:.2f} GiB allocated, {wall:.1f} s wall; "
            f"steps 2 and 3 made no device->host transfer (sync debug "
            f"'error'); 0 kernel launches")
        measured["train"] = step_ms
        log(f"train: checkpoints of {saves[-1]['bytes'] / 1e9:.2f} GB "
            f"({nbytes / 1e9:.2f} GB of parameters and moments); "
            f"{len(saves)} saves: "
            + ", ".join(f"snapshot {s['snapshot_s']:.2f} s + write "
                        f"{s['write_s']:.2f} s" for s in saves)
            + f" (async, then the final blocking one); the final one "
            f"restored bit for bit into a fresh module and optimizer state "
            f"in {restore_s:.2f} s, on {name}")
        del out, params, state, got, got_state, fresh
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    gc_cuda()


def gc_cuda():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def train_wide(name):
    """(h) 3: mamba2-780m and whisper-tiny at full width, 3 steps each
    through ``make_train_step`` (B=4, bf16 parameters, float32 moments):
    the SSD and encoder-decoder backwards at real shapes."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init

    for arch, S in TRAIN_WIDE.items():
        cfg = get_config(arch)
        gc_cuda()
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg)
        params = model.init(seed=0, dtype=torch.bfloat16,
                            device="cuda").requires_grad_(True)
        state = adamw_init(params)
        step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=1,
                                                  total_steps=3))
        reset_launches()
        losses, ms = [], []
        for i in range(3):
            batch = model_batch(cfg, S, "cuda", seed=i)
            batch = {k: (v.to(torch.bfloat16) if v.is_floating_point() else v)
                     for k, v in batch.items()}
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            params, state, met = step(params, state, batch)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
            losses.append(float(met["loss"]))
        launches = {fn.__name__: fn.launches for fn in kernel_wrappers()}
        check(not any(launches.values()),
              f"train {arch}: launched kernels {launches}")
        check(all(math.isfinite(x) for x in losses),
              f"train {arch}: non-finite loss {losses}")
        log(f"train: {arch} full width ({cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, remat {cfg.remat}), B=4 S={S}, 3 steps through "
            f"make_train_step on {name}: losses "
            f"{[round(x, 4) for x in losses]}, step ms "
            f"{[round(x, 1) for x in ms]}, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
        del params, state, met


def profile_train(name, steps=2):
    """``--profile``: a torch.profiler trace of ``steps`` steady training
    steps of full-width olmo-1b through ``make_train_step`` (B=4, S=1024,
    bf16 parameters, float32 moments, the phase's settings): wall and
    device-busy time per step, the matrix products' share and the ops
    that take the device time."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init

    gc_cuda()
    cfg = get_config("olmo-1b")
    model = build_model(cfg)
    params = model.init(seed=0, dtype=torch.bfloat16,
                        device="cuda").requires_grad_(True)
    state = adamw_init(params)
    step = make_train_step(model, AdamWConfig(lr=TRAIN_FULL_LR,
                                              warmup_steps=1, total_steps=8))
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=1024,
                                    global_batch=4, source="ramp"))
    batch = {"tokens": torch.from_numpy(pipe.next()["tokens"]).cuda()}
    holder = [params, state]

    def one():
        holder[0], holder[1], _ = step(holder[0], holder[1], batch)

    for _ in range(2):  # warm
        one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        one()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    rows = device_rows(one, steps)
    busy = sum(r[0] for r in rows)
    gemm = sum(r[0] for r in rows if any(g in r[2] for g in GEMM_NAMES))
    log(f"profile train olmo-1b: B=4 S=1024, {steps} steady steps on {name}: "
        f"{wall:.1f} ms/step wall (unprofiled), {busy:.1f} ms/step of device "
        f"time in {sum(r[1] for r in rows):.0f} device ops "
        f"({100 * busy / wall:.1f}% busy); matrix products {gemm:.1f} ms "
        f"({100 * gemm / busy:.1f}% of the device time)")
    for ms, count, key in sorted(rows, reverse=True)[:16]:
        log(f"  {ms:8.3f} ms/step  {count:6.0f}/step  {key[:90]}")


def train_phase(name, measured):
    """Phase 7 (h): training (module docstring).  olmoe-1b-7b and
    recurrentgemma-9b are not trained here: with float32 moments their
    state alone (bf16 parameters, bf16 gradients and two float32 moments,
    12 bytes a parameter: about 83 GB and 113 GB) exceeds one 80 GB card."""
    train_parity()
    train_full(name, measured)
    train_wide(name)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def train_steps(step, params, state, batches, tag):
    """``step`` over ``batches`` (the third one under sync debug mode
    "error": a steady step must make no device->host transfer) -> (params,
    state, losses, ms per step by CUDA events)."""
    import torch

    losses, events = [], []
    for i, batch in enumerate(batches):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        if i == 2:
            torch.cuda.set_sync_debug_mode("error")
        try:
            a.record()
            params, state, met = step(params, state, batch)
            b.record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        losses.append(met["loss"])
        events.append((a, b))
    torch.cuda.synchronize()
    losses = [float(getattr(x, "to_local", lambda: x)()) for x in losses]
    check(all(math.isfinite(x) for x in losses),
          f"{tag}: non-finite loss {losses}")
    return params, state, losses, [a.elapsed_time(b) for a, b in events]


def loss_grads(model):
    """(params, batch) -> (the loss, name -> its gradient) of ``model``."""
    import torch

    def fn(params, batch):
        loss, _ = model.loss(params, batch)
        names, leaves = zip(*params.named_parameters())
        return loss.detach(), dict(zip(names, torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True)))
    return fn


def sharded_f32(model, mesh, opt_cfg, batch):
    """(i) 1: float32 with TF32 off, from the same weights: the loss and
    every gradient of ``sharded`` against the unsharded within 1e-4
    abs+rel, and each parameter's change by one ``make_train_step``
    within 1e-3 of the unsharded change (relative L2 a parameter: an
    update skipped gives 1, one of flipped sign 2)."""
    import torch

    from repro_torch.launch.steps import make_train_step, sharded, step_specs
    from repro_torch.optim import adamw_init

    cfg = model.cfg

    def fresh():
        return model.init(seed=0, dtype=torch.float32,
                          device="cuda").requires_grad_(True)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want, want_g = loss_grads(model)(fresh(), batch)
        params = fresh()
        ins, _ = step_specs(cfg, "train", mesh, params, batch)
        got, got_g = sharded(loss_grads(model), mesh, (ins[0], ins[2]),
                             (None, None))(params, batch)
        got = float(got.to_local())
        check(abs(got - float(want)) <= 1e-4 + 1e-4 * abs(float(want)),
              f"sharded f32: loss {got!r} against {float(want)!r}")
        gerr, gbit = 0.0, True
        for n, g in want_g.items():
            h = got_g[n].to_local()
            check(bool(((h - g).abs() <= 1e-4 + 1e-4 * g.abs()).all()),
                  f"sharded f32: gradient {n} off by "
                  f"{float((h - g).abs().max()):.3g}")
            gerr, gbit = max(gerr, float((h - g).abs().max())), \
                gbit and torch.equal(h, g)
        del want_g, got_g, params
        step = make_train_step(model, opt_cfg)
        p0 = {n: p.detach().clone() for n, p in fresh().named_parameters()}
        params = fresh()
        params, _, _ = step(params, adamw_init(params), batch)
        want_d = {n: p.detach() - p0[n] for n, p in params.named_parameters()}
        params = fresh()
        params, _, _ = sharded(step, mesh, *step_specs(
            cfg, "train", mesh, params, batch))(params, adamw_init(params),
                                                batch)
        worst = 0.0
        for n, p in params.named_parameters():
            d, w = p.to_local().detach() - p0[n], want_d[n]
            r = float((d - w).norm() / w.norm())
            check(r <= 1e-3, f"sharded f32: parameter {n}'s change "
                  f"{r:.3g} (relative L2) off the unsharded change")
            worst = max(worst, r)
        log(f"sharded: float32 (TF32 off), step 1 from the same weights: "
            f"loss {got!r} against {float(want)!r}; gradients max abs "
            f"difference {gerr:.3g} ({'bitwise' if gbit else 'not bitwise'}"
            f"; held within 1e-4 abs+rel); one step's parameter changes "
            f"within {worst:.3g} relative L2 of the unsharded (held: 1e-3)")
        del params, want_d, p0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    gc_cuda()


def sharded_bf16_parts(model, mesh, batch):
    """(i) 2, printed: where bf16's sharded and unsharded steps part.
    Step 1's gradients leaf by leaf (which are bitwise); the sharded
    path's ``global_norm`` and vocab-parallel cross-entropy
    (``models/model.py::_ce_chunk`` under the mesh) against their plain
    versions on the same values."""
    import torch

    from repro_torch.launch.steps import sharded, step_specs
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import global_norm

    cfg = model.cfg

    def fresh():
        return model.init(seed=0, dtype=torch.bfloat16,
                          device="cuda").requires_grad_(True)

    base = fresh()
    want, want_g = loss_grads(model)(base, batch)
    params = fresh()
    ins, _ = step_specs(cfg, "train", mesh, params, batch)
    got, got_g = sharded(loss_grads(model), mesh, (ins[0], ins[2]),
                         (None, None))(params, batch)
    local = {n: g.to_local() for n, g in got_g.items()}
    parted = [n for n, g in want_g.items() if not torch.equal(g, local[n])]
    equal = sum(int((g == local[n]).sum()) for n, g in want_g.items())
    total = sum(g.numel() for g in want_g.values())
    leaves = len(want_g)
    norm_plain, norm_placed = global_norm(local), global_norm(got_g)
    norm_placed = norm_placed.to_local()
    del want_g, got_g, local, params
    # one loss chunk of random hidden states against the tied table
    g = torch.Generator(device="cuda").manual_seed(2)
    c = min(cfg.loss_chunk, batch["tokens"].shape[1] - 1)
    h = torch.randn(batch["tokens"].shape[0], c, cfg.d_model, device="cuda",
                    generator=g).to(torch.bfloat16)
    w = base.embed["tok"].detach().T
    del base
    lbl = batch["tokens"][:, 1:c + 1].long()
    msk = torch.ones(lbl.shape, device="cuda")

    def ce(h, w, lbl, msk):
        h, w = h.detach().requires_grad_(True), w.detach().requires_grad_(True)
        nll = M._ce_chunk(h, w, lbl, msk)
        return (nll.detach(), *torch.autograd.grad(nll, (h, w)))
    plain = ce(h, w, lbl, msk)
    dp = (("data",), None, None)
    placed = sharded(ce, mesh, (dp, (None, "model"), dp[:2], dp[:2]),
                     None)(h, w, lbl, msk)
    same = [torch.equal(a, b.to_local()) for a, b in zip(plain, placed)]
    log(f"sharded: bf16 step 1 from the same weights: loss "
        f"{float(got.to_local())!r} against {float(want)!r}; gradients "
        f"{equal} of {total} elements bitwise ({100 * equal / total:.4f}%), "
        f"{len(parted)} of {leaves} leaves not bitwise "
        f"({parted[:6]}{' ...' if len(parted) > 6 else ''}); global_norm "
        f"of the sharded gradients as DTensors {float(norm_placed)!r} and "
        f"as plain tensors {float(norm_plain)!r} "
        f"({'bitwise' if torch.equal(norm_placed, norm_plain) else 'not bitwise'}"
        f"); the vocab-parallel cross-entropy of one {c}-token chunk against "
        f"the plain one, bitwise: loss {same[0]}, hidden gradient "
        f"{same[1]}, table gradient {same[2]}")
    gc_cuda()


def sharded_train_phase(name, measured):
    """Phase 8 (i): the sharded training step (module docstring)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch.mesh import init_distributed, make_device_mesh
    from repro_torch.launch.steps import make_train_step, sharded, step_specs
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init

    gc_cuda()
    cfg = get_config("olmo-1b")
    model = build_model(cfg)
    B, S, lr = TRAIN_FULL_B, TRAIN_FULL_S, TRAIN_FULL_LR
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=1, total_steps=8)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=S,
                                    global_batch=B, source="ramp"))
    batches = [{"tokens": torch.from_numpy(pipe.next()["tokens"]).cuda()}
               for _ in range(SHARDED_STEPS)]

    def fresh():
        params = model.init(seed=0, dtype=torch.bfloat16, device="cuda")
        params.requires_grad_(True)
        return params, adamw_init(params)

    reset_launches()
    init_distributed(rank=0, world_size=1, device_type="cuda",
                     port=free_port())
    try:
        mesh = make_device_mesh((1, 1), device_type="cuda")
        sharded_f32(model, mesh, opt_cfg, batches[0])
        sharded_bf16_parts(model, mesh, batches[0])
        params, state, want, plain_ms = train_steps(
            make_train_step(model, opt_cfg), *fresh(), batches,
            "sharded: plain")
        want_params = {n: p.detach().clone()
                       for n, p in params.named_parameters()}
        del params, state
        gc_cuda()
        params, state = fresh()
        step = sharded(make_train_step(model, opt_cfg), mesh,
                       *step_specs(cfg, "train", mesh, params, batches[0]))
        params, state, got, ms = train_steps(step, params, state, batches,
                                             "sharded")
        launches = {fn.__name__: fn.launches for fn in kernel_wrappers()}
        check(not any(launches.values()),
              f"sharded: the training path launched kernels {launches}")
        check(all(isinstance(p, DTensor) and p.device_mesh == mesh
                  for p in params.parameters()),
              "sharded: a parameter left the mesh")
        for i, (x, y) in enumerate(zip(got, want)):
            check(abs(x - y) <= 1e-5 + 1e-4 * abs(y),
                  f"sharded: step {i} loss {x!r} against {y!r} unsharded")
        worst, equal, total = 0.0, 0, 0
        init = dict(model.init(seed=0, dtype=torch.bfloat16,
                               device="cuda").named_parameters())
        ratios = {}
        for n, p in params.named_parameters():
            p, q = p.to_local().detach(), want_params[n]
            worst = max(worst, float((p.float() - q.float()).abs().max()))
            equal += int((p == q).sum())
            total += p.numel()
            d, w = (p.float() - init[n].float(), q.float() - init[n].float())
            ratios[n] = float((d - w).norm() / w.norm())
        del init
        far = max(ratios, key=ratios.get)
        # bf16 roundings part the two runs at step 1 (the vocab-parallel
        # cross-entropy's backward, (i) 2); an update skipped gives 1, one
        # of flipped sign 2
        check(ratios[far] <= 0.5, f"sharded: parameter {far}'s change "
              f"{ratios[far]:.3g} (relative L2) off the unsharded change")
        steady, plain = ms[1:], plain_ms[1:]
        step_ms = sum(steady) / len(steady)
        measured["sharded"] = step_ms
        log(f"sharded: olmo-1b full width, B={B} S={S}, {SHARDED_STEPS} "
            f"steps of make_train_step through launch/steps.py::sharded on a "
            f"(data=1, model=1) DeviceMesh over NCCL (world size 1) on "
            f"{name}, against the same steps unsharded from the same "
            f"weights: losses {got} against {want} "
            f"({'bitwise' if got == want else 'not bitwise'}); parameters "
            f"{equal} of {total} bitwise equal ({100 * equal / total:.4f}%), "
            f"max abs difference {worst:.3g}; each parameter's change from "
            f"its initial value off the unsharded change by at most "
            f"{ratios[far]:.3g} relative L2 ({far}), median "
            f"{sorted(ratios.values())[len(ratios) // 2]:.3g}; the third "
            f"step made no device->host transfer (sync debug 'error'); 0 "
            f"kernel launches")
        log(f"sharded: {step_ms:.1f} ms/step sharded against "
            f"{sum(plain) / len(plain):.1f} ms/step unsharded (CUDA events, "
            f"mean of steps 2-{SHARDED_STEPS}; all: "
            f"{[round(x, 1) for x in ms]} and "
            f"{[round(x, 1) for x in plain_ms]}); phase (h)'s train(): "
            f"{measured['train']:.1f} ms/step, on {name}")
        del params, state, step, want_params
    finally:
        dist.destroy_process_group()
    gc_cuda()



# -- (j) the pool's public functions, (k) the host layer ----------------------

POOL_PAGES = 32768  # 64 GiB of full-depth olmo-1b pages (2 MiB each)
POOL_SB = 8  # pages a superblock
POOL_B = 64  # rows
POOL_CALLS = 300  # public calls of gate 1's seeded sequence
KV_PAGE, KV_HEADS, KV_DIM = 16, 16, 128  # olmo-1b's page, KV heads, head dim
OA_STEPS = 200  # append_kv steps of gate 3
HOST_KEYS = 100_000  # benchmarks/memory_release.py::run(quick=False)


class PoolPair:
    """One pool on the card and one on the CPU, driven through the public
    functions of ``core/pagepool.py`` together: after every call the six
    state tensors and every returned value must be bitwise equal."""

    def __init__(self, num_pages, pages_per_superblock):
        from repro_torch.core import pagepool as pp

        self.pp = pp
        self.pools = {d: pp.pool_init(num_pages, pages_per_superblock,
                                      device=d) for d in ("cuda", "cpu")}
        self.calls = 0

    def __call__(self, name, *args):
        """``args``: numpy arrays and 0-dim numpy scalars (each device gets
        a tensor of them) or ints.  Returns the card's values on the host
        (numpy; a pool return replaces the pair's pools)."""
        import numpy as np
        import torch

        outs = {}
        for dev, pool in self.pools.items():
            targs = [torch.as_tensor(a, device=dev)
                     if isinstance(a, (np.ndarray, np.generic)) else a
                     for a in args]
            out = getattr(self.pp, name)(pool, *targs)
            out = out if isinstance(out, tuple) and \
                not isinstance(out, self.pp.PagePool) else (out,)
            if isinstance(out[0], self.pp.PagePool):
                self.pools[dev], out = out[0], out[1:]
            outs[dev] = [t.cpu() for t in out]
        self.calls += 1
        for field, a, b in zip(self.pp.PagePool._fields, self.pools["cuda"],
                               self.pools["cpu"]):
            check(torch.equal(a.cpu(), b), f"pool api: {name}: {field} on "
                  f"the card differs from the CPU's")
        for a, b in zip(outs["cuda"], outs["cpu"]):
            check(a.dtype == b.dtype and torch.equal(a, b),
                  f"pool api: {name}: a returned value on the card differs "
                  f"from the CPU's")
        vals = [t.numpy() for t in outs["cuda"]]
        return vals[0] if len(vals) == 1 else tuple(vals)

    def host(self, field):
        return getattr(self.pools["cuda"], field).cpu().numpy()


def pool_sequence(pair, seed=21):
    """Gate 1: a seeded sequence of :data:`POOL_CALLS` public calls, mixed
    as ``tests/test_pagepool.py::test_share_unshare_free_release_
    interleavings`` mixes them, on both pools of ``pair``; over the card's
    run: no page granted twice while live, a version moves only on a
    zero-transition (+1) or a release (+1 over the released superblocks'
    pages), the clock equals the batches that reclaimed something.  Returns
    the op counts."""
    import numpy as np

    rng = np.random.default_rng(seed)
    B, K = POOL_B, POOL_SB
    S = POOL_PAGES // K
    refs: dict[int, int] = {}
    batches = 0
    last = None  # (pages, snapshot) of the last snapshot_versions
    counts: dict[str, int] = {}
    ops = ["alloc_pages_batch", "alloc_pages", "share_pages", "unshare_pages",
           "free_pages", "release_empty_superblocks", "map_superblocks",
           "snapshot_versions", "validate_and_commit", "validate_read"]
    probs = [.24, .08, .1, .12, .12, .08, .08, .06, .06, .06]

    def scalar(x):  # ints and 0-dim tensors both
        return int(x) if rng.random() < 0.5 else np.int32(x)

    def table():
        live = sorted(refs)
        pages = np.full((B, 16), -1, np.int32)
        if live:
            pick = rng.random(pages.shape) < 0.85
            pages[pick] = rng.choice(live, int(pick.sum()))
        return pages

    for _ in range(POOL_CALLS):
        op = str(rng.choice(ops, p=probs))
        counts[op] = counts.get(op, 0) + 1
        live = sorted(refs)
        v0, rc0, m0 = (pair.host(f) for f in ("page_version",
                                               "page_refcount", "sb_mapped"))
        zero, released = set(), np.zeros(S, bool)
        if op == "alloc_pages_batch":
            need = rng.integers(0, 6, B).astype(np.int32)  # some past 4
            grants, ok = pair(op, need, 4)
            got = grants[grants >= 0].tolist()
            check(len(set(got)) == len(got) and not set(got) & set(refs),
                  "pool api: a page granted twice while live")
            check(bool(ok) == bool((grants >= 0).sum(1).tolist()
                                   == np.minimum(need, 4).tolist()),
                  "pool api: alloc_pages_batch's ok disagrees with its grants")
            refs.update((p, 1) for p in got)
        elif op == "alloc_pages":
            pages, ok = pair(op, int(rng.integers(1, 300)))
            got = pages[pages >= 0].tolist()
            check(not set(got) & set(refs) and (len(got) > 0) == bool(ok),
                  "pool api: alloc_pages granted a live page")
            refs.update((p, 1) for p in got)
        elif op == "share_pages":
            ids = rng.choice(live, int(rng.integers(1, 17))).tolist() \
                if live else []
            if rng.random() < 0.2 or not live:
                ids.append(int(rng.integers(0, POOL_PAGES)))  # maybe free
            ids.append(-1)
            ok = pair(op, np.asarray(ids, np.int32))
            check(bool(ok) == all(p < 0 or p in refs for p in ids),
                  "pool api: share_pages' answer")
            for p in ids:  # a free page's increment alone is suppressed
                if p in refs:
                    refs[p] += 1
        elif op in ("unshare_pages", "free_pages"):
            ids = rng.choice(live, min(len(live), int(rng.integers(1, 200))),
                             replace=False).tolist() if live else []
            pair(op, np.asarray(ids + [-1, -1], np.int32))
            for p in ids:
                refs[p] -= 1
                if not refs[p]:
                    del refs[p]
                    zero.add(p)
        elif op == "release_empty_superblocks":
            n, npg = pair(op, scalar(rng.integers(0, 65)),
                          scalar(rng.integers(0, S)))
            released = m0 & ~pair.host("sb_mapped")
            check(int(n) == released.sum() and int(npg) == K * int(n),
                  "pool api: release counts")
        elif op == "map_superblocks":
            n, npg = pair(op, scalar(rng.integers(0, 65)))
            check(int(npg) == K * int(n), "pool api: map counts")
        elif op == "snapshot_versions":
            pages = table()
            last = pages, pair(op, pages)
        elif last is not None:  # validate_and_commit, validate_read
            pages, snap = last
            out = pair(op, pages, snap)
            cur = pair("snapshot_versions", pages)
            valid = out[0] if op == "validate_and_commit" else out
            want = (cur == snap).all(-1) if op == "validate_and_commit" \
                else (cur == snap).all()
            check(np.array_equal(valid, want), f"pool api: {op}'s answer")
        v1, rc1 = pair.host("page_version"), pair.host("page_refcount")
        check(sorted(np.flatnonzero(rc1).tolist()) == sorted(refs)
              and all(rc1[p] == c for p, c in refs.items()),
              f"pool api: {op}: refcounts off the host model")
        moved = np.flatnonzero(v1 != v0)
        want = sorted(zero | set(np.flatnonzero(
            np.repeat(released, K)).tolist()))
        check(moved.tolist() == want
              and ((v1[moved] - v0[moved]) % 2**32 == 1).all(),
              f"pool api: {op} moved versions {moved[:8].tolist()}..., want "
              f"{want[:8]}... (a zero-transition or a release only)")
        check(sorted(zero) == sorted(set(np.flatnonzero((rc0 > 0)
                                                       & (rc1 == 0)))),
              f"pool api: {op}: zero-transitions off the host model")
        batches += bool(zero) or bool(released.any())
        check(int(pair.host("clock")) == batches,
              f"pool api: clock {int(pair.host('clock'))}, want {batches}")
    return counts, batches


def plain_attention(q, kv, bt, lengths):
    """Decode attention over ``gather_kv``'s rows, in float32: the plain
    version gate 3 holds kernel 1 to."""
    import torch

    from repro_torch.core.pagepool import gather_kv

    B, Hq, D = q.shape
    out = torch.zeros(B, Hq, D, device=q.device)
    for r in range(B):
        n = int(lengths[r])
        k, v = (x[:n].float() for x in gather_kv(kv, bt[r],
                                                  bt.shape[1] * KV_PAGE))
        w = torch.softmax(torch.einsum("hd,thd->ht", q[r].float(), k)
                          / math.sqrt(D), -1)
        out[r] = torch.einsum("ht,thd->hd", w, v)
    return out


def oa_read_protocol(card):
    """Gate 3: the OA read protocol with kernel 1 at the deployment's size
    (module docstring, (j) 3).  Returns the pool, arena, tables and a
    snapshot for the timings."""
    import numpy as np
    import torch

    from repro_torch.core import pagepool as pp
    from repro_torch.kernels.ops import paged_attention
    from repro_torch.kernels.paged_attention import paged_attention_cuda

    B, M = POOL_B, -(-OA_STEPS // KV_PAGE) + 3
    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(21)
    pool = pp.pool_init(POOL_PAGES, POOL_SB, device=dev)
    t0 = time.perf_counter()
    kv = pp.kv_pages_init(POOL_PAGES, KV_PAGE, KV_HEADS, KV_DIM,
                          torch.bfloat16, device=dev)
    bt = torch.full((B, M), -1, dtype=torch.int32, device=dev)
    lengths = torch.zeros(B, dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)
    target = OA_STEPS - rows % 8 * 10  # rows end at 130-200 tokens

    def token():
        return torch.randn((B, KV_HEADS, KV_DIM), generator=g,
                           device=dev).to(torch.bfloat16)

    def grow(pool, kv, bt, lengths, active):
        need = (active & (lengths % KV_PAGE == 0)).to(torch.int32)
        pool, grants, ok = pp.alloc_pages_batch(pool, need, 1)
        col = (lengths // KV_PAGE).long()
        put = torch.zeros_like(bt, dtype=torch.bool)
        put[rows, col] = need.bool()
        bt = torch.where(put, grants[:, :1].expand_as(bt), bt)
        # inactive rows write through a −1 table: append_kv drops them
        kv = pp.append_kv(kv, torch.where(active[:, None], bt, -1), lengths,
                          token(), token())
        return pool, kv, bt, lengths + active.to(torch.int32), ok

    oks = []
    for _ in range(OA_STEPS):
        pool, kv, bt, lengths, ok = grow(pool, kv, bt, lengths,
                                         lengths < target)
        oks.append(ok)
    torch.cuda.synchronize()
    check(bool(torch.stack(oks).all()) and torch.equal(lengths, target.int()),
          f"oa protocol: growth failed, lengths {lengths.tolist()[:8]}...")
    fill_s = time.perf_counter() - t0
    snap = pp.snapshot_versions(pool, bt)
    q = torch.randn((B, KV_HEADS, KV_DIM), generator=g,
                    device=dev).to(torch.bfloat16)
    reset_launches()
    first = paged_attention(q, kv, bt, lengths)
    err = (first.float() - plain_attention(q, kv, bt, lengths)).abs().max()
    check(float(err) <= 2e-2, f"oa protocol: kernel 1 against plain "
          f"attention over gather_kv's rows: max err {float(err)} (tol 2e-2)")
    # a third of the rows lose every page; other rows get them, and write
    moved = rows % 3 == 0
    old_bt = bt.clone()
    pool = pp.free_pages(pool, torch.where(moved[:, None], bt, -1))
    n_moved = int(moved.sum())
    new_bt = torch.full((n_moved, M), -1, dtype=torch.int32, device=dev)
    pool, grants, ok = pp.alloc_pages_batch(
        pool, torch.full((n_moved,), M - 3, dtype=torch.int32, device=dev),
        M - 3)
    new_bt[:, :M - 3] = grants
    regranted = set(grants.flatten().tolist()) & \
        set(old_bt[moved].flatten().tolist())
    new_len = torch.zeros(n_moved, dtype=torch.int32, device=dev)
    for _ in range(2 * KV_PAGE):
        k = torch.randn((n_moved, KV_HEADS, KV_DIM), generator=g,
                        device=dev).to(torch.bfloat16)
        kv = pp.append_kv(kv, new_bt, new_len, k, -k)
        new_len += 1
    pool, n_rel, _ = pp.release_empty_superblocks(pool, 1, 0)
    again = paged_attention(q, kv, old_bt, lengths)  # stale tables
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in kernel_wrappers()}
    check(launches == {"paged_attention_cuda": 2,
                       "paged_attention_append_cuda": 0,
                       "kv_append_cuda": 0, "paged_attention_sharded": 0},
          f"oa protocol: kernel launches {launches}, want kernel 1 twice")
    check(bool(ok) and int(n_rel) == 1 and bool(torch.isfinite(
        again.float()).all()), "oa protocol: re-grant, release or the "
        "stale read failed")
    valid, _ = pp.validate_and_commit(pool, old_bt, snap)
    reads = torch.stack([pp.validate_read(pool, old_bt[r], snap[r])
                         for r in range(B)])
    check(torch.equal(valid, ~moved) and torch.equal(reads, ~moved),
          f"oa protocol: validity {valid.int().tolist()}, read "
          f"{reads.int().tolist()}, want every row but the moved ones")
    keep = ~moved
    check(torch.equal(again[keep], first[keep]),
          "oa protocol: a row that validates read other values")
    changed = int((again[moved] != first[moved]).any(-1).any(-1).sum())
    log(f"pool api: (j) 3 the OA read protocol on {card}: {B} rows grown "
        f"over {OA_STEPS} append_kv steps into a {POOL_PAGES}-page arena "
        f"({2 * kv['k'].numel() * 2 / 1e9:.2f} GB bf16; fill {fill_s:.1f} s "
        f"with growth from alloc_pages_batch), kernel 1 within "
        f"{float(err):.3g} of plain attention over gather_kv (tol 2e-2); "
        f"{n_moved} rows freed, {len(regranted)} of their pages re-granted "
        f"and overwritten, 1 superblock released; kernel 1 through the stale "
        f"tables: finite, no fault; validate_and_commit and validate_read "
        f"flag exactly the {n_moved} moved rows; the {B - n_moved} others "
        f"read bitwise what they read before ({changed} moved rows read "
        f"other values); kernel 1 launched twice")
    return pool, kv, bt, lengths, snap


def append_gather_parity():
    """``append_kv`` and ``gather_kv`` on the card bitwise equal to the
    CPU's over the same writes: −1 pages, positions past the table, ids
    past the arena (a 512-page arena of the deployment's page shape)."""
    import numpy as np
    import torch

    from repro_torch.core import pagepool as pp

    rng = np.random.default_rng(22)
    P, B, M = 512, 16, 6
    bt = rng.permutation(P)[:B * M].reshape(B, M).astype(np.int32)
    bt[rng.random(bt.shape) < 0.2] = -1
    lengths = rng.integers(0, M * KV_PAGE + 8, B).astype(np.int32)
    kvs = {d: pp.kv_pages_init(P, KV_PAGE, KV_HEADS, KV_DIM, torch.bfloat16,
                               device=d) for d in ("cuda", "cpu")}
    for _ in range(24):
        k, v = (torch.from_numpy(rng.standard_normal(
            (B, KV_HEADS, KV_DIM)).astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
        for d in kvs:
            kvs[d] = pp.append_kv(kvs[d], torch.as_tensor(bt, device=d),
                                  torch.as_tensor(lengths, device=d),
                                  k.to(d), v.to(d))
        lengths += 1
    for n in ("k", "v"):
        check(torch.equal(kvs["cuda"][n].cpu(), kvs["cpu"][n]),
              "pool api: append_kv on the card differs from the CPU's")
    for row in (bt[0], bt[3], np.asarray([-1, P + 5, 7, -1, 0, P - 1])):
        for a, b in zip(*(pp.gather_kv(kvs[d], torch.as_tensor(
                row.astype(np.int32), device=d), M * KV_PAGE) for d in kvs)):
            check(torch.equal(a.cpu(), b),
                  "pool api: gather_kv on the card differs from the CPU's")


def pool_api_phase(card):
    """Phase 9 (j): the pool's public functions on the card at a
    deployment's size (module docstring)."""
    import numpy as np
    import torch

    from repro_torch.core import pagepool as pp

    gc_cuda()
    t0 = time.perf_counter()
    pair = PoolPair(POOL_PAGES, POOL_SB)
    counts, batches = pool_sequence(pair)
    log(f"pool api: (j) 1 {pair.calls} public calls on a {POOL_PAGES}-page "
        f"pool ({POOL_PAGES // POOL_SB} superblocks of {POOL_SB}, {POOL_B} "
        f"rows, alloc_pages_batch max_grow 4) on the card and on the CPU: "
        f"state and returns bitwise equal after every call; no page granted "
        f"twice, versions moved only on zero-transitions and releases, clock "
        f"{batches} = the reclaiming batches; calls {counts} "
        f"({time.perf_counter() - t0:.1f} s on {card})")
    append_gather_parity()
    log("pool api: append_kv and gather_kv on the card bitwise equal to the "
        "CPU's (-1 pages, positions past the table, ids past the arena)")

    pool, kv, bt, lengths, snap = oa_read_protocol(card)
    B = POOL_B
    dev = torch.device("cuda")
    need = torch.ones(B, dtype=torch.int32, device=dev)
    pages = bt[:, :4].contiguous()
    five = torch.tensor(5, dtype=torch.int32, device=dev)
    small = pp.kv_pages_init(64, KV_PAGE, KV_HEADS, KV_DIM, torch.bfloat16,
                             device=dev)
    small_bt = torch.arange(B, dtype=torch.int32, device=dev)[:, None] \
        .expand(B, 2).contiguous()
    small_bt[::7, 0] = -1
    small_len = (torch.arange(B, device=dev) % (2 * KV_PAGE)).int()
    kn = torch.zeros((B, KV_HEADS, KV_DIM), dtype=torch.bfloat16, device=dev)
    calls = {
        "alloc_pages_batch": lambda: pp.alloc_pages_batch(pool, need, 4),
        "alloc_pages": lambda: pp.alloc_pages(pool, 64),
        "unshare_pages": lambda: pp.unshare_pages(pool, pages),
        "free_pages": lambda: pp.free_pages(pool, pages),
        "share_pages": lambda: pp.share_pages(pool, pages),
        "release_empty_superblocks":
            lambda: pp.release_empty_superblocks(pool, five, 1),
        "map_superblocks": lambda: pp.map_superblocks(pool, five),
        "snapshot_versions": lambda: pp.snapshot_versions(pool, bt),
        "validate_and_commit": lambda: pp.validate_and_commit(pool, bt, snap),
        "validate_read": lambda: pp.validate_read(pool, bt, snap),
        "kv_pages_init": lambda: pp.kv_pages_init(
            64, KV_PAGE, KV_HEADS, KV_DIM, torch.bfloat16, device=dev),
        "append_kv": lambda: pp.append_kv(small, small_bt, small_len, kn, kn),
        "gather_kv": lambda: pp.gather_kv(kv, bt[0], bt.shape[1] * KV_PAGE),
    }
    check(sorted(calls) == sorted(n for n in pp.__all__ if n[0].islower()
                                  and n not in ("pool_init",
                                                "superblock_states")),
          "pool api: gate 2 must call every public function")
    for fn in calls.values():  # warm: the allocator holds every block
        fn()
    torch.cuda.synchronize()
    with no_host_reads(dev):  # gate 2
        for fn in calls.values():
            fn()
    torch.cuda.synchronize()
    log(f"pool api: (j) 2 each of the {len(calls)} public functions called "
        f"once under sync debug mode 'error': no host sync")
    arena_calls = {
        "append_kv (full arena)": lambda: pp.append_kv(
            kv, bt, torch.clamp(lengths - 1, min=0), kn, kn)}
    ms = {n: time_ms(fn) for n, fn in {**calls, **arena_calls}.items()}
    log(f"pool api: call ms (CUDA events, mean of 20 back-to-back calls) at "
        f"{POOL_PAGES} pages, {POOL_B} rows, a {bt.shape[1]}-column table "
        f"(kv_pages_init, append_kv: a 64-page arena; 'full arena': the "
        f"{POOL_PAGES}-page one, which each call copies) on {card}: "
        + json.dumps({n: round(v, 4) for n, v in ms.items()}))
    del pool, kv, small, pair
    gc_cuda()
    return ms


def exercise_protocol(alloc):
    """``tests/test_layering.py::_exercise``: the ``Allocator`` protocol's
    share/free/version/release contract on one implementation (a device
    pool's snapshot is read back to the host)."""
    import torch

    from repro_torch.core.allocator import Allocator

    def snapshot(ids):
        return torch.as_tensor(alloc.snapshot(ids)).cpu().tolist()

    check(isinstance(alloc, Allocator), "host: not an Allocator")
    ids, ok = alloc.alloc(3)
    check(ok and len(ids) == 3, "host: alloc(3)")
    base = snapshot(ids)
    check(alloc.share(ids[:1]), "host: share of a live unit")
    alloc.free(ids[:1])
    check(snapshot(ids) == base,
          "host: share/unshare of a held unit moved a version")
    alloc.free(ids)
    check(all(b > a for b, a in zip(snapshot(ids), base)),
          "host: the zero-transition must bump versions")
    check(not alloc.share(ids[:1]), "host: sharing a free unit")
    n_sb, _ = alloc.release(1)
    view = alloc.view()
    check(view.superblocks_released >= n_sb >= 0
          and view.superblocks_mapped <= view.superblocks_total
          and view.pages_per_superblock > 0, f"host: view {view}")
    alloc.release(0)
    check(alloc.view().superblocks_mapped >= 0, "host: release(0)")


def host_layer_phase(card):
    """Phase 10 (k): the host layer on the card's host (module docstring):
    ``benchmarks/memory_release.py::run(quick=False)`` through the port's
    ``repro_torch.core``, then the protocol exerciser over the host arena
    and the device pool."""
    import torch

    from repro_torch.core import (PAGE_SIZE, HostAllocator, LRMalloc,
                                  MichaelHashTable, OAVer, ReleaseStrategy)
    from repro_torch.core.pagepool import DevicePagePool

    n = HOST_KEYS
    reset_launches()
    rows = {}
    for strategy in ReleaseStrategy:
        t0 = time.perf_counter()
        alloc = LRMalloc(num_superblocks=512, superblock_size=64 * 1024,
                         strategy=strategy)
        ar = alloc.arena
        try:
            rec = OAVer(alloc, limbo_threshold=64)
            ht = MichaelHashTable(rec, int(n / 0.75))
            ctx = rec.thread_ctx()
            acq = ar.sb_acquired
            check(all(ht.insert(k, ctx) for k in range(1, n + 1)),
                  f"host {strategy.value}: an insert failed")
            first = ar.sb_acquired - acq
            peak = alloc.resident_bytes(), ar.resident_rss_pages() * PAGE_SIZE
            check(all(ht.delete(k, ctx) for k in range(1, n + 1)),
                  f"host {strategy.value}: a delete failed")
            rec.flush(ctx)
            alloc.flush_all_caches()
            after = alloc.resident_bytes(), ar.resident_rss_pages() * PAGE_SIZE
            check(not any(b.keys(ctx) for b in ht.buckets),
                  f"host {strategy.value}: the table is not empty")
            freed = rec.stats.snapshot()["nodes_freed"]
            check(freed > 0.9 * n, f"host {strategy.value}: OAVer freed "
                  f"{freed} of {n} nodes")
            released = alloc.stats.persistent_released
            # every superblock's range, released ones included, reads back
            for base in range(0, ar.total, ar.sb_size):
                alloc.read_u64(base + 16)
                alloc.read_u64(base + ar.sb_size - 8)
            reused = alloc.stats.superblocks_reused_mapped
            acq = ar.sb_acquired
            check(all(ht.insert(k, ctx) for k in range(1, n + 1)),
                  f"host {strategy.value}: a second-fill insert failed")
            second = ar.sb_acquired - acq
            reused = alloc.stats.superblocks_reused_mapped - reused
            check(released > 0 and second < first and reused > 0,
                  f"host {strategy.value}: released {released}, second fill "
                  f"acquired {second} superblocks against the first's "
                  f"{first}, reused {reused} parked ranges")
            if strategy is ReleaseStrategy.KEEP:
                # KEEP retires superblocks (the counter above) but hands no
                # frame back: no remap, and Pss stays (tests/
                # test_allocator.py::test_keep_strategy_retains_frames)
                check(ar.remap_syscalls == 0 and after[0] >= 0.9 * peak[0],
                      f"host keep: remaps {ar.remap_syscalls}, Pss "
                      f"{after[0]} after against {peak[0]} at peak")
            rows[strategy.value] = dict(
                peak_pss_kib=peak[0] >> 10, peak_rss_kib=peak[1] >> 10,
                after_pss_kib=after[0] >> 10, after_rss_kib=after[1] >> 10,
                shrank=after[0] < peak[0], superblocks_released=released,
                first_fill_sb=first, second_fill_sb=second,
                ranges_reused=reused, remap_syscalls=ar.remap_syscalls,
                nodes_freed=freed, s=round(time.perf_counter() - t0, 2))
        finally:
            alloc.close()
    host = HostAllocator(block_bytes=64, num_superblocks=16,
                         superblock_size=64 * 1024)
    try:
        exercise_protocol(host)
    finally:
        host.close()
    exercise_protocol(DevicePagePool(16, 4, ReleaseStrategy.MADVISE,
                                     device="cuda"))
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in kernel_wrappers()}
    check(not any(launches.values()), f"host: kernels launched {launches}")
    log(f"host: (k) {n} keys into a MichaelHashTable under OAVer over "
        f"LRMalloc(512 x 64 KiB), deleted, flushed, refilled, per "
        f"ReleaseStrategy, on the host of {card}: every insert and delete "
        f"true, the table empty, every superblock's range read back; "
        f"resident KiB (Pss, Rss), superblocks, seconds: " + json.dumps(rows))
    log(f"host: the Allocator protocol exerciser passed on HostAllocator "
        f"(LRMalloc palloc) and on DevicePagePool on cuda; 0 kernel "
        f"launches; RSS shrank after release under madvise: "
        f"{rows['madvise']['shrank']}, under shared_remap: "
        f"{rows['shared_remap']['shrank']}")
    return rows


SHARDED_STEPS = 3
DRYRUN_CELLS = [("olmo-1b", "train_4k"), ("qwen2-72b", "decode_32k")]
#: the collective bytes a device of :data:`DRYRUN_CELLS` moves, by kind, as
#: ``python -m repro_torch.launch.dryrun`` counts them on the CPU container
#: (PyTorch 2.13): the card's machine must count the same
DRYRUN_COLLECTIVES = {
    ("olmo-1b", "train_4k"): {"all-gather": 27193245696.0,
                              "reduce-scatter": 21877489664.0,
                              "all-reduce": 827326496.0},
    ("qwen2-72b", "decode_32k"): {"all-gather": 7955955712.0,
                                  "all-reduce": 83886080.0},
}
#: their dot FLOPs a device, as the CPU container counts them: held too, as
#: DTensor's shape propagation, counted, would show there
DRYRUN_DOT_FLOPS = {("olmo-1b", "train_4k"): 46256797777920.0,
                    ("qwen2-72b", "decode_32k"): 114408030208.0}
#: the phase (g) and (h) paths counted on fake tensors for their roofline
#: lines: name -> (tag, what, kind, B, S, cache slots)
COUNTED = {
    "prefill": ("models: olmo-1b bfloat16", f"prefill (B={MODEL_B}, "
                f"S={MODEL_PROMPTS['olmo-1b']})", "prefill", MODEL_B,
                MODEL_PROMPTS["olmo-1b"],
                MODEL_PROMPTS["olmo-1b"] + MODEL_STEPS),
    "decode": ("models: olmo-1b bfloat16", f"decode step (B={MODEL_B}, "
               f"{MODEL_PROMPTS['olmo-1b'] + MODEL_STEPS} slots)", "decode",
               MODEL_B, MODEL_PROMPTS["olmo-1b"],
               MODEL_PROMPTS["olmo-1b"] + MODEL_STEPS),
    "train": ("train: olmo-1b", f"step (B={TRAIN_FULL_B}, S={TRAIN_FULL_S})",
              "train", TRAIN_FULL_B, TRAIN_FULL_S, None),
}


def write_counts(path):
    """:func:`fake_counts` of every :data:`COUNTED` path (olmo-1b, bf16
    parameters), as JSON at ``path``: run in :func:`start_dryrun`'s child,
    off the card's critical path."""
    import torch

    from repro_torch.configs import get_config

    torch.set_num_threads(1)
    cfg = get_config("olmo-1b")
    out = {}
    for key, (_, _, kind, B, S, size) in COUNTED.items():
        c = fake_counts(cfg, kind, B, S, torch.bfloat16, size)
        out[key] = {k: c[k] for k in ("dot_flops", "hbm_bytes", "n_ops")}
    pathlib.Path(path).write_text(json.dumps(out))


def start_dryrun():
    """Start ``launch/dryrun.py`` on :data:`DRYRUN_CELLS` (the production
    mesh) in a child process that sees no card, so it counts on the CPU
    while the phases run; returns (its output directory, the process)."""
    import tempfile

    (ROOT / "build").mkdir(exist_ok=True)
    out = pathlib.Path(tempfile.mkdtemp(prefix="dryrun_", dir=ROOT / "build"))
    code = ("import sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import torch\n"
            "torch.set_num_threads(1)\n"
            "from repro_torch.launch import dryrun\n" + "".join(
                f"dryrun.main(['--arch', {a!r}, '--shapes', {sh!r}, "
                f"'--out-dir', {str(out)!r}])\n" for a, sh in DRYRUN_CELLS)
            + "import chip_smoke\n"
            f"chip_smoke.write_counts({str(out / 'counts.json')!r})\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, proc


def finish_dryrun(out, proc, measured, name):
    """Wait for :func:`start_dryrun`'s child, hold its records (every cell
    ``ok``) and log them through ``launch/roofline.py``, then the roofline
    lines of the :data:`COUNTED` paths against their ``measured`` ms; the
    records are deleted after."""
    import shutil

    from repro_torch.launch import roofline

    try:
        t0 = time.perf_counter()
        text, _ = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"dryrun: exit {proc.returncode}: "
              f"{text[-2000:]}")
        for line in text.splitlines():
            log(f"dryrun: {line}")
        rows = roofline.build_table(str(out))
        check(sorted((r["arch"], r["shape"]) for r in rows)
              == sorted(DRYRUN_CELLS) and all(r["status"] == "ok"
                                              for r in rows),
              f"dryrun: records {[(r['arch'], r['shape'], r['status']) for r in rows]}")
        for r in rows:
            rec = json.loads((out / f"{r['arch']}_{r['shape']}_pod16x16.json")
                             .read_text())["hlo"]
            want = DRYRUN_COLLECTIVES[(r["arch"], r["shape"])]
            check(r["collective_s"] is not None
                  and rec["collective_bytes"] == want,
                  f"dryrun: {r['arch']} {r['shape']} collective bytes "
                  f"{rec['collective_bytes']}, the CPU container's {want}")
            flops = DRYRUN_DOT_FLOPS[(r["arch"], r["shape"])]
            check(rec["dot_flops"] == flops,
                  f"dryrun: {r['arch']} {r['shape']} dot FLOPs "
                  f"{rec['dot_flops']!r}, the CPU container's {flops!r}")
            log(f"dryrun: {r['arch']} {r['shape']}: a device's collectives "
                f"{rec['collective_bytes']} bytes in "
                f"{rec['collective_counts']} calls and {rec['dot_flops']!r} "
                f"dot FLOPs (equal to the CPU container's), "
                f"{r['collective_s']:.4f} s at NVLink's 450 GB/s")
        log(f"dryrun: {len(rows)} cells on the production mesh (counts on "
            f"the CPU; H100 spec-sheet bounds), waited "
            f"{time.perf_counter() - t0:.1f} s at the end:")
        for line in roofline.render_markdown(rows).splitlines():
            log(f"dryrun: {line}")
        counts = json.loads((out / "counts.json").read_text())
        for key, (tag, what, *_) in COUNTED.items():
            roofline_line(tag, what, counts[key], "bfloat16", measured[key],
                          name)
        # the captured decode step does the eager step's work
        tag, what = COUNTED["decode"][:2]
        roofline_line(tag, f"graph {what}", counts["decode"], "bfloat16",
                      measured["decode_graph"], name)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(out, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.kernels.build import build_all, ptxas_table

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    name = torch.cuda.get_device_name(0)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    logs = build_all()
    log(f"built kernels in {time.perf_counter() - t0:.1f} s")
    table = {}
    for out in logs.values():
        table.update(ptxas_table(out))
    log("ptxas [registers, stack-frame bytes, spill-store bytes, spill-load "
        "bytes] of every "
        "kernel instantiation, this build's beside the fixed-split "
        "kernel's: " + (json.dumps(
            {k: [list(v), PTXAS_FIXED_SPLITS.get(k)]
             for k, v in sorted(table.items())}) if table else
            "none (the libraries were built before this run)"))
    sass_check()
    dry_dir, dry = start_dryrun()

    results = {}
    kernel_phase(results)
    parity_phase()
    tp_phase(results, name, "olmo-1b")
    # the MoE main path: its bf16 runs give the kernels line its launch
    # counts (paligemma's are in its own log lines)
    moe_tp = tp_phase(results, name, "olmoe-1b-7b", record=True)
    moe_layout_phase(results, name, moe_tp)
    tp_phase(results, name, "paligemma-3b")
    walls = fleet_phase(name)
    heads_tp4_phase(name)
    measured = {}
    models_phase(name, measured)
    train_phase(name, measured)
    sharded_train_phase(name, measured)
    card = smi.stdout.strip().splitlines()[0]
    pool_api_phase(card)
    host_layer_phase(card)
    examples_phase(name)
    if "--profile" in sys.argv[1:]:
        profile_phase(name)
        profile_phase(name, tp=TP)
        profile_phase(name, arch="olmoe-1b-7b")
        profile_phase(name, tp=TP, arch="paligemma-3b")
        profile_fleet(name, walls)
        profile_decode_graph(name)
        profile_train(name)

    finish_dryrun(dry_dir, dry, measured, name)

    kernels = [results["paged_attention"], results["kv_append"],
               results["paged_attention_sharded"],
               results["paged_attention_append"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms")
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
