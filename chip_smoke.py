#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``src/repro_torch``) once on one card.

Phases (any failure exits non-zero; nothing is caught into a pass):

1. Device and build: print the card's name and power limit, build all
   seven CUDA kernel libraries from ``src/repro_torch/csrc`` for sm_90a
   (one nvcc per source, started together) and print the build seconds,
   each kernel's ptxas registers and spills, and the tensor-core (HMMA)
   instructions in the SASS of ``morph_matmul``, ``flash_attention``,
   ``fused_decode``, ``flash_decode``, ``fused_verify`` and ``ssd_scan``.
2. The read rate a streaming kernel can reach under the timer below
   (``read_rate``). Kernels vs their plain versions, on the card, at full
   TinyLlama-1.1B shapes in bf16 with B = 8 slots at mixed widths
   {0.25, 0.5, 1.0}: ``morph_matmul`` over the seven projections of one
   decoder layer plus a width that is not tile-aligned, and again at the
   verify pass's shapes (B = 8 x S = 5 rows) and at 64 rows; ``fused_decode_step`` on a 1024-row cache at mixed
   positions, plain and int8-KV, with each of its three launches
   (attention, QKV, output projection) timed beside its own byte bound and
   the attention beside SDPA over the same live rows; ``fused_verify`` on a 512-row cache at
   mixed committed counts, a bf16 cache with the linear mask (S = 5) and an
   int8 cache with a (2, 2) token-tree mask (S = 7), each launch on the
   tensor-core route, its three launches (QKV, attention, output
   projection) timed in both of its timed passes, the attention beside its
   bound and beside SDPA over the same live rows and extension columns
   under the same boolean mask; ``fused_verify`` at the shape a failover
   replay chunk gives it (``check_replay_chunk``: B = 8 slots of S = 8
   rows, linear, 64 query rows per (slot, KV head), dense and paged, on
   the tensor-core route, timed beside SDPA); the page-table half of both
   (``check_paged``: B = 8 over a 512-row capacity, page 16, shuffled
   pages, two slots sharing four, a bf16 and an int8 cache; each paged
   launch against its plain paged version, on the tensor-core route,
   bit-identical to its dense twin over the same contents, and timed beside
   that twin and its bound, the layer and its attention launch); the
   verify kernels with a token tree's depths and ancestor mask
   (``check_tree_verify``: trees (2, 2, 1) and (3, 2, 1), 11 and 16 nodes,
   88 and 128 query rows per (slot, KV head), over a bf16 and an int8
   cache, dense and paged; each against its plain version, each paged
   launch bit-identical to its dense twin; the layer, its paged twin, the
   plain version and the attention launch timed, the attention beside its
   bound and SDPA under the tree's boolean mask); ``flash_attention`` at
   the full-width prompt pass (1 x 256 tokens, 32 / 4 heads of 64, causal,
   bf16), at a ragged S = 200 and at the reference's ``kernel_bench`` shape
   (f32, window 0 and 64); ``flash_decode`` at the serving cache's shape
   (8 slots x 32 heads over 8 x 4 KV rows of 512, group 8) with a bf16 and
   an int8 cache at kv_len 1, 300 and 512 (at kv_len 1 beside an empty
   kernel and the kernel's skeleton at the same grid and clusters: the
   timer's floor), and at ``tests/test_flash_decode.py``'s largest case;
   the route counts of both decode kernels. Then ``fused_decode_step`` and
   ``fused_verify`` (linear S = 5 and tree (2, 2, 1)) at the attention
   shapes of the MoE families (``check_fused_attention_shapes``: granite's
   16 / 8 heads of 64, group 2, and jamba's 32 / 8 heads of 128, group 4,
   without RoPE; B = 8, a 512-row bf16 cache), each against its plain
   version on the tensor-core route, timed beside it. Then the shapes of
   the encoder-decoder and frontend models: ``flash_decode`` at whisper's
   cross-attention decode (``check_cross_decode``: 64 KV rows of 1500
   encoder positions, group 1, bf16 cache, bf16 and f32 queries) beside
   SDPA and its byte bound; ``flash_attention`` unmasked at whisper's
   encoder (1500 x 1500, 8 heads of 64) and cross prompt pass (16 x 1500)
   and causal at internvl's prompt pass (8 x 320, 16 / 8 heads of 128) in
   ``check_flash_attention``; ``morph_matmul`` over one whisper and one
   internvl decoder layer's projections (``check_morph_matmul_frontend``:
   B = 8, widths (0.5, 1)); the fused decode layer at whisper's (8 / 8
   heads of 64, no RoPE) and internvl's (16 / 8 of 128, RoPE) shapes,
   beside its byte bound. Then at full
   Mamba2-370M shapes: ``morph_matmul`` over the four gated projections of
   one SSM layer (B = 8, widths {0.5, 1.0}, at decode shape and at the
   verify pass's S = 5), and ``ssd_scan`` at the
   full-width prompt pass (1 x 256 tokens, 32 heads of 64, n = 128, chunk
   256; and 200 tokens, a ragged tile, through ``ops.ssd_scan_bshn``) and
   at the reference's ``kernel_bench`` shape, each of its three launches
   beside the sum. Each is timed on the card
   (device time of its kernels from ``torch.profiler``, L2 flushed before
   every call; the CUDA-event time of the whole call, host launch gaps
   included, is printed beside it) together with its plain version, a
   library yardstick where one PyTorch call computes the same function
   (``scaled_dot_product_attention`` for the flash kernels), and its bound
   from the H100 data sheet.
3. End to end, one card, seeded random weights, the port's
   ``ServingEngine`` (8 slots, a Poisson trace with prompts of 16-256 and
   32-64 new tokens, cache 512, prefill threshold 8, the admission mode
   moved every 12 ticks along a schedule of every (depth, width) mode):
   full-width ``tinyllama-1.1b`` cut to 8 of its 22 layers (exits 4 and
   6; 10 requests) nine times: plain decode
   unfused, ``fused=True``, and ``fused=True`` with
   ``attn_impl="chunked"`` (every prompt pass through ``flash_attention``),
   then linear self-speculation
   (``SpecConfig(ks=(4,), min_accept_rate=0.0)``) unfused greedy, fused
   greedy and fused at temperature 0.8 with top-k 50, then token-tree
   speculation with the tree (2, 2, 1) (K = 4 built beside it) the same
   three ways; then, on a trace of 12 requests whose prompts share a
   128-token prefix, all admitted in the full mode, six fused drives:
   plain, greedy speculative and greedy tree speculative, each over a
   dense cache and over a block-paged one (page 16, the worst-case pool of
   264 pages), asserting identical tokens pair by pair, radix hits, the
   page accounting after every tick, every fused launch paged; then
   full-width ``mamba2-370m`` cut to 8 of its 48 layers (exits 4 and 6;
   10 requests) three times: plain greedy, speculative greedy and tree
   speculative greedy (depth 8 drafts at exit 6, depth 6 at exit 4).
   Each drive with more requests than slots must admit them at two modes
   or more (the queued ones at later modes). Before each model's drives, its f32
   smoke config serves greedily on the card with the tree (unfused; for
   TinyLlama also fused, and fused over pages) and on the CPU, every
   engine's tokens asserted equal to the card's plain engine's. Then the
   smoke configs of granite, mixtral (window 8) and jamba on the card
   against the CPU (decode, capacity-dispatch prefill and verify, unfused
   and fused; jamba's fused kernels run without RoPE), and full-width
   ``granite-moe-1b-a400m`` cut to 6 of its 24 layers (exits 3 and 4; 32
   experts of 512, top-8, 12 requests) four ways: plain unfused, plain fused, speculative
   K = 4 fused greedy and tree (2, 2, 1) fused greedy, each drive printing
   its step or tick (host and device ms, idle share, heaviest kernels),
   the step's byte bound and the bytes the experts' per-step cast to bf16
   moves.
   Launch counters are zeroed just before each drive and read just after
   it, and each path must show its exact counts, worked out from the
   engine's own counters (plain steps, draft steps at the draft depth,
   verify steps, prefills and the depth each ran to): TinyLlama unfused, 7 ``morph_matmul`` per
   decoder-layer step; fused, 3 ``morph_matmul`` per layer-step, 1
   ``fused_decode`` per decode or linear-draft layer-step and 1
   ``fused_verify`` per verify layer-step (linear or tree), and 7
   ``morph_matmul`` per layer and level of a tree draft (its level passes
   take the einsum attention, as the reference's do); Mamba2, 4
   ``morph_matmul`` per SSM layer-step (and per layer and tree level)
   and 1 ``ssd_scan`` per SSM layer of every prefill; under
   ``attn_impl="chunked"``, 1 ``flash_attention`` per attention layer of
   every prefill, and none on any other drive; granite, 4 ``morph_matmul``
   per layer-step unfused, and fused 1 ``fused_decode`` per decode or
   draft layer-step, 1 ``fused_verify`` per verify layer-step and 4
   ``morph_matmul`` per layer and level of a tree draft (its experts run
   ``torch.matmul`` over the expert axis); every ``fused_decode``,
   ``fused_verify`` and ``flash_decode`` launch on the tensor-core route.
   Then one 256-token prompt pass of the drives' TinyLlama under the
   einsum and under the chunked attention (host and device ms), one of
   their Mamba2 (8 scans), and the ``flash_decode`` entry point (the
   reference's only caller of that kernel) driven once per TinyLlama layer
   at the serving cache's shape. Speculative drives
   report acceptance, tokens per verify launch per slot, tick p50/p95 and
   the device time of the draft's scratch copy; greedy ones the host and
   device ms and kernel launches of one full-depth tick (a tree's beside a
   linear K = 4 tick of the same engine); every drive its peak device
   memory. Also: the decode step at
   the narrowest vs full width with its device idle share, token
   agreement of fused vs unfused and of speculative vs plain greedy, and
   each smoke model on the card against the plain versions on the CPU
   (decode, prefill and verify, and for TinyLlama a chunked prefill
   through the flash kernel; a small-input reference).
   Then the encoder-decoder and frontend families at full width and depth
   (``encdec_phase``, ``vlm_phase``): ``whisper-base`` (98.8 M
   parameters) on 8 requests of 1500 seeded frames and a 4-token prompt,
   one prompt pass under the einsum and one under the chunked attention
   (18 ``flash_attention`` launches: 6 encoder layers, 6 decoder self- and
   6 cross-attentions), 32 greedy decode steps at depth 6 and 8 at depth 3,
   unfused (8 ``morph_matmul`` and 1 ``flash_decode`` per layer-step) and
   fused (4 ``morph_matmul``, 1 ``fused_decode``, 1 ``flash_decode``), then
   the engine unfused and fused on 12 Poisson requests (prompts 4-16, no
   prefill admission for these families, as in the reference), then full
   depth in f32 on the card against the CPU (a chunked prompt pass and 4
   fused steps); ``internvl2-2b`` (1.898 B) the same way with 256 seeded
   patches and 64 text tokens (24 ``flash_attention`` launches under the
   chunked attention; 32 fused steps, 3 ``morph_matmul`` and 1
   ``fused_decode`` per layer-step), its engine fused, and 4 layers of full
   width in f32 against the CPU. Each drive's counts are exact and every
   launch over bf16 takes the tensor-core route.
   Then failover (``failover_phase``), each drive fused and greedy with 8
   slots, capacity 512 and all 12 (Mamba2: 8) Poisson requests arriving at
   t ~ 0 (rate 1e6, seed 5, 30% interactive, prompts 1-64): full-width
   ``tinyllama-1.1b`` cut to 8 layers (an exit at 4) with
   ``attn_impl="chunked"``, linear K = 2 over a
   dense cache and tree (2, 2, 1) over a paged one (page 16), 32-64 new
   tokens; ``mamba2-370m`` cut to 24 layers (an exit at 12), linear K = 2,
   16 new tokens; and
   TinyLlama cut to 4 layers in f32 (an exit at 2). Each runs the trace
   unsupervised, under a counting ``ExecutorSupervisor`` (the fault-free
   reference; each tick's snapshot timed) and as a chaos run over two
   pre-warmed engines ping-ponged by the supervisor, with one planned
   failure at each of three launch sites (decode, verify, prefill; the
   paged tree drive paged_decode, tree_verify, prefill), every one of which
   must fire. Restores replay each live slot's committed tokens through
   the kernels (prefills, one-token launches, verify chunks of up to 8
   tokens). Each failover compares the restored cache with the failed
   engine's on every live slot's committed rows, per leaf and layer group.
   The chaos run's launches are exact: the final engine's own steps (as
   for a fault-free run) plus each replay call's and each interrupted
   tick's prefills. Streams must equal the fault-free run's, with its
   counters, no request dropped or completed twice, and page accounting
   intact; in bf16 a stream that parts must be a near tie, rescored at the
   parting position from each run's cache of the request (the f32 and
   Mamba2 drives must be identical). Recovery (rebuild, replay, first
   token after it), replay launches, tokens/s unsupervised / supervised /
   chaos and peak memory are printed.
   Then the online autoscaler (``autoscale_phase``): full-width
   ``tinyllama-1.1b`` (22 layers, f32 masters, bf16 activations), fused,
   greedy, 8 slots, capacity 512, prefill threshold 8, K = 2 warmed and
   K = 4 the candidate the live MOGA may adopt (interval 1, population 8,
   2 generations, seed 0, the table budget one step above warmup's), on a
   two-phase trace (``autoscale_traces``: a burst at t = 0, then sparse
   arrivals); dense, paged (page 16) and cut to 4 layers in f32, each
   beside a fixed-mode baseline on the same trace, and a bare pre-warmed
   standby restoring the dense drive's snapshot and binding an autoscaler
   that re-publishes K = 4 synchronously. Asserted: adoption off the
   serving thread on the worker's stream, a retirement, the table within
   its budget, every build after warmup published, no stalled tick, no
   dropped build, the fused verify at S = 5 on the serving thread, exact
   serving launches and, counted apart, exact build launches; paged: a
   retired bucket and plain launches rounded up to a live one; streams
   equal the baseline's (f32) or part at near ties only (bf16). Build
   seconds, MOGA generation host ms, tick host ms with a build in flight
   and without, and peak memory are printed.
   Then mesh serving (``mesh_phase``): ``MeshExecutor`` at world size 1
   over NCCL in this process, full-width fused bf16 TinyLlama on 8
   requests, tokens and launch counts identical to ``LocalExecutor``'s;
   then tp = 2 as two ranks sharing the card over gloo (``mesh_ranks``,
   started by ``launch.mesh.spawn_ranks``; a rank's failure fails the
   run), ``MESH_DRIVES``: full-width fused TinyLlama cut to 6 layers (8
   requests) plain and K = 2, Mamba2 cut to 6 layers (4 requests), and
   both cut to 4 layers in
   f32; full-width whisper-base and internvl2-2b (6 of its 24 layers; the
   token feed) and granite-moe-1b-a400m cut to 12 of its 24 layers in f32
   (16 of its 32 experts a rank) plain and K = 2. Every mesh drive submits one request a tick, each at the next mode
   (``staggered_drive``: mixed widths in several depth groups, prefill
   admission and the token feed), and must cover a narrow width and a
   shallower depth; each rank's streams and launches identical to rank
   0's, f32 streams identical to the local drive's, bf16 ones parting only
   at near ties (the logits' change capped at ``MESH_MAX_CHANGE_STEPS``
   bf16 steps), each rank's launches of a plain or f32 drive equal to the
   local drive's. Then ``mesh_model_drives``: whisper-base and
   internvl2-2b at full width in f32, 8 requests through a prompt pass
   with frames or patches under ``attn_impl="chunked"`` (``flash_attention``)
   and fused decode steps (whisper's cross-attention on ``flash_decode``),
   each rank's launches equal to the local drive's and the logits to
   ``MESH_F32_ATOL``; ``mesh_autoscale_drive``: the autoscale phase's
   4-layer f32 drive with every engine over the mesh, each rank held to
   that phase's checks, the ranks' publish and retire ticks, launches and
   streams equal; ``serve_2d_drive``: ``serve_2d`` over (2, 1), TinyLlama
   at full width, 4 layers, f32, each rank holding ``param_specs``' cut,
   streams and launches equal to the local drive's, the gathers' host ms
   per step printed. Two ranks on one
   card measure the collectives' placement, not multi-card speed. Phase 2
   holds ``morph_matmul``, the fused decode and the fused verify (S = 5)
   at TinyLlama's tp = 2 rank shapes (``check_shard_shapes``), and those,
   ``flash_decode`` and ``flash_attention`` at granite's, whisper's and
   internvl's (``check_family_shard_shapes``).
4. Training, one card. The scan's backward kernel (``ssd_scan_bwd``, on
   the forward kernel's kept workspace) against ``ssd_scan_bwd_plain`` at
   the Mamba2-370M training shape (B = 8, S = 256, 32 heads of 64,
   n = 128) with x in f32 and in bf16, at width 0.5, at a ragged S = 200
   and with a tile decay past 88, each gradient's error printed against its
   tolerance, timed (profiler, cold L2) beside its plain version and its
   bound. Then full-width Mamba2-370M cut to 4 layers (f32, B = 2,
   S = 256): ``loss_fn`` gradients on the card against the CPU plain route.
   Then two seeded runs of 2 full-depth Mamba2-370M train steps in one
   process, whose parameters and optimizer moments must be bit-identical
   (``check_reproducible``). Then full-width Mamba2-370M cut to 24 layers
   (exits 12 and 18) from seeded random weights: 20
   ``make_train_step`` steps (B = 8, S = 256, AdamW, over 4 batches; the
   loss must fall), DistillCycle over ``default_schedule`` (6 stages, 2
   teacher + 2 student steps each) and ``eval_modes(with_agreement=True)``,
   every step's forward and backward scan launches checked (a base step:
   24 and 24; a teacher step at grown depth D: D and D; a student step at
   depth d: D + d and d); 5 TinyLlama-1.1B train steps (no hand kernel
   on its path); and 5 whisper-base train steps (B = 8, 1500 frames and 64
   decoder tokens a sequence; no hand kernel on its path; the fifth step
   revisits the first's batch and its loss must be lower). Step ms (wall and device), idle share, peak memory,
   history and agreement per path are printed. The DistillCycle-trained
   Mamba2 parameters (which require grad) then serve 4 requests x 16 new
   tokens, plain and linear-speculative, with exact launch counts and the
   acceptance printed. Last, a Mamba2-370M ``TrainRunner`` cut to 24
   layers restart (``restart_drive``): 4 steps with a checkpoint every 2 and a
   failure injected before step 3, resumed by ``run_with_restarts``, must
   end bit-identical to 4 uninterrupted steps; save and restore seconds
   and bytes printed, the checkpoints in a temporary directory removed
   afterwards. Then training on a (data, model) mesh (``train_mesh_phase``):
   a full-width TinyLlama-1.1B train step cut to 2 layers (f32,
   B = 1, S = 4096) under ``attn_impl="chunked"`` must launch no
   ``flash_attention`` and give the einsum route's loss, while the fused
   chunked serving drive launched it (its count asserted exact there);
   ``make_train_step(
   grad_shardings=...)`` at world size 1 over NCCL in this process (3
   Mamba2 steps) bit for bit the one-card step's; then two ranks sharing
   the card over gloo (``train_mesh_ranks``): full-width Mamba2-370M cut
   to 8 layers (f32, B = 8, S = 256, AdamW, 3 steps, step-1 gradients
   checked) at (dp, tp) = (2, 1) and (1, 2), and TinyLlama-1.1B cut to 2
   layers (bf16 activations, 2 steps) at (1, 2) with sequence parallelism
   and the bf16-dW matmul and at (2, 1) with bf16 gradients, each held to
   the one-card step (``TRAIN_MESH_TOL``), each rank's kernel launches
   exact (a Mamba2 rank: 8 ``ssd_scan`` and 8 ``ssd_scan_bwd`` a step, at
   its shard's rows and heads; none on TinyLlama's), each rank's state
   bytes beside the dry-run's reckoning; step wall and device ms, idle
   share and the host-staged collectives' ms a step printed. Phase 2 holds
   ``ssd_scan`` and ``ssd_scan_bwd`` at those rank shapes
   (``check_ssd_train_shards``).
5. A ``{"kernels": [...]}`` JSON line (``fused_decode`` and
   ``fused_verify`` add their paged timings under ``paged`` and the paged
   drives' counts under ``paged_launches_by_path``; ``fused_verify`` its
   tree shapes under ``tree`` and the fused tree drive's count under
   ``tree_launches``; the three that granite's drives run add their counts
   there under ``granite_launches``, and ``fused_decode`` / ``fused_verify``
   the MoE attention shapes under ``moe_attention_shapes``; the kernels of
   the whisper and internvl drives their counts under ``encdec_launches``
   and ``vlm_launches``, ``morph_matmul`` their layers under
   ``frontend_layers``, ``fused_decode`` their attention shapes under
   ``frontend_attention_shapes`` and ``flash_decode`` its cross shape under
   ``cross_attention``; ``ssd_scan_bwd`` is the port's kernel with no
   Pallas counterpart; the kernels of the failover drives and the restart
   drive add their counts there under ``failover_launches``, and
   ``fused_verify`` its replay-chunk shape under ``replay_chunk``; the
   kernels of the autoscale drives their serving counts under
   ``autoscale_launches`` and their builds' warm launches under
   ``autoscale_build_launches``, ``fused_verify`` its S = 5 serving count
   under ``autoscale_verify_s5_serving``; ``morph_matmul``, ``fused_decode``,
   ``fused_verify``, ``ssd_scan``, ``flash_attention`` and ``flash_decode``
   rank 0's counts in the mesh drives under ``mesh_launches``, their tp = 2
   shard-shape rows under ``shard_shapes_tp2`` (the families' under
   ``family_shard_shapes_tp2``, ``flash_decode``'s under
   ``cross_attention_shard_tp2``)), then
   the last line ``{"ok": true, "device": {...}}``.

Run from the repository root: ``python3 chip_smoke.py``. Needs one CUDA
card; exits non-zero without one, and outside a checkout of the repository.
``--skip-e2e`` stops after the kernel checks (phase 2 and the backward
kernel of phase 4).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import copy
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet (dense, no sparsity)
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12

# kernel vs plain on the card, bf16 outputs: one bf16 rounding step apart
# (the two sum in different orders, then round) plus a small absolute floor
RTOL_BF16 = 2.0 ** -7
ATOL_BF16 = 1e-3
# a verify over an int8 cache attends to its new keys and values through
# their int8 round trip, quantized from f32 projections that the kernel and
# the plain version sum in different orders: now and then a value (or a
# row's absmax scale) lands on the other side of a rounding edge, one int8
# step apart (as the decode's int8 cache writes may, which its check
# allows), and moves a few outputs by up to ~1e-2. With a token tree's 88
# and 128 query rows such a step comes up in most launches. So tree outputs
# over an int8 cache: all but INT8_EDGE_FRAC of them within the bf16
# tolerance above, none farther than INT8_EDGE_ATOL + RTOL_BF16; the check
# prints the same count for the plain version against itself with its
# weights scaled by 1 + 2^-20 (the size of a summation-order difference)
INT8_EDGE_FRAC = 1e-4
INT8_EDGE_ATOL = 2e-2
# smoke model (f32) on the card vs the plain versions on the CPU
ATOL_SMOKE = 1e-3
# ssd_scan vs its plain versions on the card, f32: the kernel restarts the
# decay sum every 64 steps, the plain version every chunk (256 steps at
# full width), so the two round exp(cs_q - cs_s) differently
RTOL_SCAN = 1e-3
ATOL_SCAN = 1e-3
# flash kernels vs their plain versions on the card, f32: the same f32
# arithmetic summed in another order and over other tiles (64 in the
# kernels, 128 in the plain versions); outputs are averages of O(1) values
RTOL_F32 = 1e-4
ATOL_F32 = 1e-4


START = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(msg: str) -> None:
    log(f"{msg} (at {time.perf_counter() - START:.1f} s)")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def sass_mma(name: str) -> str:
    """The tensor-core instructions (HMMA) in a built library's SASS, from
    ``cuobjdump -sass``, per kernel that has any."""
    import shutil

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return "SASS not read (no cuobjdump)"
    sass = subprocess.run([tool, "-sass", str(_build._target(name))],
                          capture_output=True, text=True).stdout
    counts, fn = {}, "?"
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :", 1)[1].strip()
        elif "HMMA" in ln:
            counts[fn] = counts.get(fn, 0) + 1
    return (f"HMMA instructions in SASS, by kernel: {counts}" if counts
            else "no HMMA instruction in SASS")


def device_rows(torch, fn, iters: int):
    """``torch.profiler``'s per-kernel rows (name, device microseconds,
    launches) over ``iters`` calls of ``fn`` (CUPTI sees the
    ctypes-launched kernels too)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [(r.key, r.self_device_time_total, r.count)
            for r in prof.key_averages() if r.device_type == DeviceType.CUDA]


def kernel_us(torch, fn, iters: int):
    """Per-kernel device microseconds over ``iters`` calls of ``fn``."""
    return {k: us for k, us, _ in device_rows(torch, fn, iters)}


class Timer:
    """Device time of one call, with a cold L2 before each call.

    ``ms`` sums the durations of the GPU kernels the call launched, from
    ``torch.profiler``, leaving out the L2 flush's own kernel (found by name
    in a flush-only profile); a call the profiler sees no device time for
    in three profiles fails the run. ``wall_ms`` is the CUDA-event time of the whole call,
    host launch gaps included."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8,
                                     device="cuda")
        self.flush_names = set(kernel_us(torch, self._flush, 2))
        self.last = {}

    def _flush(self):
        self.flush_buf.zero_()

    def warm_ms(self, fn, iters: int = 20) -> dict:
        """Device ms per call of each kernel over ``iters`` back-to-back
        calls with no flush between them (L2 and the instruction caches
        warm, as in a serving loop), from ``torch.profiler``; profiled
        again (three times in all) when a profile comes back empty."""
        for _ in range(3):
            fn()
        self.torch.cuda.synchronize()
        for _ in range(3):
            per = {k: v / iters / 1e3
                   for k, v in kernel_us(self.torch, fn, iters).items()}
            if sum(per.values()) > 0.0:
                return per
        fail("torch.profiler recorded no device time for a warm call")

    def wall_ms(self, fn, iters: int = 20) -> float:
        torch = self.torch
        pairs = []
        for _ in range(iters):
            self._flush()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / iters

    def ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        self.torch.cuda.synchronize()

        def call():
            self._flush()
            fn()

        # a profile now and then comes back without its device events;
        # profile again (up to three times in all) before failing the run
        for _ in range(3):
            per = {k: v / iters / 1e3 for k, v in kernel_us(self.torch, call,
                                                           iters).items()
                   if k not in self.flush_names}
            if sum(per.values()) > 0.0:
                self.last = per
                return sum(per.values())
            log("  (torch.profiler recorded no device time; profiling again)")
        fail("torch.profiler recorded no device time for a timed call")


def close(torch, got, want, rtol=RTOL_BF16, atol=ATOL_BF16):
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool((err <= atol + rtol * w.abs()).all())
    return ok, float(err.max()) if err.numel() else 0.0


def beyond_bf16(torch, got, want):
    """(outputs beyond the bf16 tolerance, max |err|) of ``got`` vs
    ``want``."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    return (int((err > ATOL_BF16 + RTOL_BF16 * w.abs()).sum()),
            float(err.max()) if err.numel() else 0.0)


def close_int8_edges(torch, got, want):
    """The INT8_EDGE_* rule: (ok, max |err|, outputs beyond the bf16
    tolerance)."""
    n_out, e = beyond_bf16(torch, got, want)
    far = (got.float() - want.float()).abs() > (
        INT8_EDGE_ATOL + RTOL_BF16 * want.float().abs())
    ok = n_out <= INT8_EDGE_FRAC * got.numel() and not bool(far.any())
    return ok, e, n_out


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------


def mm_cases(torch, timer, gen, cases, S: int, title: str):
    """Check and time ``morph_matmul`` against its plain version over
    ``cases`` (name, K, N, active_n, active_k, calls per layer), B = 8
    slots of S rows each, bf16 activations and f32 weights. Logs each case
    and the per-layer sum (cases weighted by their calls per layer)."""
    from repro_torch.kernels import morph_matmul as MM

    B = 8
    tot = dict(ms=0.0, wall_ms=0.0, plain_ms=0.0, bound_ms=0.0,
               library_ms=0.0)
    max_err = 0.0
    for name, K, N, an, ak, per_layer in cases:
        x = torch.randn(B, S, K, generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randn(K, N, generator=gen, device="cuda") / math.sqrt(K)
        got = MM.morph_matmul(x, w, an, ak)
        want = MM.morph_matmul_plain(x, w, an, ak)
        torch.cuda.synchronize()
        ok, err = close(torch, got, want)
        if an is not None:
            cols = torch.arange(N, device="cuda")[None, None, :]
            dead = (cols >= an[:, None, None]).expand(B, S, N)
            if bool((got[dead] != 0).any()):
                fail(f"morph_matmul {name}: columns past active_n not zero")
        if not ok:
            fail(f"morph_matmul {name} ({B}, {S}, {K}) x {N}: max |err| "
                 f"{err:.3e} beyond rtol {RTOL_BF16:.2e} + atol "
                 f"{ATOL_BF16:.0e}")
        max_err = max(max_err, err)
        t_k = timer.ms(lambda: MM.morph_matmul(x, w, an, ak))
        t_kw = timer.wall_ms(lambda: MM.morph_matmul(x, w, an, ak))
        t_p = timer.ms(lambda: MM.morph_matmul_plain(x, w, an, ak))
        wb, x2 = w.to(torch.bfloat16), x.view(B * S, K)
        t_l = timer.ms(lambda: torch.matmul(x2, wb))
        # bound: the live weight block (widest slot) read once as f32, x
        # read once, out written once; ops = 2 * live rows * live cols
        an_h = [N] * B if an is None else an.tolist()
        ak_h = [K] * B if ak is None else ak.tolist()
        live_w = max(min(a, K) for a in ak_h) * max(min(a, N) for a in an_h)
        nbytes = live_w * 4 + B * S * (K + N) * 2
        ops = S * sum(2 * min(a, K) * min(n, N) for a, n in zip(ak_h, an_h))
        bound = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_BF16) * 1e3
        log(f"  morph_matmul {name:9s} ({B}, {S}, {K:5d}) x {N:5d} max|err| "
            f"{err:.3e}  kernel {t_k:.4f} ms (call, event-timed {t_kw:.4f} "
            f"ms)  plain {t_p:.4f} ms  torch.matmul(bf16, full width) "
            f"{t_l:.4f} ms  bound {bound:.4f} ms (bytes; kernel at "
            f"{bound / t_k:.2f} of it, {t_k / t_l:.2f}x the library)")
        for k_, v_ in (("ms", t_k), ("wall_ms", t_kw), ("plain_ms", t_p),
                       ("bound_ms", bound), ("library_ms", t_l)):
            tot[k_] += v_ * per_layer
    log(f"  morph_matmul, {title}: kernel {tot['ms']:.4f} ms (event-timed "
        f"{tot['wall_ms']:.4f} ms), plain {tot['plain_ms']:.4f} ms, library "
        f"{tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms; at "
        f"{tot['bound_ms'] / tot['ms']:.2f} of the bound, "
        f"{tot['ms'] / tot['library_ms']:.2f}x the library; tolerance rtol "
        f"{RTOL_BF16:.2e} + atol {ATOL_BF16:.0e}")
    return dict(max_abs_err=max_err, **tot)


def _layer_cases(cfg, act):
    """The gated projections of one decoder layer's decode step: an
    encoder-decoder layer's cross-attention adds a query and an output
    projection of the self-attention's shapes, a GELU MLP has one input
    projection where SwiGLU has two."""
    dm, ff, qd, kvd = cfg.d_model, cfg.d_ff, cfg.q_dim, cfg.kv_dim
    attn = 2 if cfg.is_encdec else 1
    mlp_in = 2 if cfg.activation == "swiglu" else 1
    # name, K, N, active_n, active_k, calls per decoder layer
    return [("wq", dm, qd, act["q_dim"], None, attn),
            ("wk/wv", dm, kvd, act["kv_dim"], None, 2),
            ("attn wo", qd, dm, None, act["q_dim"], attn),
            ("wi/wg" if mlp_in == 2 else "wi", dm, ff, act["d_ff"], None,
             mlp_in),
            ("mlp wo", ff, dm, None, act["d_ff"], 1)]


def read_rate(torch, timer, cfg):
    """The card's read rate as kernels are timed here: one ``torch.amax``
    over an f32 weight of TinyLlama's wq (16.8 MB, also the size of the
    attention's output projection), of the fused QKV weights (21.0 MB) and
    of wi (46.1 MB), the
    median of 20 CUDA-event times, with the L2 flushed before each call as
    the timer flushes it (zeroing 256 MB, which leaves it dirty, so the
    first reads also write that back) and by reading the 256 MB instead (a
    clean L2). The ceiling a weight-streaming kernel can reach under this
    timer, beside the data sheet's 3.35 TB/s."""
    dm, ff = cfg.d_model, cfg.d_ff

    def median_ms(w, flush):
        pairs = []
        for _ in range(20):
            flush()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            torch.amax(w)
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return sorted(a.elapsed_time(b) for a, b in pairs)[10]

    res = {}
    for name, (k, n) in (("wq", (dm, dm)), ("wq+wk+wv", (dm, cfg.q_dim
                                                          + 2 * cfg.kv_dim)),
                         ("wi", (dm, ff))):
        w = torch.randn(k, n, device="cuda")
        nbytes = w.numel() * 4
        t_dirty = median_ms(w, timer._flush)
        t_clean = median_ms(
            w, lambda: timer.flush_buf.view(torch.int32).sum())
        res[name] = (nbytes / t_dirty / 1e9, nbytes / t_clean / 1e9)
        log(f"  read rate, torch.amax over {nbytes / 1e6:.1f} MB of f32 "
            f"({name}): {res[name][0]:.2f} TB/s ({t_dirty * 1e3:.1f} us) "
            f"after the timer's flush (dirty L2), {res[name][1]:.2f} TB/s "
            f"({t_clean * 1e3:.1f} us) after a read-only flush (data sheet "
            f"{HBM_BYTES_PER_S / 1e12:.2f}); CUDA events, median of 20")
    return res


def check_morph_matmul(torch, cfg, timer, act=None):
    """``morph_matmul`` over the seven projections of one TinyLlama decoder
    layer, B = 8 decode rows at mixed widths {0.25, 0.5, 1.0} (or the gates
    ``act``), plus a width that is not tile-aligned."""
    from repro_torch.core import elastic

    widths = [0.25, 0.5, 1.0, 0.25, 0.5, 1.0, 0.5, 0.25]
    if act is None:
        act = elastic.active_widths_batch(cfg, widths, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    dm = cfg.d_model
    odd_n = torch.tensor([1000, 2048, 37, 512, 1999, 64, 2048, 1],
                         dtype=torch.int32, device="cuda")
    odd_k = torch.tensor([1500, 2048, 2047, 33, 700, 2048, 1, 96],
                         dtype=torch.int32, device="cuda")
    cases = _layer_cases(cfg, act) + [
        ("unaligned", dm, dm, odd_n, odd_k, 0)]
    return mm_cases(torch, timer, gen, cases, 1,
                    "one decoder layer (7 projections, B=8, mixed widths)")


def check_morph_matmul_frontend(torch, timer, shard_tp=0, archs=None):
    """``morph_matmul`` over the projections of one whisper-base decoder
    layer (d_model 512: self- and cross-attention 512 x 512, GELU MLP 512
    x 2048) and one internvl2-2b layer (d_model 2048, 16 / 8 heads of 128,
    SwiGLU 8192), B = 8 decode rows at widths (0.5, 1) x 4 as the model
    drives run them, bf16 activations (the tensor-core route); with
    ``shard_tp``, rank 0's shard of each layer (``layer_config``)."""
    gen = torch.Generator(device="cuda").manual_seed(41)
    res = {}
    for arch in archs or FRONTEND_ARCHS:
        c, act = layer_config(torch, arch, [0.5, 1.0] * 4, shard_tp)
        n = sum(k for *_, k in _layer_cases(c, act))
        res[arch] = mm_cases(torch, timer, gen, _layer_cases(c, act), 1,
                             f"one {arch} decoder layer ({n} projections, "
                             f"B=8, widths (0.5, 1)"
                             + (f", rank 0 of tp = {shard_tp}"
                                if shard_tp else "") + ")")
    return res


def layer_config(torch, arch, widths, shard_tp=0):
    """``arch``'s published config and the width gates of ``widths``, or,
    with ``shard_tp``, rank 0's shard of it under ``serve_tp`` over
    ``shard_tp`` ranks (``sharding.plan_serve_shard``) and the gates
    localized to it (``tensor_parallel.localize``)."""
    from repro_torch.configs import get_config
    from repro_torch.core import elastic
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.tensor_parallel import localize

    cfg = get_config(arch)
    act = elastic.active_widths_batch(cfg, widths, device="cuda")
    if not shard_tp:
        return cfg, act
    sh = SH.plan_serve_shard(cfg, {"data": 1, "model": shard_tp},
                             n_slots=len(widths),
                             coord={"data": 0, "model": 0})
    return sh.cfg, localize(act, sh)


def check_fused_decode(torch, cfg, timer, act=None):
    import dataclasses

    from repro_torch.core import elastic
    from repro_torch.kernels import fused_decode as FD
    from repro_torch.models import layers as L

    B, S = 8, 1024
    dm, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = {
        "wq": torch.randn(dm, H * hd, generator=gen, device="cuda") / math.sqrt(dm),
        "wk": torch.randn(dm, KV * hd, generator=gen, device="cuda") / math.sqrt(dm),
        "wv": torch.randn(dm, KV * hd, generator=gen, device="cuda") / math.sqrt(dm),
        "wo": torch.randn(H * hd, dm, generator=gen, device="cuda") / math.sqrt(H * hd),
    }
    widths = [0.25, 0.5, 1.0, 0.25, 0.5, 1.0, 0.5, 0.25]
    if act is None:
        act = elastic.active_widths_batch(cfg, widths, device="cuda")
    pos = torch.tensor([0, 1, 63, 64, 200, 511, 777, 1023], dtype=torch.int32,
                       device="cuda")
    x = torch.randn(B, 1, dm, generator=gen, device="cuda").to(torch.bfloat16)
    out = {}
    for variant, qcfg in (("bf16", cfg),
                          ("int8", dataclasses.replace(cfg, kv_quant=True))):
        k = torch.randn(B, S, KV, hd, generator=gen, device="cuda")
        v = torch.randn(B, S, KV, hd, generator=gen, device="cuda")
        if qcfg.kv_quant:
            kq, ks = L.quantize_kv(k)
            vq, vs = L.quantize_kv(v)
            cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        else:
            cache = {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
        c_k = {n: t.clone() for n, t in cache.items()}
        c_p = {n: t.clone() for n, t in cache.items()}
        o_k, _ = FD.fused_decode_step(params, x, c_k, pos, qcfg, active=act)
        o_p, _ = FD.fused_decode_plain(params, x, c_p, pos, qcfg,
                                       act["q_dim"], act["kv_dim"])
        torch.cuda.synchronize()
        ok, err = close(torch, o_k, o_p)
        if not ok:
            fail(f"fused_decode {variant}: out max |err| {err:.3e}")
        for n in cache:
            if c_k[n].dtype == torch.int8:
                d = (c_k[n].int() - c_p[n].int()).abs()
                e = float(d.max())
                n_off = int((d != 0).sum())
                if e > 1:  # f32 sum order may move a value across a .5 edge
                    fail(f"fused_decode {variant} cache {n}: int8 off by {e}")
                log(f"  fused_decode {variant} cache {n}: max int8 diff {e:.0f}"
                    f" ({n_off} of {d.numel()} differ)")
            else:
                okc, ec = close(torch, c_k[n], c_p[n])
                if not okc:
                    fail(f"fused_decode {variant} cache {n}: max |err| {ec:.3e}")
                err = max(err, ec)
        log(f"  fused_decode {variant}: out/cache max|err| {err:.3e} "
            f"(rtol {RTOL_BF16:.2e} + atol {ATOL_BF16:.0e})")
        out[variant] = dict(err=err, cache=c_k, qcfg=qcfg)
    splits, rows = FD.attn_plan(B, H, KV, hd, S, torch.bfloat16, "cuda")
    log(f"  fused_decode attention plan: {B * KV} clusters of {splits} "
        f"blocks, {rows} cache rows each; routes {FD.route_counts()}")
    # time the main-path variant (bf16 cache, as tinyllama serves)
    c = out["bf16"]["cache"]
    t_k = timer.ms(lambda: FD.fused_decode_step(params, x, c, pos, cfg,
                                                active=act))
    per_kernel = dict(timer.last)
    for name, t in sorted(per_kernel.items(), key=lambda kv: -kv[1]):
        log(f"    {t:.4f} ms  {name[:100]}")
    t_kw = timer.wall_ms(lambda: FD.fused_decode_step(params, x, c, pos, cfg,
                                                      active=act))
    t_p = timer.ms(lambda: FD.fused_decode_plain(params, x, c, pos, cfg,
                                                 act["q_dim"], act["kv_dim"]))
    aq, akv = act["q_dim"].tolist(), act["kv_dim"].tolist()
    lens = [min(p + 1, S) for p in pos.tolist()]
    nbytes = (dm * (max(aq) + 2 * max(akv)) * 4 + max(aq) * dm * 4
              + sum(lens) * KV * hd * 2 * 2 + B * dm * 2 * 2
              + B * KV * hd * 2 * 2)
    ops = sum(2 * dm * (q + 2 * kv) + 2 * q * dm + 4 * n * H * hd
              for q, kv, n in zip(aq, akv, lens))
    bound = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_F32) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / PEAK_F32 else "operations"
    log(f"  fused_decode bf16 (B=8, S=1024, one layer): kernels {t_k:.4f} ms"
        f" (call, event-timed {t_kw:.4f} ms)  plain {t_p:.4f} ms  bound "
        f"{bound:.4f} ms ({by}; f32 math at {PEAK_F32 / 1e12:.0f} TFLOP/s)")
    warm = timer.warm_ms(lambda: FD.fused_decode_step(params, x, c, pos, cfg,
                                                      active=act))
    launches = fused_launch_times(torch, timer, per_kernel, warm, cfg, x, c,
                                  lens, aq, akv)
    return dict(max_abs_err=max(o["err"] for o in out.values()), ms=t_k,
                plain_ms=t_p, bound_ms=bound, bound_by=by, library_ms=None,
                per_launch=launches, splits=splits,
                rows_per_split=rows)


def launch_parts(times):
    """Device ms of a fused decode or verify layer by launch: the attention
    (the decode core), the output projection (the f32-x product) and the
    QKV product (bf16 x)."""
    parts = {"attention": 0.0, "qkv": 0.0, "wo": 0.0}
    for name, t in times.items():
        if "decode_attn_core" in name:
            parts["attention"] += t
        elif "gated_gemm<float, float" in name:
            parts["wo"] += t
        elif "gated_gemm" in name:
            parts["qkv"] += t
    return parts


def fused_launch_times(torch, timer, per_kernel, warm, cfg, x, cache, lens,
                       aq, akv):
    """The three launches of one fused decode layer (B = 8, bf16 cache),
    each with the bytes it must move at the data sheet's rate: the
    attention (live K/V rows read once, q, the new k and v, the output and
    the written cache row), the QKV product (the live f32 weight block, x,
    the f32 outputs) and the output projection (the live f32 weight block,
    the f32 attention output, the bf16 out); the read rate each reaches,
    and each one's time back to back with no flush (``warm``). Beside the
    attention launch, SDPA over the same live rows (bf16 q, a boolean
    live-row mask), a yardstick the port never calls."""
    F = torch.nn.functional
    B, dm = x.shape[0], cfg.d_model
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    S = cache["k"].shape[1]
    qd, kvd = H * hd, KV * hd

    parts, warm_parts = launch_parts(per_kernel), launch_parts(warm)
    nbytes = {
        "attention": (sum(lens) * KV * hd * 2 * 2 + B * (2 * qd + 2 * kvd) * 4
                      + B * KV * hd * 2 * 2),
        "qkv": dm * (max(aq) + 2 * max(akv)) * 4 + B * dm * 2
               + B * (qd + 2 * kvd) * 4,
        "wo": max(aq) * dm * 4 + B * qd * 4 + B * dm * 2,
    }
    qs = torch.randn(B, H, 1, hd, device="cuda").to(torch.bfloat16)
    ks = cache["k"].transpose(1, 2).contiguous()
    vs = cache["v"].transpose(1, 2).contiguous()
    live = (torch.arange(S, device="cuda")[None, :]
            < torch.tensor(lens, device="cuda")[:, None])[:, None, None, :]
    t_sdpa = timer.ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=live, enable_gqa=True))
    backend = sdpa_backend(timer.last)
    res = {}
    for part in ("attention", "qkv", "wo"):
        t, nb = parts[part], nbytes[part]
        bound = nb / HBM_BYTES_PER_S * 1e3
        res[part] = dict(ms=t, bound_ms=bound, bytes=nb,
                         warm_ms=warm_parts[part])
        extra = ""
        if part == "attention":
            res[part]["library_ms"] = t_sdpa
            extra = (f"; SDPA ({backend}) over the same live rows "
                     f"{t_sdpa:.4f} ms")
        log(f"  fused_decode launch {part}: {t:.4f} ms, bound {bound:.5f} ms "
            f"({nb / 1e6:.2f} MB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; the "
            f"kernel reads at {nb / t / 1e9 if t else 0.0:.2f} TB/s); "
            f"{warm_parts[part]:.4f} ms back to back with no flush{extra}")
    return res


def check_morph_matmul_verify(torch, cfg, timer, S=5):
    """``morph_matmul`` at the unfused verify pass's shapes: B = 8 slots of
    S = K+1 = 5 rows each, 40 rows per launch (five n8 row tiles of the
    tensor-core kernel), for each projection of one decoder layer; with
    S = 8, 64 rows (eight)."""
    from repro_torch.core import elastic

    widths = [0.25, 0.5, 1.0, 0.25, 0.5, 1.0, 0.5, 0.25]
    act = elastic.active_widths_batch(cfg, widths, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    return mm_cases(torch, timer, gen, _layer_cases(cfg, act), S,
                    f"at verify shape, one decoder layer (7 projections, "
                    f"{8 * S} rows)")


def tree_np(branching):
    """(node depths, additive ancestor mask) of a token tree with the given
    branching per level in BFS order (node 0 the root): 0 where column j is
    an ancestor-or-self of row i, -1e9 elsewhere. Built here in numpy, as
    the reference's ``TreeTopology`` builds it."""
    import numpy as np

    parents, depths, frontier = [-1], [0], [0]
    for lvl, b in enumerate(branching):
        nxt = []
        for node in frontier:
            for _ in range(b):
                nxt.append(len(parents))
                parents.append(node)
                depths.append(lvl + 1)
        frontier = nxt
    n = len(parents)
    bias = np.full((n, n), -1e9, np.float32)
    for i in range(n):
        j = i
        while j >= 0:
            bias[i, j] = 0.0
            j = parents[j]
    return np.asarray(depths, np.int32), bias


def check_fused_verify(torch, cfg, timer, act=None):
    """The verify kernels vs ``fused_verify_plain`` at full TinyLlama shapes:
    B = 8 slots, cache 512 with mixed committed counts, mixed widths; a bf16
    cache with the linear mask (S = 5) and an int8 cache with a (2, 2)
    token tree (S = 7). The main-path variant (bf16, linear) is timed."""
    import dataclasses

    from repro_torch.core import elastic
    from repro_torch.kernels import fused_decode as FD
    from repro_torch.models import layers as L

    B, Sc = 8, 512
    dm, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(6)
    params = {
        "wq": torch.randn(dm, H * hd, generator=gen, device="cuda") / math.sqrt(dm),
        "wk": torch.randn(dm, KV * hd, generator=gen, device="cuda") / math.sqrt(dm),
        "wv": torch.randn(dm, KV * hd, generator=gen, device="cuda") / math.sqrt(dm),
        "wo": torch.randn(H * hd, dm, generator=gen, device="cuda") / math.sqrt(H * hd),
    }
    widths = [0.25, 0.5, 1.0, 0.25, 0.5, 1.0, 0.5, 0.25]
    if act is None:
        act = elastic.active_widths_batch(cfg, widths, device="cuda")
    pos = torch.tensor([0, 1, 63, 64, 200, 333, 450, 505], dtype=torch.int32,
                       device="cuda")
    depths, bias = tree_np((2, 2))
    errs, check_parts = {}, {}
    main = None
    for variant, qcfg, nd, tb, S in (
            ("bf16 linear", cfg, None, None, 5),
            ("int8 tree(2,2)", dataclasses.replace(cfg, kv_quant=True),
             depths, bias, len(depths))):
        k = torch.randn(B, Sc, KV, hd, generator=gen, device="cuda")
        v = torch.randn(B, Sc, KV, hd, generator=gen, device="cuda")
        if qcfg.kv_quant:
            kq, ks = L.quantize_kv(k)
            vq, vs = L.quantize_kv(v)
            cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        else:
            cache = {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
        before = {n: t.clone() for n, t in cache.items()}
        x = torch.randn(B, S, dm, generator=gen, device="cuda").to(torch.bfloat16)
        r0 = FD.verify_route_counts()
        o_k, kv_k = FD.fused_verify(params, x, cache, pos, qcfg, active=act,
                                    node_depth=nd, tree_bias=tb)
        r1 = FD.verify_route_counts()
        if r1["tc"] != r0["tc"] + 1 or r1["fma"] != r0["fma"]:
            fail(f"fused_verify {variant}: routes {r0} -> {r1}; a bf16 or "
                 f"int8 cache must take the tensor-core route")
        o_p, kv_p = FD.fused_verify_plain(params, x, cache, pos, qcfg,
                                          act["q_dim"], act["kv_dim"], nd, tb)
        torch.cuda.synchronize()
        err = 0.0
        for name, got, want in (("out", o_k, o_p), ("k", kv_k["k"], kv_p["k"]),
                                ("v", kv_k["v"], kv_p["v"])):
            ok, e = close(torch, got, want)
            if not ok:
                fail(f"fused_verify {variant} {name}: max |err| {e:.3e} beyond "
                     f"rtol {RTOL_BF16:.2e} + atol {ATOL_BF16:.0e}")
            err = max(err, e)
        for n in cache:
            if not torch.equal(cache[n], before[n]):
                fail(f"fused_verify {variant} wrote the cache ({n})")
        errs[variant] = err
        t_v = timer.ms(lambda: FD.fused_verify(params, x, cache, pos, qcfg,
                                               active=act, node_depth=nd,
                                               tree_bias=tb))
        check_parts[variant] = launch_parts(timer.last)
        log(f"  fused_verify {variant} (B={B}, S={S}, cache {Sc}): out/k/v "
            f"max|err| {err:.3e} (rtol {RTOL_BF16:.2e} + atol "
            f"{ATOL_BF16:.0e}); cache untouched; route tc; kernels "
            f"{t_v:.4f} ms (" + ", ".join(
                f"{k} {v:.4f}" for k, v in check_parts[variant].items()) + ")")
        if main is None:
            main = (x, cache, S, t_v)
    x, cache, S, t_check = main
    splits, rows = FD.verify_attn_plan(B, H, KV, hd, S, Sc, torch.bfloat16,
                                       0, "cuda")
    log(f"  fused_verify attention plan: {B * KV} clusters of {splits} "
        f"blocks, {rows} cache rows each; one block carries the "
        f"{(H // KV) * S} query rows of a (slot, KV head)")

    def run():
        return FD.fused_verify(params, x, cache, pos, cfg, active=act)

    t_k = timer.ms(run)
    prof_parts = launch_parts(timer.last)
    for name, t in sorted(timer.last.items(), key=lambda kv: -kv[1]):
        log(f"    {t:.4f} ms  {name[:100]}")
    t_kw = timer.wall_ms(run)
    warm_parts = launch_parts(timer.warm_ms(run))
    log(f"  fused_verify bf16 linear per launch, check pass (timed right after "
        f"its own check) / profiler pass (timed again after the int8 tree) / "
        f"back to back with no flush: " + "; ".join(
            f"{k} {check_parts['bf16 linear'][k]:.4f} / {prof_parts[k]:.4f} / "
            f"{warm_parts[k]:.4f} ms" for k in prof_parts)
        + f"; layer {t_check:.4f} / {t_k:.4f} ms")
    attn = verify_attention_yardstick(torch, timer, cfg, x, cache, pos, S,
                                      prof_parts["attention"])
    t_p = timer.ms(lambda: FD.fused_verify_plain(params, x, cache, pos, cfg,
                                                 act["q_dim"], act["kv_dim"]))
    aq, akv = act["q_dim"].tolist(), act["kv_dim"].tolist()
    lens = [min(p, Sc) for p in pos.tolist()]
    nbytes = ((dm * (max(aq) + 2 * max(akv)) + max(aq) * dm) * 4
              + sum(lens) * KV * hd * 2 * 2 + 2 * B * S * dm * 2
              + 2 * B * S * KV * hd * 2)
    ops = sum(S * (2 * dm * (q + 2 * kv) + 2 * q * dm) + 4 * q * S * (n + S)
              for q, kv, n in zip(aq, akv, lens))
    bound = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_F32) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / PEAK_F32 else "operations"
    full_bytes = ((dm * (H + 2 * KV) * hd + H * hd * dm) * 4
                  + B * Sc * KV * hd * 2 * 2)
    log(f"  fused_verify bf16 linear (B={B}, S={S}, one layer): kernels "
        f"{t_k:.4f} ms (call, event-timed {t_kw:.4f} ms)  plain {t_p:.4f} ms"
        f"  bound {bound:.4f} ms ({by}; {nbytes / 1e6:.1f} MB, "
        f"{ops / 1e9:.3f} GFLOP f32 at {PEAK_F32 / 1e12:.0f} TFLOP/s); at full "
        f"width with every slot at 512 rows: {full_bytes / 1e6:.1f} MB -> "
        f"{full_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    per_launch = {k: dict(ms=prof_parts[k], check_pass_ms=check_parts[
        "bf16 linear"][k], warm_ms=warm_parts[k]) for k in prof_parts}
    per_launch["attention"].update(attn)
    return dict(max_abs_err=max(errs.values()), ms=t_k, plain_ms=t_p,
                bound_ms=bound, bound_by=by, library_ms=None,
                check_pass_ms=t_check, per_launch=per_launch, splits=splits,
                rows_per_split=rows)


# the replay chunk's length: restore force-commits up to this many
# committed tokens per slot in one verify launch (``c_max``)
REPLAY_C = 8


def check_replay_chunk(torch, cfg, timer):
    """``fused_verify`` at the shape a failover replay chunk gives it (new
    in PR 23): B = 8 slots of S = REPLAY_C = 8 rows with the linear mask
    (64 query rows per (slot, KV head) at TinyLlama's 32 / 4 heads of 64),
    mixed widths, a 512-row bf16 cache at mixed committed counts, dense and
    through a page table (page 16, shuffled, two slots sharing four pages).
    Each launch is held to its plain version under the bf16 tolerance and
    asserted on the tensor-core route; the paged launch must be
    bit-identical to its dense twin. The dense layer is timed beside the
    plain version and its bound, its attention launch beside SDPA."""
    from repro_torch.core import elastic
    from repro_torch.kernels import fused_decode as FD

    B, Sc, ps, S = 8, 512, 16, REPLAY_C
    dm, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(23)
    params = {
        "wq": torch.randn(dm, H * hd, generator=gen, device="cuda") / math.sqrt(dm),
        "wk": torch.randn(dm, KV * hd, generator=gen, device="cuda") / math.sqrt(dm),
        "wv": torch.randn(dm, KV * hd, generator=gen, device="cuda") / math.sqrt(dm),
        "wo": torch.randn(H * hd, dm, generator=gen, device="cuda") / math.sqrt(H * hd),
    }
    widths = [0.25, 0.5, 1.0, 0.25, 0.5, 1.0, 0.5, 0.25]
    act = elastic.active_widths_batch(cfg, widths, device="cuda")
    aq, akv = act["q_dim"].tolist(), act["kv_dim"].tolist()
    pos = torch.tensor([0, 1, 63, 64, 200, 333, 450, Sc - S],
                       dtype=torch.int32, device="cuda")
    dense, pool, table = paged_twin(torch, cfg, gen, B, Sc, ps)
    x = torch.randn(B, S, dm, generator=gen, device="cuda").to(torch.bfloat16)
    kw = dict(pages=table, page_size=ps, plan_len=Sc)
    err, outs = 0.0, {}
    for kind, cache, extra, plain_kw in (
            ("dense", dense, {}, {}),
            ("paged", pool, kw, dict(pages=table, page_size=ps))):
        n0, r0 = FD.paged_verify_launch_count(), FD.verify_route_counts()
        o_k, kv_k = FD.fused_verify(params, x, cache, pos, cfg, active=act,
                                    **extra)
        n1, r1 = FD.paged_verify_launch_count(), FD.verify_route_counts()
        o_p, kv_p = FD.fused_verify_plain(params, x, cache, pos, cfg,
                                          act["q_dim"], act["kv_dim"],
                                          **plain_kw)
        torch.cuda.synchronize()
        if (r1["tc"] != r0["tc"] + 1 or r1["fma"] != r0["fma"]
                or n1 != n0 + (kind == "paged")):
            fail(f"fused_verify replay chunk {kind}: routes {r0} -> {r1}, "
                 f"paged count {n0} -> {n1}; a bf16 cache must take the "
                 f"tensor-core route")
        for name, got, want in (("out", o_k, o_p), ("k", kv_k["k"], kv_p["k"]),
                                ("v", kv_k["v"], kv_p["v"])):
            ok, e = close(torch, got, want)
            if not ok:
                fail(f"fused_verify replay chunk {kind} {name}: max |err| "
                     f"{e:.3e} beyond rtol {RTOL_BF16:.2e} + atol "
                     f"{ATOL_BF16:.0e}")
            err = max(err, e)
        outs[kind] = o_k
    if not torch.equal(outs["dense"], outs["paged"]):
        fail("fused_verify replay chunk: the paged launch differs from its "
             "dense twin over the same contents")

    def run_d():
        return FD.fused_verify(params, x, dense, pos, cfg, active=act)

    def run_p():
        return FD.fused_verify(params, x, pool, pos, cfg, active=act, **kw)

    t_k = timer.ms(run_d)
    parts = launch_parts(timer.last)
    t_w = timer.wall_ms(run_d)
    t_pg = timer.ms(run_p)
    t_p = timer.ms(lambda: FD.fused_verify_plain(
        params, x, dense, pos, cfg, act["q_dim"], act["kv_dim"]))
    attn = verify_attention_yardstick(torch, timer, cfg, x, dense, pos, S,
                                      parts["attention"],
                                      what="fused_verify replay chunk")
    lens = [min(p, Sc) for p in pos.tolist()]
    nbytes = ((dm * (max(aq) + 2 * max(akv)) + max(aq) * dm) * 4
              + sum(lens) * KV * hd * 2 * 2 + 2 * B * S * dm * 2
              + 2 * B * S * KV * hd * 2)
    ops = sum(S * (2 * dm * (q + 2 * kv) + 2 * q * dm) + 4 * q * S * (n + S)
              for q, kv, n in zip(aq, akv, lens))
    bound, by = dense_bound(nbytes, ops, PEAK_F32)
    log(f"  fused_verify at the replay chunk's shape (B={B}, S={S} linear, "
        f"{(H // KV) * S} query rows per (slot, KV head), cache {Sc}): "
        f"out/k/v max|err| {err:.3e} dense and paged (rtol {RTOL_BF16:.2e} "
        f"+ atol {ATOL_BF16:.0e}); route tc; paged bit-identical to dense; "
        f"layer {t_k:.4f} ms (event-timed {t_w:.4f}; " + ", ".join(
            f"{k} {v:.4f}" for k, v in parts.items())
        + f"), paged {t_pg:.4f} ms, plain {t_p:.4f} ms, bound {bound:.4f} "
        f"ms ({by}; {nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP f32)")
    return dict(max_abs_err=err, ms=t_k, wall_ms=t_w, paged_ms=t_pg,
                plain_ms=t_p, bound_ms=bound, bound_by=by, library_ms=None,
                rows=S, per_launch=parts, attention=attn)


# the attention shapes the MoE families bring to B2 and B3
MOE_ATTN_ARCHS = ("granite-moe-1b-a400m", "jamba-v0.1-52b")
ATTN_WHATS = ("decode", "verify linear", "verify tree")


def check_fused_attention_shapes(torch, timer, archs=MOE_ATTN_ARCHS,
                                 whats=ATTN_WHATS, shard_tp=0):
    """B2 and B3 at the attention shapes of ``archs``, published widths
    (the MoE families: ``granite-moe-1b-a400m``, 16 query heads of 64 over
    8 KV heads: group 2, RoPE; ``jamba-v0.1-52b``, 32 of 128 over 8: group
    4, no RoPE), B = 8 slots at widths (0.5, 1) over a 512-row bf16 cache
    at mixed positions: of ``whats``, the decode, the linear verify (S = 5)
    and the TREE verify, each against its plain version, on the
    tensor-core route, and timed beside it (profiler, cold L2); the decode
    beside its byte bound (f32 weights, the live cache rows, x and out).
    With ``shard_tp``, at rank 0's shard of each (``layer_config``)."""
    from repro_torch.kernels import fused_decode as FD

    B, Sc = 8, 512
    depths, bias = tree_np(TREE)
    out = {}
    for arch in archs:
        cfg, act = layer_config(torch, arch, [0.5, 1.0] * 4, shard_tp)
        dm, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        gen = torch.Generator(device="cuda").manual_seed(12)
        params = {n: torch.randn(*s, generator=gen, device="cuda")
                  / math.sqrt(s[0])
                  for n, s in (("wq", (dm, H * hd)), ("wk", (dm, KV * hd)),
                               ("wv", (dm, KV * hd)), ("wo", (H * hd, dm)))}
        aq, akv = act["q_dim"], act["kv_dim"]
        pos = torch.tensor([0, 1, 63, 64, 200, 333, 450, 505],
                           dtype=torch.int32, device="cuda")
        cache = {n: torch.randn(B, Sc, KV, hd, generator=gen, device="cuda")
                 .to(torch.bfloat16) for n in ("k", "v")}
        res = {}
        for what, S, nd, tb in (("decode", 1, None, None),
                                ("verify linear", 5, None, None),
                                ("verify tree", len(depths), depths, bias)):
            if what not in whats:
                continue
            x = torch.randn(B, S, dm, generator=gen, device="cuda").to(
                torch.bfloat16)
            if what == "decode":
                c_k = {n: t.clone() for n, t in cache.items()}
                c_p = {n: t.clone() for n, t in cache.items()}

                def run():
                    return FD.fused_decode_step(params, x, c_k, pos, cfg,
                                                active=act)

                def plain():
                    return FD.fused_decode_plain(params, x, c_p, pos, cfg,
                                                 aq, akv)
                routes = FD.route_counts
            else:
                def run():
                    return FD.fused_verify(params, x, cache, pos, cfg,
                                           active=act, node_depth=nd,
                                           tree_bias=tb)

                def plain():
                    return FD.fused_verify_plain(params, x, cache, pos, cfg,
                                                 aq, akv, nd, tb)
                routes = FD.verify_route_counts
            r0 = routes()["tc"]
            o_k, kv_k = run()
            if routes()["tc"] != r0 + 1:
                fail(f"{arch} {what}: not on the tensor-core route")
            o_p, kv_p = plain()
            torch.cuda.synchronize()
            pairs = [("out", o_k, o_p)]
            if what == "decode":
                pairs += [(n, c_k[n], c_p[n]) for n in ("k", "v")]
            else:
                pairs += [(n, kv_k[n], kv_p[n]) for n in ("k", "v")]
            err = 0.0
            for name, got, want in pairs:
                ok, e = close(torch, got, want)
                if not ok:
                    fail(f"{arch} {what} {name}: max |err| {e:.3e} beyond "
                         f"rtol {RTOL_BF16:.2e} + atol {ATOL_BF16:.0e}")
                err = max(err, e)
            t_k, t_p = timer.ms(run), timer.ms(plain)
            res[what] = dict(max_abs_err=err, ms=t_k, plain_ms=t_p, rows=S)
            bound = ""
            if what == "decode":
                nbytes = (sum(t.numel() * t.element_size()
                              for t in params.values())
                          + int((pos + 1).sum()) * 2 * KV * hd * 2
                          + 2 * B * dm * 2)
                ms, by = dense_bound(nbytes, 0, PEAK_BF16)
                res[what].update(bound_ms=ms, bound_by=by)
                bound = f", bound {ms:.5f} ms ({by}; {nbytes / 1e6:.3f} MB)"
            log(f"  {arch} attention ({H}/{KV} heads of {hd}, "
                f"{'RoPE' if cfg.use_rope else 'no RoPE'}) {what} (B={B}, "
                f"S={S}, cache {Sc}): max|err| {err:.3e}, route tc; kernels "
                f"{t_k:.4f} ms, plain {t_p:.4f} ms{bound}")
        out[arch] = res
    return out


def paged_twin(torch, cfg, gen, B=8, S=512, ps=16):
    """A dense (B, S, KV, hd) cache at full TinyLlama shapes (bf16, or int8
    with bf16 scales when ``cfg.kv_quant``) and its paged twin: the same
    rows scattered into shuffled pages of a worst-case pool (B * (S / ps +
    1) pages: a scratch page per slot), slots 6 and 7 sharing their first
    four pages and the rows in them. Returns (dense, pool, table)."""
    from repro_torch.models import layers as L

    KV, hd = cfg.n_kv_heads, cfg.head_dim
    P = S // ps
    n_pages = B * (P + 1)
    k = torch.randn(B, S, KV, hd, generator=gen, device="cuda")
    v = torch.randn(B, S, KV, hd, generator=gen, device="cuda")
    if cfg.kv_quant:
        (kq, ks), (vq, vs) = L.quantize_kv(k), L.quantize_kv(v)
        dense = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        dense = {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
    table = torch.randperm(n_pages, generator=gen, device="cuda")[:B * P]
    table = table.view(B, P).to(torch.int32)
    for t in dense.values():
        t[7, :4 * ps] = t[6, :4 * ps]
    table[7, :4] = table[6, :4]
    pool = {}
    for n, t in dense.items():
        pool[n] = torch.zeros((n_pages, ps) + tuple(t.shape[2:]),
                              dtype=t.dtype, device="cuda")
        pool[n][table.long().flatten()] = t.reshape(
            (B * P, ps) + tuple(t.shape[2:]))
    return dense, pool, table


def check_paged(torch, cfg, timer):
    """The page-table half of ``fused_decode`` and ``fused_verify`` at the
    phase-2 shape: B = 8 slots at mixed widths and positions over a
    512-row capacity, page 16, shuffled pages, two slots sharing four, a
    bf16 and an int8 cache. Each paged launch is checked against its plain
    paged version, asserted on route ``tc`` and counted as paged, and held
    bit-identical to its dense twin over the same contents (the paged
    launch plans its splits from the slot's 512-row capacity); then both
    are timed, the layer and its attention launch, beside the bound (the
    dense twin's bytes plus the table's), and the attention launch once
    more through an identity table over the dense cache's own memory (each
    slot's pages in order), which splits the paged launch's extra time
    into the table's code path and the pages' scattered placement."""
    import dataclasses

    from repro_torch.core import elastic
    from repro_torch.kernels import fused_decode as FD

    B, S, ps, SV = 8, 512, 16, 5
    dm, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(17)
    params = {
        "wq": torch.randn(dm, H * hd, generator=gen, device="cuda") / math.sqrt(dm),
        "wk": torch.randn(dm, KV * hd, generator=gen, device="cuda") / math.sqrt(dm),
        "wv": torch.randn(dm, KV * hd, generator=gen, device="cuda") / math.sqrt(dm),
        "wo": torch.randn(H * hd, dm, generator=gen, device="cuda") / math.sqrt(H * hd),
    }
    widths = [0.25, 0.5, 1.0, 0.25, 0.5, 1.0, 0.5, 0.25]
    act = elastic.active_widths_batch(cfg, widths, device="cuda")
    aq, akv = act["q_dim"].tolist(), act["kv_dim"].tolist()
    pos = torch.tensor([0, 1, 63, 64, 200, 333, 450, 505], dtype=torch.int32,
                       device="cuda")
    out = {}
    for variant, qcfg in (("bf16", cfg),
                          ("int8", dataclasses.replace(cfg, kv_quant=True))):
        dense, pool, table = paged_twin(torch, qcfg, gen, B, S, ps)
        kw = dict(pages=table, page_size=ps, plan_len=S)
        ident = torch.arange(B * (S // ps), dtype=torch.int32,
                             device="cuda").view(B, S // ps)
        row_bytes = KV * hd * (1 + 2 / hd if qcfg.kv_quant else 2)
        tbl_bytes = table.numel() * 4
        res = {}
        for kind, xs in (("decode", 1), ("verify", SV)):
            x = torch.randn(B, xs, dm, generator=gen,
                            device="cuda").to(torch.bfloat16)
            if kind == "decode":
                c_k = {n: t.clone() for n, t in pool.items()}
                c_p = {n: t.clone() for n, t in pool.items()}
                c_d = {n: t.clone() for n, t in dense.items()}
                n0, r0 = FD.paged_launch_count(), FD.route_counts()
                o_k, _ = FD.fused_decode_step(params, x, c_k, pos, qcfg,
                                              active=act, **kw)
                n1, r1 = FD.paged_launch_count(), FD.route_counts()
                o_p, _ = FD.fused_decode_plain(params, x, c_p, pos, qcfg,
                                               act["q_dim"], act["kv_dim"],
                                               table, ps)
                o_d, _ = FD.fused_decode_step(params, x, c_d, pos, qcfg,
                                              active=act)
                outs = [("out", o_k, o_p)] + [
                    (n, c_k[n], c_p[n]) for n in pool
                    if c_k[n].dtype != torch.int8]
                lens = [min(p + 1, S) for p in pos.tolist()]

                def run_p(x=x, c=c_k):
                    return FD.fused_decode_step(params, x, c, pos, qcfg,
                                                active=act, **kw)

                def run_d(x=x, c=c_d):
                    return FD.fused_decode_step(params, x, c, pos, qcfg,
                                                active=act)

                def run_plain(x=x, c=c_p):
                    return FD.fused_decode_plain(params, x, c, pos, qcfg,
                                                 act["q_dim"], act["kv_dim"],
                                                 table, ps)

                def run_id(x=x, c=c_d):
                    c = {n: t.view((B * (S // ps), ps) + tuple(t.shape[2:]))
                         for n, t in c.items()}
                    return FD.fused_decode_step(params, x, c, pos, qcfg,
                                                active=act, pages=ident,
                                                page_size=ps, plan_len=S)
            else:
                n0, r0 = FD.paged_verify_launch_count(), FD.verify_route_counts()
                o_k, kv_k = FD.fused_verify(params, x, pool, pos, qcfg,
                                            active=act, **kw)
                n1, r1 = FD.paged_verify_launch_count(), FD.verify_route_counts()
                o_p, kv_p = FD.fused_verify_plain(
                    params, x, pool, pos, qcfg, act["q_dim"], act["kv_dim"],
                    pages=table, page_size=ps)
                o_d, _ = FD.fused_verify(params, x, dense, pos, qcfg,
                                         active=act)
                outs = [("out", o_k, o_p), ("k", kv_k["k"], kv_p["k"]),
                        ("v", kv_k["v"], kv_p["v"])]
                lens = [min(p, S) for p in pos.tolist()]

                def run_p(x=x):
                    return FD.fused_verify(params, x, pool, pos, qcfg,
                                           active=act, **kw)

                def run_d(x=x):
                    return FD.fused_verify(params, x, dense, pos, qcfg,
                                           active=act)

                def run_plain(x=x):
                    return FD.fused_verify_plain(
                        params, x, pool, pos, qcfg, act["q_dim"],
                        act["kv_dim"], pages=table, page_size=ps)

                def run_id(x=x):
                    c = {n: t.view((B * (S // ps), ps) + tuple(t.shape[2:]))
                         for n, t in dense.items()}
                    return FD.fused_verify(params, x, c, pos, qcfg,
                                           active=act, pages=ident,
                                           page_size=ps, plan_len=S)
            torch.cuda.synchronize()
            if n1 != n0 + 1 or r1["tc"] != r0["tc"] + 1 or r1["fma"] != r0["fma"]:
                fail(f"paged {kind} {variant}: paged count {n0} -> {n1}, "
                     f"routes {r0} -> {r1}; a paged bf16 or int8 launch must "
                     f"take the tensor-core route")
            err = 0.0
            for name, got, want in outs:
                ok, e = close(torch, got, want)
                if not ok:
                    fail(f"paged {kind} {variant} {name}: max |err| {e:.3e} "
                         f"beyond rtol {RTOL_BF16:.2e} + atol {ATOL_BF16:.0e}")
                err = max(err, e)
            if kind == "decode" and qcfg.kv_quant:
                for n in ("k", "v"):
                    e = float((c_k[n].int() - c_p[n].int()).abs().max())
                    if e > 1:  # f32 sum order may move a value past a .5 edge
                        fail(f"paged decode {variant} pool {n}: int8 off by "
                             f"{e}")
            if not torch.equal(o_k, o_d):
                fail(f"paged {kind} {variant}: output differs from its dense "
                     f"twin over the same contents (max |diff| "
                     f"{float((o_k.float() - o_d.float()).abs().max()):.3e})")
            t_p = timer.ms(run_p)
            parts_p = launch_parts(timer.last)
            t_d = timer.ms(run_d)
            parts_d = launch_parts(timer.last)
            t_plain = timer.ms(run_plain)
            timer.ms(run_id)
            id_attn = launch_parts(timer.last)["attention"]
            t_pw = timer.warm_ms(run_p)
            t_dw = timer.warm_ms(run_d)
            warm_p = launch_parts(t_pw)["attention"]
            warm_d = launch_parts(t_dw)["attention"]
            rows = xs
            w_bytes = (dm * (max(aq) + 2 * max(akv)) + max(aq) * dm) * 4
            io_bytes = 2 * B * rows * dm * 2 + 2 * B * rows * KV * hd * 2
            kv_bytes = sum(lens) * row_bytes * 2
            ops = sum(rows * (2 * dm * (q + 2 * k_) + 2 * q * dm)
                      + 4 * q * rows * (n + rows)
                      for q, k_, n in zip(aq, akv, lens))
            bound, by = dense_bound(w_bytes + io_bytes + kv_bytes + tbl_bytes,
                                    ops, PEAK_F32)
            a_bytes = (kv_bytes + tbl_bytes + B * rows * (2 * H + 2 * KV)
                       * hd * 4 + B * rows * KV * hd * 2 * 2)
            a_ops = sum(4 * H * rows * hd * (n + rows) for n in lens)
            a_bound, a_by = dense_bound(a_bytes, a_ops, PEAK_F32)
            res[kind] = dict(
                max_abs_err=err, ms=t_p, dense_ms=t_d, plain_ms=t_plain,
                bound_ms=bound, bound_by=by,
                attention=dict(ms=parts_p["attention"],
                               dense_ms=parts_d["attention"],
                               identity_table_ms=id_attn,
                               warm_ms=warm_p, dense_warm_ms=warm_d,
                               bound_ms=a_bound, bound_by=a_by))
            log(f"  paged {kind} {variant} (B={B}, {rows} row(s) per slot, "
                f"capacity {S}, page {ps}, {table.shape[1]} pages per slot, "
                f"shuffled, two slots sharing four): max|err| vs plain "
                f"{err:.3e}; bit-identical to its dense twin; route tc; "
                f"layer {t_p:.4f} ms (dense twin {t_d:.4f}; plain "
                f"{t_plain:.4f}); attention launch {parts_p['attention']:.4f}"
                f" ms (dense {parts_d['attention']:.4f}; through an identity "
                f"table over the dense memory {id_attn:.4f}; back to back "
                f"{warm_p:.4f} / {warm_d:.4f}); bound: layer {bound:.4f} ms "
                f"({by}), attention {a_bound:.5f} ms ({a_by}; table "
                f"{tbl_bytes} B)")
        out[variant] = res
    return out


TREES = ((2, 2, 1), (3, 2, 1))


def check_tree_verify(torch, cfg, timer):
    """The verify kernels with a token tree's depths and ancestor mask at
    full TinyLlama width: trees (2, 2, 1) and (3, 2, 1) (11 and 16 nodes:
    88 and 128 query rows per (slot, KV head), more than one block carries,
    so each unit's rows split over blocks), B = 8 slots at mixed widths and
    committed counts over a 512-row capacity, a bf16 and an int8 cache,
    dense and through a page table (page 16, shuffled pages, two slots
    sharing four). Each launch against its plain version on the tensor-core
    route; each paged launch bit-identical to its dense twin (``plan_len``
    512) and counted as paged; the cache left as it was. The dense and the
    paged layer, the plain version and the attention launch are timed, the
    attention beside its bound and beside SDPA over the same live rows and
    the tree's extension columns under the same boolean mask."""
    import dataclasses

    from repro_torch.core import elastic
    from repro_torch.kernels import fused_decode as FD

    B, Sc, ps = 8, 512, 16
    dm, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(23)
    params = {
        "wq": torch.randn(dm, H * hd, generator=gen, device="cuda") / math.sqrt(dm),
        "wk": torch.randn(dm, KV * hd, generator=gen, device="cuda") / math.sqrt(dm),
        "wv": torch.randn(dm, KV * hd, generator=gen, device="cuda") / math.sqrt(dm),
        "wo": torch.randn(H * hd, dm, generator=gen, device="cuda") / math.sqrt(H * hd),
    }
    widths = [0.25, 0.5, 1.0, 0.25, 0.5, 1.0, 0.5, 0.25]
    act = elastic.active_widths_batch(cfg, widths, device="cuda")
    aq, akv = act["q_dim"].tolist(), act["kv_dim"].tolist()
    pos = torch.tensor([0, 1, 63, 64, 200, 333, 450, 496], dtype=torch.int32,
                       device="cuda")
    lens = [min(p, Sc) for p in pos.tolist()]
    out = {}
    for br in TREES:
        nd, tb = tree_np(br)
        S = len(nd)
        ok = tb == 0.0
        for cache_kind, qcfg in (("bf16", cfg), ("int8", dataclasses.replace(
                cfg, kv_quant=True))):
            variant = f"tree{'x'.join(map(str, br))} {cache_kind}"
            dense, pool, table = paged_twin(torch, qcfg, gen, B, Sc, ps)
            x = torch.randn(B, S, dm, generator=gen,
                            device="cuda").to(torch.bfloat16)
            before = {n: t.clone() for n, t in pool.items()}
            kw = dict(active=act, node_depth=nd, tree_bias=tb)
            pkw = dict(kw, pages=table, page_size=ps, plan_len=Sc)
            r0, n0 = FD.verify_route_counts(), FD.paged_verify_launch_count()
            o_d, kv_d = FD.fused_verify(params, x, dense, pos, qcfg, **kw)
            o_p, kv_p = FD.fused_verify(params, x, pool, pos, qcfg, **pkw)
            r1, n1 = FD.verify_route_counts(), FD.paged_verify_launch_count()
            if r1["tc"] != r0["tc"] + 2 or r1["fma"] != r0["fma"] or \
                    n1 != n0 + 1:
                fail(f"fused_verify {variant}: routes {r0} -> {r1}, paged "
                     f"{n0} -> {n1}; both launches must take the "
                     f"tensor-core route, one of them paged")
            o_r, kv_r = FD.fused_verify_plain(params, x, dense, pos, qcfg,
                                              act["q_dim"], act["kv_dim"],
                                              nd, tb)
            o_rp, _ = FD.fused_verify_plain(params, x, pool, pos, qcfg,
                                            act["q_dim"], act["kv_dim"], nd,
                                            tb, pages=table, page_size=ps)
            torch.cuda.synchronize()
            err, edge_note = 0.0, ""
            for name, got, want in (("out", o_d, o_r), ("k", kv_d["k"],
                                                        kv_r["k"]),
                                    ("v", kv_d["v"], kv_r["v"]),
                                    ("paged out", o_p, o_rp)):
                if qcfg.kv_quant and "out" in name:
                    good, e, n_out = close_int8_edges(torch, got, want)
                    edge_note += (f"; {name}: {n_out} of {got.numel()} "
                                  f"beyond the bf16 tolerance")
                else:
                    good, e = close(torch, got, want)
                if not good:
                    fail(f"fused_verify {variant} {name}: max |err| {e:.3e} "
                         f"beyond rtol {RTOL_BF16:.2e} + atol "
                         f"{ATOL_BF16:.0e}" + (
                             f" (int8 rule: at most {INT8_EDGE_FRAC:g} of "
                             f"the outputs beyond it, none beyond "
                             f"{INT8_EDGE_ATOL:g}{edge_note})"
                             if qcfg.kv_quant else ""))
                err = max(err, e)
            if qcfg.kv_quant:
                jittered = {k: v * (1 + 2.0 ** -20) for k, v in params.items()}
                o_j, _ = FD.fused_verify_plain(jittered, x, dense, pos, qcfg,
                                               act["q_dim"], act["kv_dim"],
                                               nd, tb)
                n_j, e_j = beyond_bf16(torch, o_j, o_r)
                edge_note += (f"; the plain version with its weights scaled "
                              f"by 1 + 2^-20 against itself: {n_j} beyond it, "
                              f"max |err| {e_j:.3e}")
            if not (torch.equal(o_p, o_d) and torch.equal(kv_p["k"], kv_d["k"])
                    and torch.equal(kv_p["v"], kv_d["v"])):
                fail(f"fused_verify {variant}: the paged launch differs from "
                     f"its dense twin over the same contents")
            for n in pool:
                if not torch.equal(pool[n], before[n]):
                    fail(f"fused_verify {variant} wrote the pool ({n})")

            def run_d(x=x, c=dense, q=qcfg):
                return FD.fused_verify(params, x, c, pos, q, **kw)

            def run_p(x=x, c=pool, q=qcfg):
                return FD.fused_verify(params, x, c, pos, q, **pkw)

            t_d = timer.ms(run_d)
            parts = launch_parts(timer.last)
            t_p = timer.ms(run_p)
            parts_p = launch_parts(timer.last)
            t_plain = timer.ms(lambda x=x, c=dense, q=qcfg: FD.fused_verify_plain(
                params, x, c, pos, q, act["q_dim"], act["kv_dim"], nd, tb))
            attn = verify_attention_yardstick(
                torch, timer, cfg, x, dense, pos, S, parts["attention"],
                ext_ok=ok, what=f"fused_verify {variant}")
            row_bytes = KV * hd * (1 + 2 / hd if qcfg.kv_quant else 2)
            nbytes = ((dm * (max(aq) + 2 * max(akv)) + max(aq) * dm) * 4
                      + sum(lens) * row_bytes * 2 + 2 * B * S * dm * 2
                      + 2 * B * S * KV * hd * 2)
            ops = sum(S * (2 * dm * (q + 2 * kv) + 2 * q * dm)
                      + 4 * q * (S * n + int(ok.sum()))
                      for q, kv, n in zip(aq, akv, lens))
            bound, by = dense_bound(nbytes, ops, PEAK_F32)
            splits, rows = FD.verify_attn_plan(B, H, KV, hd, S, Sc,
                                               dense["k"].dtype, 0, "cuda")
            out[variant] = dict(
                nodes=S, max_abs_err=err, ms=t_d, paged_ms=t_p,
                plain_ms=t_plain, bound_ms=bound, bound_by=by,
                library_ms=attn["library_ms"],
                per_launch=parts, paged_per_launch=parts_p,
                attention=dict(ms=parts["attention"],
                               paged_ms=parts_p["attention"],
                               bound_ms=attn["bound_ms"],
                               bound_by=attn["bound_by"],
                               sdpa_ms=attn["library_ms"]),
                attention_plan=dict(splits=splits, rows_per_split=rows,
                                    query_rows=(H // KV) * S))
            log(f"  fused_verify {variant} (B={B}, {S} nodes: "
                f"{(H // KV) * S} query rows per (slot, KV head), cache "
                f"{Sc}; {B * KV} units x {splits} splits of {rows} rows): "
                f"max|err| vs plain {err:.3e}{edge_note}; paged bit-identical "
                f"to dense; route tc; layer {t_d:.4f} ms (" + ", ".join(
                    f"{k} {v:.4f}" for k, v in parts.items())
                + f"), paged {t_p:.4f} ms (attention "
                f"{parts_p['attention']:.4f}), plain {t_plain:.4f} ms, bound "
                f"{bound:.4f} ms ({by}; {nbytes / 1e6:.1f} MB, "
                f"{ops / 1e9:.3f} GFLOP f32)")
    return out


def verify_attention_yardstick(torch, timer, cfg, x, cache, pos, S, t_attn,
                               ext_ok=None, what="fused_verify"):
    """The verify attention launch beside its bound and beside SDPA over
    the same live cache rows and S extension columns (bf16 q, K/V the cache
    and the new rows concatenated beforehand, a boolean mask: cache rows
    below each slot's committed count, extension columns causal, or a
    tree's ancestor mask ``ext_ok`` (S, S)), a yardstick the port never
    calls. Bound: the live K/V rows read once, the f32 q, new k and v read,
    the f32 output and the bf16 candidates written, against the f32 work of
    the scores and products each row needs, 4 H hd (rows + its extension
    columns), at 67 TFLOP/s. The cache may be int8: SDPA then reads it
    dequantized to bf16 (its bytes counted as the kernel reads them)."""
    F = torch.nn.functional
    B, Sc = x.shape[0], cache["k"].shape[1]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lens = [min(p, Sc) for p in pos.tolist()]
    gen = torch.Generator(device="cuda").manual_seed(16)
    q = torch.randn(B, H, S, hd, generator=gen, device="cuda").to(torch.bfloat16)
    kn = torch.randn(B, KV, S, hd, generator=gen, device="cuda").to(torch.bfloat16)

    def bf16(name):
        t = cache[name]
        if t.dtype == torch.int8:
            t = t.float() * cache[name + "_scale"].float()
        return t.to(torch.bfloat16).transpose(1, 2)

    k = torch.cat([bf16("k"), kn], dim=2).contiguous()
    v = torch.cat([bf16("v"), kn], dim=2).contiguous()
    live = (torch.arange(Sc, device="cuda")[None, :]
            < torch.tensor(lens, device="cuda")[:, None])   # (B, Sc)
    if ext_ok is None:
        ext = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
    else:
        ext = torch.as_tensor(ext_ok, device="cuda").bool()
    mask = torch.cat([live[:, None, :].expand(B, S, Sc),
                      ext[None].expand(B, S, S)], dim=2)[:, None]
    t_sdpa = timer.ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True))
    backend = sdpa_backend(timer.last)
    row_bytes = KV * hd * (1 + 2 / hd if cache["k"].dtype == torch.int8
                           else 2)
    nbytes = (sum(lens) * row_bytes * 2 + B * S * (2 * H + 2 * KV) * hd * 4
              + 2 * B * S * KV * hd * 2)
    pairs = int(ext.sum())  # extension columns the rows need
    ops = sum(4 * H * hd * (S * n + pairs) for n in lens)
    bound, by = dense_bound(nbytes, ops, PEAK_F32)
    log(f"  {what} attention launch: {t_attn:.4f} ms, bound {bound:.5f} "
        f"ms ({by}; {nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} MFLOP); SDPA "
        f"({backend}) over the same live rows and extension columns "
        f"{t_sdpa:.4f} ms")
    return dict(bound_ms=bound, bound_by=by, bytes=nbytes, library_ms=t_sdpa)


def check_morph_matmul_ssm(torch, cfg, timer):
    """``morph_matmul`` at the four gated projections of one Mamba2 layer
    (``w_x``, ``w_z``: d_model x d_inner gated at ``d_inner``; ``w_dt``:
    d_model x 32 heads gated at ``ssm_heads``; ``out_proj``: d_inner x
    d_model, contraction gated at ``d_inner``), B = 8 slots at mixed widths
    {0.5, 1.0}: once at decode shape (1 row per slot) and once at the
    speculative verify shape (K + 1 = 5 rows per slot, 40 rows). Returns
    (decode, verify) sums per layer."""
    from repro_torch.core import elastic

    dm, di, nh = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_nheads
    widths = [0.5, 1.0, 1.0, 0.5, 0.5, 1.0, 0.5, 1.0]
    act = elastic.active_widths_batch(cfg, widths, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(8)
    cases = [("w_x/w_z", dm, di, act["d_inner"], None, 2),
             ("w_dt", dm, nh, act["ssm_heads"], None, 1),
             ("out_proj", di, dm, None, act["d_inner"], 1)]
    return tuple(
        mm_cases(torch, timer, gen, cases, S,
                 f"one Mamba2 layer (4 gated projections, B=8, S={S}, "
                 f"widths {{0.5, 1.0}})") for S in (1, 5))


def scan_bound(b, s, h, p, g, n):
    """(ms, bound_by, bytes, ops, tile) of one scan at the card's peaks,
    f32 x: ``ssd_scan.cost``, the least f32 work of the function over every
    tile length (the same function at any tile up to rounding, so the
    cheapest counts) and each input read once, y and the final state
    written once."""
    from repro_torch.kernels import ssd_scan as SSD

    ops, nbytes = SSD.cost(b, s, h, p, g, n)
    tile = SSD.least_ops(SSD.scan_ops, s, h, p, n)[1]
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / PEAK_F32
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations",
            nbytes, ops, tile)


def scan_inputs(torch, gen, b, s, h, p, g, n):
    """Scan inputs as the model's prompt pass makes them: x and B, C
    silu-activated, dt in the init's [1e-3, 1e-1] range, A in -[1, 16)."""
    silu = torch.nn.functional.silu
    x = silu(torch.randn(b, s, h, p, generator=gen, device="cuda"))
    u = torch.rand(b, s, h, generator=gen, device="cuda")
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    A = -(1.0 + 15.0 * torch.rand(h, generator=gen, device="cuda"))
    B = silu(torch.randn(b, s, g, n, generator=gen, device="cuda"))
    C = silu(torch.randn(b, s, g, n, generator=gen, device="cuda"))
    return x, dt, A, B, C


def check_ssd_scan(torch, cfg, timer):
    """The scan kernel against its plain versions on the card: at the
    full-width prompt pass (b = 1, 32 heads of 64, one group, n = 128,
    chunk 256) through ``ssd_scan`` at S = 256 and through
    ``ops.ssd_scan_bshn`` at S = 200 (a ragged tile), and at the
    reference's ``kernel_bench`` shape (b = 2, S = 256, 4 heads of 32,
    n = 16, chunk 64). f32 throughout."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as SSD

    h, p, g, n, q = (cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_ngroups,
                     cfg.ssm_state, cfg.ssm_chunk)
    gen = torch.Generator(device="cuda").manual_seed(9)
    res = {}
    for tag, (b, s, hh, pp, gg, nn, qq), flat in (
            ("prompt S=256", (1, 256, h, p, g, n, q), True),
            ("prompt S=200", (1, 200, h, p, g, n, q), False),
            ("kernel_bench", (2, 256, 4, 32, 1, 16, 64), False)):
        x, dt, A, B, C = scan_inputs(torch, gen, b, s, hh, pp, gg, nn)
        if flat:  # the kernel's own layout: one head per row
            args = (x.transpose(1, 2).reshape(b * hh, s, pp).contiguous(),
                    dt.transpose(1, 2).reshape(b * hh, s).contiguous(),
                    A.expand(b, hh).reshape(-1).contiguous(),
                    *(t.repeat_interleave(hh // gg, dim=2).transpose(1, 2)
                      .reshape(b * hh, s, nn).contiguous() for t in (B, C)))

            def kern():
                return SSD.ssd_scan(*args, chunk=qq)

            def plain():
                return SSD.ssd_scan_plain(*args, chunk=qq)
        else:
            def kern():
                return ops.ssd_scan_bshn(x, dt, A, B, C, chunk=qq)

            def plain():
                return SSD.ssd_chunked(x, dt, A, B, C, qq)
        (yk, sk), (yp, sp) = kern(), plain()
        torch.cuda.synchronize()
        err = 0.0
        for what, got, want in (("y", yk, yp), ("state", sk, sp)):
            ok, e = close(torch, got, want, rtol=RTOL_SCAN, atol=ATOL_SCAN)
            if not ok or not bool(torch.isfinite(got).all()):
                fail(f"ssd_scan {tag} {what}: max |err| {e:.3e} beyond rtol "
                     f"{RTOL_SCAN:.0e} + atol {ATOL_SCAN:.0e}")
            err = max(err, e)
        t_k = timer.ms(kern)
        parts = {"chunk": 0.0, "pass": 0.0, "out": 0.0}
        for name, t in timer.last.items():
            parts["chunk" if "ssd_chunk_kernel" in name else "pass"
                  if "ssd_pass_kernel" in name else "out"] += t
        t_kw = timer.wall_ms(kern)
        t_warm = sum(timer.warm_ms(kern).values())
        t_p = timer.ms(plain)
        bound, by, nbytes, nops, tile = scan_bound(b, s, hh, pp, gg, nn)
        log(f"  ssd_scan {tag} (b={b}, h={hh}, p={pp}, g={gg}, n={nn}, chunk "
            f"{qq}{', flat layout' if flat else ', model layout'}): max|err| "
            f"{err:.3e} (y scale {float(yp.abs().max()):.2f}; rtol "
            f"{RTOL_SCAN:.0e} + atol {ATOL_SCAN:.0e})  kernel {t_k:.4f} ms "
            f"(call, event-timed {t_kw:.4f} ms)  plain {t_p:.4f} ms  bound "
            f"{bound:.4f} ms ({by}; {nbytes / 1e6:.2f} MB, {nops / 1e9:.3f} "
            f"GFLOP f32 at {PEAK_F32 / 1e12:.0f} TFLOP/s, carried every "
            f"{tile} steps); launches: tile states and C.B^T "
            f"{parts['chunk']:.4f} ms + carry {parts['pass']:.4f} ms + "
            f"outputs {parts['out']:.4f} ms; {t_warm:.4f} ms back to back "
            f"with no flush")
        res[tag] = dict(max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bound,
                        bound_by=by, per_launch=parts, warm_ms=t_warm)
    return res


def dense_bound(nbytes, ops, peak):
    """(ms, bound_by) of work of ``nbytes`` and ``ops`` at the card's peaks."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def sdpa_backend(names):
    """Which SDPA backend ran, read from its kernels' names."""
    joined = " ".join(names).lower()
    for key, name in (("flash", "flash"), ("cutlassf", "efficient"),
                      ("fmha", "efficient"), ("cudnn", "cudnn")):
        if key in joined:
            return name
    return "math (unfused kernels)"


def check_flash_attention(torch, cfg, timer):
    """The flash attention kernel against its plain version on the card: at
    the full-width TinyLlama prompt pass (1 x 256 tokens, 32 / 4 heads of
    64, causal, bf16) and at a ragged S = 200, through
    ``ops.flash_attention_bshd`` in the model layout as the prompt pass
    calls it; at the reference's ``kernel_bench`` shape (q (2, 256, 4,
    64), k / v (2, 256, 2, 64), f32) with window 0 and 64; and unmasked
    (neither causal nor windowed) at whisper-base's prompt-pass shapes, 8
    heads of 64 (group 1), bf16: its encoder's self-attention (1 x 1500
    frames; 1500 = 23 x 64 + 28, a ragged last tile) and its decoder's
    cross-attention (16 queries against 1500 keys); and at internvl2-2b's
    chunked prompt pass (8 x 320 positions, 16 / 8 heads of 128, causal,
    bf16). Library yardstick:
    ``scaled_dot_product_attention`` with ``enable_gqa`` (``is_causal``
    without a window, a boolean mask with one, neither when unmasked)."""
    from repro_torch.configs import get_config

    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    wc = get_config(ENCDEC_ARCH)
    wh, wkv, whd, wse = wc.n_heads, wc.n_kv_heads, wc.head_dim, wc.enc_seq
    vc = get_config(VLM_ARCH)
    # internvl's chunked prompt pass in the model drive: 256 patches + 64
    # text tokens for each of 8 requests
    vs = vc.frontend_seq + VLM_TEXT
    bf, f32 = torch.bfloat16, torch.float32
    return flash_attention_cases(torch, timer, (
            ("prompt S=256", (1, 256, 256, H, KV, hd, True, 0, bf)),
            ("prompt S=200", (1, 200, 200, H, KV, hd, True, 0, bf)),
            ("kernel_bench win0", (2, 256, 256, 4, 2, 64, True, 0, f32)),
            ("kernel_bench win64", (2, 256, 256, 4, 2, 64, True, 64, f32)),
            ("whisper encoder 1500x1500",
             (1, wse, wse, wh, wkv, whd, False, 0, bf)),
            ("whisper cross prompt 16x1500",
             (1, 16, wse, wh, wkv, whd, False, 0, bf)),
            (f"internvl prompt 8x{vs}",
             (8, vs, vs, vc.n_heads, vc.n_kv_heads, vc.head_dim, True, 0,
              bf))))


def check_flash_attention_shards(torch, timer, tp=None):
    """``flash_attention`` at the prompt-pass shapes of rank 0 of tp =
    ``tp`` (``layer_config``): whisper's encoder (1 x 1500 x 1500)
    unmasked over 4 of its 8 heads, internvl's
    chunked prompt pass (8 x 320, causal) over 8 / 4 heads of 128; bf16,
    as ``check_flash_attention`` holds the full shapes."""
    tp = tp or MESH_TP
    wc, _ = layer_config(torch, ENCDEC_ARCH, [1.0], tp)
    vc, _ = layer_config(torch, VLM_ARCH, [1.0], tp)
    wse, vs, bf = wc.enc_seq, vc.frontend_seq + VLM_TEXT, torch.bfloat16
    w = (wc.n_heads, wc.n_kv_heads, wc.head_dim)
    return flash_attention_cases(torch, timer, (
        (f"whisper encoder 1500x1500 tp{tp}",
         (1, wse, wse, *w, False, 0, bf)),
        (f"internvl prompt 8x{vs} tp{tp}",
         (8, vs, vs, vc.n_heads, vc.n_kv_heads, vc.head_dim, True, 0, bf))))


def flash_attention_cases(torch, timer, cases):
    """Each ``(tag, (b, sq, sk, h, kv, d, causal, window, dtype))`` of
    ``cases`` through ``ops.flash_attention_bshd`` against the plain
    version, timed beside it, SDPA and the bound."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops

    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(13)
    res = {}
    for tag, (b, sq, sk, h, kv, d, causal, window, dt) in cases:
        q = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dt)
        k = torch.randn(b, sk, kv, d, generator=gen, device="cuda").to(dt)
        v = torch.randn(b, sk, kv, d, generator=gen, device="cuda").to(dt)
        flat = [t.transpose(1, 2).reshape(-1, t.shape[1], d).contiguous()
                for t in (q, k, v)]

        def kern():
            return ops.flash_attention_bshd(q, k, v, causal=causal,
                                            window=window)

        def plain():
            return FA.flash_attention_plain(*flat, group=h // kv,
                                            causal=causal, window=window)

        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window:
            r = torch.arange(sq, device="cuda")
            allow = (r[None, :] <= r[:, None]) & (r[None, :] > r[:, None] - window)

            def lib():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=allow,
                                                      enable_gqa=True)
        else:
            def lib():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=causal,
                                                      enable_gqa=True)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        got_f = got.transpose(1, 2).reshape(-1, sq, d)
        rtol, atol = ((RTOL_BF16, ATOL_BF16) if dt == torch.bfloat16
                      else (RTOL_F32, ATOL_F32))
        ok, err = close(torch, got_f, want, rtol=rtol, atol=atol)
        if not ok or not bool(torch.isfinite(got.float()).all()):
            fail(f"flash_attention {tag}: max |err| {err:.3e} beyond rtol "
                 f"{rtol:.2e} + atol {atol:.0e}")
        _, lib_err = close(torch, lib().reshape(-1, sq, d), want)
        t_k = timer.ms(kern)
        t_kw = timer.wall_ms(kern)
        t_p = timer.ms(plain)
        t_l = timer.ms(lib)
        backend = sdpa_backend(timer.last)
        size = torch.finfo(dt).bits // 8
        nbytes = size * (2 * b * sq * h * d + 2 * b * sk * kv * d)
        ops_n = 4 * d * FA.attn_pairs(sq, sk, causal, window) * b * h
        peak = PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32
        bound, by = dense_bound(nbytes, ops_n, peak)
        route = "tc (tensor cores)" if dt == torch.bfloat16 else "fma (f32)"
        log(f"  flash_attention {tag} (b={b}, Sq={sq}, Sk={sk}, h={h}/{kv}, "
            f"hd={d}, {'causal' if causal else 'unmasked'}, window {window}, "
            f"{str(dt)[6:]}, route {route}): max|err| {err:.3e} "
            f"(rtol {rtol:.2e} + atol {atol:.0e}; SDPA vs plain "
            f"{lib_err:.3e})  kernel {t_k:.4f} ms (call, event-timed "
            f"{t_kw:.4f} ms)  plain {t_p:.4f} ms  SDPA ({backend}) "
            f"{t_l:.4f} ms  bound {bound:.5f} ms ({by}; {nbytes / 1e6:.3f} "
            f"MB, {ops_n / 1e6:.1f} MFLOP at {peak / 1e12:.0f} TFLOP/s); "
            f"kernel at {bound / t_k:.3f} of the bound, {t_k / t_l:.2f}x "
            f"SDPA")
        res[tag] = dict(max_abs_err=err, ms=t_k, wall_ms=t_kw, plain_ms=t_p,
                        bound_ms=bound, bound_by=by, library_ms=t_l,
                        library=f"sdpa {backend}")
    return res


def decode_cache(torch, gen, bkv, S, hd, quant):
    """A (BKV, S, hd) cache for ``flash_decode``: bf16, or int8 with bf16
    per-row scales from ``layers.quantize_kv``."""
    from repro_torch.models import layers as L

    k = torch.randn(bkv, S, hd, generator=gen, device="cuda")
    v = torch.randn(bkv, S, hd, generator=gen, device="cuda")
    if quant:
        (kq, ks), (vq, vs) = L.quantize_kv(k), L.quantize_kv(v)
        return kq, vq, ks, vs
    return k.to(torch.bfloat16), v.to(torch.bfloat16), None, None


def check_flash_decode(torch, cfg, timer):
    """The flash decode kernel against its plain version on the card at the
    TinyLlama serving cache's shape (8 slots x 32 query heads of 64 over
    8 x 4 KV rows of 512 positions, group 8, bf16 queries), with a bf16
    cache and an int8 cache with bf16 scales, at kv_len 1, 300 and 512
    (a device scalar); and at ``tests/test_flash_decode.py``'s largest
    case (2 KV rows of 128, hd 32, group 4, f32, kv_len 128). Library
    yardstick: SDPA over the bf16 cache with the kv_len mask."""
    from repro_torch.kernels import flash_decode as FDK

    F = torch.nn.functional
    slots, S = 8, 512
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(14)
    res = {}
    cases = [(f"serving {c} kv_len={n}", slots * KV, H // KV, S, hd, n,
              c == "int8", torch.bfloat16)
             for c in ("bf16", "int8") for n in (1, 300, 512)]
    cases.append(("test largest f32 kv_len=128", 2, 4, 128, 32, 128, False,
                  torch.float32))
    caches = {}
    for tag, bkv, g, s, d, n, quant, qdt in cases:
        key = (bkv, s, d, quant, qdt)
        if key not in caches:
            kc, vc, ks, vs = decode_cache(torch, gen, bkv, s, d, quant)
            if qdt == torch.float32:
                kc, vc = kc.float(), vc.float()
            caches[key] = (kc, vc, ks, vs)
        kc, vc, ks, vs = caches[key]
        q = torch.randn(bkv * g, d, generator=gen, device="cuda").to(qdt)
        n_dev = torch.tensor([n], dtype=torch.int32, device="cuda")

        def kern():
            return FDK.flash_decode(q, kc, vc, n_dev, ks, vs, group=g)

        def plain():
            return FDK.flash_decode_plain(q, kc, vc, n, ks, vs, group=g)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        rtol, atol = ((RTOL_BF16, ATOL_BF16) if qdt == torch.bfloat16
                      else (RTOL_F32, ATOL_F32))
        ok, err = close(torch, got, want, rtol=rtol, atol=atol)
        if not ok or not bool(torch.isfinite(got.float()).all()):
            fail(f"flash_decode {tag}: max |err| {err:.3e} beyond rtol "
                 f"{rtol:.2e} + atol {atol:.0e}")
        t_k = timer.ms(kern)
        t_kw = timer.wall_ms(kern)
        t_p = timer.ms(plain)
        t_l = None
        if not quant:
            qs = q.view(bkv, g, 1, d)
            ksd, vsd = kc[:, None], vc[:, None]
            live = torch.arange(s, device="cuda")[None, :] < n_dev

            def lib():
                return F.scaled_dot_product_attention(qs, ksd, vsd,
                                                      attn_mask=live,
                                                      enable_gqa=True)
            t_l = timer.ms(lib)
        live_n = min(n, s)
        nbytes = (live_n * bkv * d * 2 * kc.element_size()
                  + 2 * bkv * g * d * q.element_size()
                  + (2 * live_n * bkv * ks.element_size() if quant else 0))
        ops_n = 4 * d * live_n * bkv * g
        bound, by = dense_bound(nbytes, ops_n, PEAK_BF16 if qdt ==
                                torch.bfloat16 else PEAK_F32)
        lib_s = "none (int8)" if t_l is None else f"{t_l:.4f} ms"
        splits, rows = FDK.plan(bkv, g, s, qdt, kc.dtype, d, "cuda")
        log(f"  flash_decode {tag} (BKV={bkv}, group {g}, S={s}, hd={d}; "
            f"{splits} splits of {rows} rows): "
            f"max|err| {err:.3e} (rtol {rtol:.2e} + atol {atol:.0e})  "
            f"kernel {t_k:.4f} ms (call, event-timed {t_kw:.4f} ms)  plain "
            f"{t_p:.4f} ms  SDPA {lib_s}  bound {bound:.5f} ms ({by}; "
            f"{nbytes / 1e6:.3f} MB)")
        res[tag] = dict(max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bound,
                        bound_by=by, library_ms=t_l)
        if n == 1:
            # the timer's floor for this launch shape: an empty kernel at
            # the same grid, clusters and shared memory, and the kernel's
            # chain of dependent steps without its work
            t_f = timer.ms(lambda: FDK.probe_launch(q, kc, vc, n_dev, ks, vs,
                                                    group=g))
            t_s = timer.ms(lambda: FDK.probe_launch(q, kc, vc, n_dev, ks, vs,
                                                    group=g, kind="skeleton"))
            t_w = sum(timer.warm_ms(kern).values())
            log(f"  flash_decode {tag}: an empty kernel at the same grid, "
                f"clusters and shared memory takes {t_f:.4f} ms under this "
                f"timer, the skeleton (kv_len read, one dependent cache-row "
                f"load, two cluster barriers) {t_s:.4f} ms; the kernel at "
                f"kv_len 1 is {t_k / t_f:.2f}x the empty kernel, "
                f"{t_k / t_s:.2f}x the skeleton, and {t_w:.4f} ms back to "
                f"back with no flush")
            res[tag]["floor_ms"] = t_f
            res[tag]["skeleton_ms"] = t_s
            res[tag]["warm_ms"] = t_w
    log(f"  flash_decode routes over these checks: {FDK.route_counts()}")
    return res


# ---------------------------------------------------------------------------
# phase 3: end to end
# ---------------------------------------------------------------------------


def mode_schedule(modes):
    """Every mode once, in an order that changes width and depth between
    neighbours: full model first, then a stride coprime to the mode count."""
    n = len(modes)
    stride = next(s for s in range(2, n + 2) if math.gcd(s, n) == 1)
    return [modes[(n - 1 + i * stride) % n] for i in range(n)]


def drive(engine, trace, switch_every: int):
    """Submit the whole trace, then tick, moving the admission mode along
    ``mode_schedule`` every ``switch_every`` ticks."""
    reqs = copy.deepcopy(trace)
    for r in reqs:
        engine.submit(r)
    sched = mode_schedule(engine.ctrl.modes)
    t0 = time.perf_counter()
    i = 0
    while engine.queue or engine.n_active:
        if engine.step_count % switch_every == 0:
            engine.set_admission_mode(sched[i % len(sched)])
            i += 1
        engine.step()
    return time.perf_counter() - t0, {r.rid: list(r.generated) for r in reqs}


# steps a step's device time is profiled over (few, so that the granite
# drives fit the run's time)
PROFILED_STEPS = 3


def step_width_ms(torch, engine, width: float, iters: int = 10):
    """Decode step at full depth with every slot at ``width``: (host ms per
    step over ``iters`` steps, device kernel ms per step over
    PROFILED_STEPS profiled steps, or None on the CPU). Logs the step's
    heaviest kernels and its kernel count. Runs under ``no_grad``, as the
    engine's ticks do (the parameters may require grad)."""
    with torch.no_grad():
        return _step_width_ms(torch, engine, width, iters)


def _step_width_ms(torch, engine, width, iters):
    ctrl = engine.ctrl
    step = ctrl.step_for(ctrl.modes[-1])
    active = engine._active_for([width] * engine.batch_size)
    cache = engine.executor.init_cache()
    tok = torch.ones((engine.batch_size, 1), dtype=torch.int64,
                     device=engine.device)
    step(engine.params, cache, tok, active)
    sync(torch, engine.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        step(engine.params, cache, tok, active)
    sync(torch, engine.device)
    host = (time.perf_counter() - t0) / iters * 1e3
    if torch.device(engine.device).type != "cuda":
        return host, None
    per = kernel_us(torch, lambda: step(engine.params, cache, tok, active),
                    PROFILED_STEPS)
    total = sum(per.values()) / PROFILED_STEPS / 1e3
    top = sorted(per.items(), key=lambda kv: -kv[1])[:5]
    log(f"    w{width} step: {len(per)} distinct kernels; heaviest: " + "; ".join(
        f"{v / PROFILED_STEPS / 1e3:.3f} ms {k[:60]}" for k, v in top))
    return host, total


def step_bytes(engine) -> int:
    """Bytes a full-depth decode step at full width must move: every
    decoder parameter read once (the embedding only where it is the tied
    unembedding; an untied one is a row gather; an encoder and a frontend
    projection are not read), every SSM layer's recurrent state read and
    written, and an encoder-decoder layer's cross-attention K/V read.
    Self-attention K/V reads are left out: the step is timed on a fresh
    cache."""
    cfg = engine.cfg
    return params_cache_bytes(cfg, engine.params,
                              engine.groups[cfg.n_groups].cache)


def params_cache_bytes(cfg, params, cache) -> int:
    """``step_bytes`` of a decode step of ``cfg`` on ``params`` and a
    decode cache."""
    dec = {k: v for k, v in params.items()
           if k not in ("encoder", "frontend_proj")}
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(dec))
    if not cfg.tie_embeddings:
        emb = params["embed"]
        nbytes -= emb.numel() * emb.element_size()
    return nbytes + sum((2 if k in ("conv_x", "conv_bc", "state") else 1)
                        * t.numel() * t.element_size()
                        for layer in cache["stack"].values()
                        for k, t in layer.items()
                        if k in ("conv_x", "conv_bc", "state", "cross_k",
                                 "cross_v"))


def spec_tick_ms(torch, engine, shape=None, iters: int = 5):
    """One speculative tick at full depth (a K-token draft, or a token tree
    drafted level by level, at the exit depth; then verify + accept +
    commit), every slot at width 1.0, greedy, under ``no_grad`` as the
    engine ticks: (host ms per tick over ``iters`` ticks, device kernel ms
    per tick and kernels launched per tick over 1 profiled tick, or None
    on the CPU). ``shape`` is K or a tree's branching (default: the linear
    K)."""
    from repro_torch.runtime.speculative import (draft_compile_key,
                                                 tree_draft_compile_key,
                                                 tree_verify_compile_key,
                                                 verify_compile_key)

    shape = SPEC_K if shape is None else shape
    tree = isinstance(shape, tuple)
    ctrl, cfg = engine.ctrl, engine.cfg
    d = cfg.n_groups
    plan = engine._spec_plan[d]
    if tree:
        draft = ctrl.aux_step(tree_draft_compile_key(plan.draft_depth, shape))
        verify = ctrl.aux_step(tree_verify_compile_key(d, shape))
    else:
        draft = ctrl.aux_step(draft_compile_key(plan.draft_depth, shape))
        verify = ctrl.aux_step(verify_compile_key(d, shape))
    active = engine._active_for([1.0] * engine.batch_size)
    cache = engine.executor.init_cache()
    keys = engine.groups[d].keys
    tok = torch.ones((engine.batch_size, 1), dtype=torch.int64,
                     device=engine.device)

    @torch.no_grad()
    def tick():
        dt, dl = draft(engine.params, cache, tok, active, keys, 0.0, 0)
        verify(engine.params, cache, dt if tree else torch.cat([tok, dt], 1),
               dl, active, keys, 0.0, 0)

    tick()
    sync(torch, engine.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        tick()
    sync(torch, engine.device)
    host = (time.perf_counter() - t0) / iters * 1e3
    if torch.device(engine.device).type != "cuda":
        return host, None, None
    rows = device_rows(torch, tick, 1)
    top = sorted(rows, key=lambda r: -r[1])[:4]
    log("    tick's heaviest kernels: " + "; ".join(
        f"{us / 1e3:.3f} ms {k[:60]}" for k, us, _ in top))
    return (host, sum(us for _, us, _ in rows) / 1e3,
            sum(n for _, _, n in rows))


def sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def layer_steps(engine, steps0, cfg):
    """Decoder-layer steps of one drive, from the engine's own counters:
    plain decode steps (controller telemetry, one entry per step at the
    mode it was attributed to) and, per speculative path (depth, draft
    depth, draft shape), its verify launches L: L * depth verify
    layer-steps, and L * K * draft depth linear-draft layer-steps or, for a
    tree, L * levels * draft depth tree-draft layer-passes (one level's
    frontier each). Returns (plain, draft, verify, tree draft)."""
    plain = sum((engine.ctrl.telemetry[m.name].steps - steps0[m.name])
                * m.depth * cfg.period for m in engine.ctrl.modes)
    verify = draft = tree_draft = 0
    for (d, dd, shape), t in engine.spec_telemetry.items():
        verify += t.launches * d * cfg.period
        if isinstance(shape, tuple):
            tree_draft += t.launches * len(shape) * dd * cfg.period
        else:
            draft += t.launches * shape * dd * cfg.period
    return plain, draft, verify, tree_draft


def prefill_layers(engine, kind: str) -> int:
    """Layers of ``kind`` ("attn" or "ssm") that the drive's prefills ran:
    each prefill runs to the depth of the mode its request was admitted
    at."""
    cfg = engine.cfg
    modes = engine.ctrl.mode_by_name
    pre = [r for r in engine.completed if r.prefilled]
    if len(pre) != engine.prefills:
        fail(f"{len(pre)} prefilled requests, engine counted "
             f"{engine.prefills} prefills")
    per_group = sum(cfg.layer_kind(p) == kind for p in range(cfg.period))
    return sum(modes[r.mode_name].depth for r in pre) * per_group


def expected_launches(torch, engine, steps0, fused: bool, device):
    """Launch counts one TinyLlama drive must show. Unfused, every decoder
    layer of every decode, draft and verify step runs its 7 gated
    projections through ``morph_matmul``. Fused, attention is one
    ``fused_decode`` (decode and linear-draft steps) or one ``fused_verify``
    (verify steps, linear and tree), whose output projections are not
    ``morph_matmul`` counts, and the MLP is 3 ``morph_matmul``; a tree
    draft's level passes take the einsum attention in either engine, 7
    ``morph_matmul`` per layer and level. Under ``attn_impl="chunked"``
    every attention layer of every prefill is one ``flash_attention``
    (prompts here are at most 256 tokens, so "auto" takes the einsum
    attention and launches none). No scan runs. On the CPU the wrappers
    count nothing."""
    plain, draft, verify, tree_draft = steps = layer_steps(engine, steps0,
                                                           engine.cfg)
    flash = (prefill_layers(engine, "attn")
             if engine.cfg.attn_impl == "chunked" else 0)
    steps = steps + (flash,)
    zero = dict.fromkeys(KERNEL_NAMES, 0)
    if torch.device(device).type != "cuda":
        return zero, steps
    if fused:
        return dict(zero, morph_matmul=3 * (plain + draft + verify)
                    + 7 * tree_draft, fused_decode=plain + draft,
                    fused_verify=verify, flash_attention=flash), steps
    return dict(zero, morph_matmul=7 * (plain + draft + verify + tree_draft),
                flash_attention=flash), steps


def expected_launches_ssm(torch, engine, steps0, fused: bool, device):
    """Launch counts one Mamba2 drive must show: 4 ``morph_matmul`` per SSM
    layer of every decode, draft and verify step (x, z and dt projections
    gated at each slot's width, the output projection's contraction; the
    B/C projection is never gated; a tree draft's level passes and the tree
    verify the same), and one ``ssd_scan`` per SSM layer of every prefill,
    which runs to the depth of the mode its request was admitted at.
    ``fused`` reaches attention layers only."""
    steps = layer_steps(engine, steps0, engine.cfg)
    scans = prefill_layers(engine, "ssm")
    zero = dict.fromkeys(KERNEL_NAMES, 0)
    if torch.device(device).type != "cuda":
        return zero, steps + (scans,)
    return (dict(zero, morph_matmul=4 * sum(steps), ssd_scan=scans),
            steps + (scans,))


def expected_launches_moe(torch, engine, steps0, fused: bool, device):
    """Launch counts one granite drive must show. Every layer is attention
    + MoE, and only the attention reaches a hand kernel: the experts are
    ``torch.matmul`` over the expert axis, as the reference's are einsum
    outside any Pallas kernel. Unfused, 4 ``morph_matmul`` (Q, K, V, O) per
    layer of every decode, draft and verify step and of every tree-draft
    level pass. Fused, 1 ``fused_decode`` per decode or linear-draft
    layer-step and 1 ``fused_verify`` per verify layer-step (linear or
    tree), whose projections are not ``morph_matmul`` counts; a tree
    draft's level passes take the einsum attention, 4 ``morph_matmul`` per
    layer and level. Prompts of at most 256 tokens take the einsum
    attention, so no ``flash_attention``; no scan."""
    plain, draft, verify, tree_draft = steps = layer_steps(engine, steps0,
                                                           engine.cfg)
    zero = dict.fromkeys(KERNEL_NAMES, 0)
    if torch.device(device).type != "cuda":
        return zero, steps
    if fused:
        return dict(zero, morph_matmul=4 * tree_draft,
                    fused_decode=plain + draft, fused_verify=verify), steps
    return dict(zero, morph_matmul=4 * (plain + draft + verify
                                        + tree_draft)), steps


def moe_cast_bytes(engine) -> int:
    """Bytes the dropless MoE's cast of the expert matrices to the
    activation dtype moves in one full-depth step: every expert master
    read once and written once in the activation dtype (0 where they
    match). The router stays f32."""
    from repro_torch.device import dtype_of

    act = dtype_of(engine.cfg.dtype)
    return sum(t.numel() * (t.element_size() + act.itemsize)
               for layer in engine.params["stack"].values()
               for k, t in layer.get("moe", {}).items()
               if k != "router" and t.dtype != act)


def bound_note(engine) -> str:
    """A full-depth step's byte bound at w1.0 (``step_bytes``) and, for an
    MoE model, the bytes its experts' per-step cast moves."""
    cfg = engine.cfg
    nbytes, cast = step_bytes(engine), moe_cast_bytes(engine)
    note = (f"a full-depth step's bound at w1.0 "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms (bytes: "
            f"{nbytes / 1e9:.3f} GB)")
    if cast:
        note += (f"; the experts' cast to {cfg.dtype} moves "
                 f"{cast / 1e9:.3f} GB a step "
                 f"({cast / HBM_BYTES_PER_S * 1e3:.3f} ms at the data-sheet "
                 f"rate)")
    return note


KERNEL_NAMES = ("morph_matmul", "fused_decode", "fused_verify", "ssd_scan",
                "ssd_scan_bwd", "flash_attention", "flash_decode")
SPEC_K = 4
TREE = (2, 2, 1)
# path name -> (fused, speculation: False, True (linear K = SPEC_K) or a
# tree's branching, temperature, top_k, attn_impl or None for the
# config's own)
PATHS = (("unfused", False, False, 0.0, 0, None),
         ("fused", True, False, 0.0, 0, None),
         ("fused_chunked", True, False, 0.0, 0, "chunked"),
         ("spec_unfused", False, True, 0.0, 0, None),
         ("spec_fused", True, True, 0.0, 0, None),
         ("spec_fused_t0.8_k50", True, True, 0.8, 50, None),
         ("tree_unfused", False, TREE, 0.0, 0, None),
         ("tree_fused", True, TREE, 0.0, 0, None),
         ("tree_fused_t0.8_k50", True, TREE, 0.8, 50, None))
AGREE = (("unfused", "fused", "f32 fused projections vs bf16 unfused weights"),
         ("fused_chunked", "fused", "flash kernel's f32 P.V vs einsum "
          "attention's bf16-rounded p on the prompt pass"),
         ("spec_unfused", "unfused", "bf16 verify pass vs bf16 decode steps"),
         ("spec_fused", "fused", "bf16 verify kernel vs bf16 decode kernel"),
         ("tree_unfused", "unfused", "bf16 tree verify pass vs bf16 decode "
          "steps"),
         ("tree_fused", "fused", "bf16 tree verify kernel vs bf16 decode "
          "kernel"))
SSM_PATHS = (("mamba2_plain", False, False, 0.0, 0, None),
             ("mamba2_spec", False, True, 0.0, 0, None),
             ("mamba2_tree", False, TREE, 0.0, 0, None))
SSM_AGREE = (("mamba2_spec", "mamba2_plain",
              "verify pass vs decode steps, bf16 activations"),
             ("mamba2_tree", "mamba2_plain",
              "tree verify pass vs decode steps, bf16 activations"))
MOE_PATHS = (("granite_unfused", False, False, 0.0, 0, None),
             ("granite_fused", True, False, 0.0, 0, None),
             ("granite_spec_fused", True, True, 0.0, 0, None),
             ("granite_tree_fused", True, TREE, 0.0, 0, None))
MOE_AGREE = (("granite_unfused", "granite_fused",
              "f32 fused projections vs bf16 unfused weights"),
             ("granite_spec_fused", "granite_fused",
              "bf16 verify kernel vs bf16 decode kernel"),
             ("granite_tree_fused", "granite_fused",
              "bf16 tree verify kernel vs bf16 decode kernel"))


def spec_config(spec):
    """The ``SpecConfig`` of a path's speculation: None, linear K = SPEC_K,
    or a tree (with K = SPEC_K built beside it, so that one engine times a
    tree tick beside a linear one; the tree takes precedence in the drive,
    which runs no policy). ``min_accept_rate`` 0: with random weights
    acceptance may be low, and the collapse fallback must not switch the
    path off."""
    from repro_torch.runtime.speculative import SpecConfig

    if spec is False:
        return None
    if spec is True:
        return SpecConfig(ks=(SPEC_K,), min_accept_rate=0.0)
    return SpecConfig(ks=(SPEC_K,), trees=(spec,), min_accept_rate=0.0)


def counters():
    """kernel name -> (launch count, reset) of every kernel's wrapper."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FDK
    from repro_torch.kernels import fused_decode as FD
    from repro_torch.kernels import morph_matmul as MM
    from repro_torch.kernels import ssd_scan as SSD

    return {"morph_matmul": (MM.launch_count, MM.reset_launch_count),
            "fused_decode": (FD.launch_count, FD.reset_launch_count),
            "fused_verify": (FD.verify_launch_count,
                             FD.reset_verify_launch_count),
            "ssd_scan": (SSD.launch_count, SSD.reset_launch_count),
            "ssd_scan_bwd": (SSD.bwd_launch_count, SSD.reset_launch_count),
            "flash_attention": (FA.launch_count, FA.reset_launch_count),
            "flash_decode": (FDK.launch_count, FDK.reset_launch_count)}


def init_on_card(torch, cfg, device="cuda"):
    """Seeded random parameters of ``cfg`` on ``device``."""
    from repro_torch.models.model import init_params

    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=device)
    sync(torch, device)
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"  init_params: {n_params / 1e9:.3f} B f32 parameters on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    return params


def end_to_end(torch, cfg, params, timer=None, device="cuda", n_requests=24,
               prompt_len=(16, 256), new_tokens=(32, 64), capacity=512,
               paths=PATHS, expect=expected_launches, agreements=AGREE):
    """Serve ``cfg`` through each of ``paths`` on one trace; ``expect``
    gives the exact launch counts each drive must show. With a ``timer``
    each drive is followed by its step or tick measurements. Returns
    (launches per path, results per path)."""
    from repro_torch.runtime.serving import ServingEngine, poisson_trace
    from repro_torch.runtime.speculative import draft_compile_key

    trace = poisson_trace(n_requests, 50.0, seed=0, prompt_len=prompt_len,
                          new_tokens=new_tokens, vocab=cfg.vocab_size)
    results = {}
    launches = {}  # path -> kernel -> launches in that path's drive
    count_reset = counters()
    for tag, fused, spec, temp, top_k, impl in paths:
        pcfg = cfg if impl is None else cfg.scaled(attn_impl=impl)
        tree = spec if isinstance(spec, tuple) else None
        engine = ServingEngine(
            params, pcfg, batch_size=8, cache_capacity=capacity,
            prefill_threshold=8, fused=fused, temperature=temp, top_k=top_k,
            speculative=spec_config(spec), device=device)
        t_warm = time.perf_counter()
        engine.warmup()
        t_warm = time.perf_counter() - t_warm
        steps0 = {n: t.steps for n, t in engine.ctrl.telemetry.items()}
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        # each path's counts cover exactly its own drive: zeroed just
        # before it, read just after
        for _, reset in count_reset.values():
            reset()
        wall, streams = drive(engine, trace, switch_every=12)
        t_meas = time.perf_counter()
        run_launches = {n: count() for n, (count, _) in count_reset.items()}
        peak = (torch.cuda.max_memory_allocated() / 2**30
                if torch.device(device).type == "cuda" else float("nan"))
        launches[tag] = run_launches
        check_routes(f"{tag} path", run_launches)
        want, steps = expect(torch, engine, steps0, fused, device)
        if run_launches != want:
            fail(f"{tag} path: launches {run_launches}, expected {want} for "
                 f"(plain, draft, verify) layer steps (, prefill layers) "
                 f"{steps}")
        if spec and not engine.spec_verify_launches:
            fail(f"{tag} path: no speculative tick ran")
        if engine.spec_tree_launches != (engine.spec_verify_launches
                                         if tree else 0):
            fail(f"{tag} path: {engine.spec_tree_launches} tree ticks of "
                 f"{engine.spec_verify_launches} speculative ticks")
        gen = sum(len(s) for s in streams.values())
        if len(engine.completed) != len(trace):
            fail(f"{tag}: {len(engine.completed)} of {len(trace)} done")
        admitted = sorted({r.mode_name for r in engine.completed})
        # more requests than slots: the queued ones wait for a slot and are
        # admitted at a later mode of the schedule (slot reuse, concurrent
        # depth groups, mixed widths)
        if len(trace) > engine.batch_size and len(admitted) < 2:
            fail(f"{tag}: {len(trace)} requests on {engine.batch_size} "
                 f"slots all admitted at {admitted}")
        for r in trace:
            s = streams[r.rid]
            if len(s) != r.max_new_tokens or not all(0 <= t < cfg.vocab_size
                                                     for t in s):
                fail(f"{tag}: request {r.rid} stream is malformed")
        if engine.ctrl.stats["compiles"] != engine.compiles_after_warmup:
            fail(f"{tag}: a width/depth switch rebuilt a step")
        log(f"  e2e {tag}: {gen} tokens, {len(engine.completed)} requests in "
            f"{wall:.2f} s wall -> {gen / wall:.1f} tokens/s; "
            f"{engine.decode_launches} decode steps, "
            f"{engine.spec_verify_launches} speculative ticks "
            f"({engine.spec_tree_launches} tree), "
            f"{engine.prefills} prefills, admission switches "
            f"{len(engine.admission_switch_log)}, admitted at "
            f"{', '.join(admitted)}; peak device memory {peak:.2f} GiB")
        for name, t in sorted(engine.ctrl.telemetry_summary().items()):
            log(f"    mode {name:8s} steps {t['steps']:4d}  p50 "
                f"{t['p50_ms']:8.3f} ms  p95 {t['p95_ms']:8.3f} ms")
        log(f"    launches in this drive: " + ", ".join(
            f"{n} {c}" for n, c in run_launches.items())
            + f" ((plain, draft, verify, tree draft) layer steps (, prefill "
            f"layers) {steps}; as expected)")
        res = dict(streams=streams, tokens_per_s=gen / wall, peak_gib=peak)
        if spec:
            tels = engine.spec_telemetry
            drafted = sum(t.drafted for t in tels.values())
            acc = sum(t.accepted for t in tels.values())
            emitted = sum(t.emitted for t in tels.values())
            slot_l = sum(t.slot_launches for t in tels.values())
            h = engine._h_spec
            res.update(accept_rate=acc / drafted,
                       tokens_per_slot_launch=emitted / slot_l,
                       tick_p50_ms=h.p50, tick_p95_ms=h.p95)
            for path, t in engine.spec_telemetry_summary().items():
                log(f"    spec {path}: launches {t['launches']}, accept "
                    f"{t['accept_rate']:.4f}, tokens/launch/slot "
                    f"{t['tokens_per_slot_launch']:.3f}")
            scratch = ""
            if timer is not None and not tree:
                g = engine.groups[cfg.n_groups]
                dd = engine._spec_plan[cfg.n_groups].draft_depth
                draft = engine.ctrl.aux_step(draft_compile_key(dd, SPEC_K))
                t_copy = timer.ms(lambda: draft.load_scratch(g.cache))
                nbytes = sum(t.numel() * t.element_size()
                             for layer in draft.scratch["stack"].values()
                             for t in layer.values())
                res["scratch_ms"] = t_copy
                scratch = (f"; draft scratch copy (depth {dd}, "
                           f"{nbytes / 1e6:.1f} MB) {t_copy:.4f} ms device")
            log(f"    speculative: accept rate {res['accept_rate']:.4f}, "
                f"tokens per verify launch per slot "
                f"{res['tokens_per_slot_launch']:.3f}, tick p50 "
                f"{h.p50:.3f} ms p95 {h.p95:.3f} ms{scratch}")
            if temp == 0.0 and timer is not None:
                for shape in ((tree, SPEC_K) if tree else (SPEC_K,)):
                    h_t, d_t, n_k = spec_tick_ms(torch, engine, shape)
                    dev_note = ("" if d_t is None else
                                f"; device kernel time {d_t:.3f} ms (idle "
                                f"share {1 - d_t / h_t:.3f}), {n_k:.0f} "
                                f"kernels launched per tick")
                    what = (f"tree {'x'.join(map(str, shape))} drafted level "
                            f"by level + verify" if shape is tree else
                            f"K = {SPEC_K} drafts + verify")
                    log(f"    speculative tick at depth {cfg.n_groups} "
                        f"({what}), all slots w1.0: host {h_t:.3f} ms"
                        f"{dev_note}")
                    key = "tree_tick" if shape is tree else "tick"
                    res.update({f"{key}_host_ms": h_t,
                                f"{key}_device_ms": d_t,
                                f"{key}_kernels": n_k})
        if not spec and timer is not None:
            narrow = min(cfg.elastic.width_fractions)
            (h_n, d_n), (h_f, d_f) = (step_width_ms(torch, engine, narrow),
                                      step_width_ms(torch, engine, 1.0))
            dev_note = ("" if d_n is None else
                        f"; device kernel time {d_n:.3f} ms vs {d_f:.3f} ms "
                        f"(ratio {d_n / d_f:.3f}, idle share at w1.0 "
                        f"{1 - d_f / h_f:.3f})")
            log(f"    decode step at full depth, all slots w{narrow}: host "
                f"{h_n:.3f} ms, all w1.0: {h_f:.3f} ms{dev_note}; "
                + bound_note(engine))
            res.update(step_host_ms=h_f, step_device_ms=d_f)
        elif timer is not None:
            log("    " + bound_note(engine))
        log(f"    seconds: warmup {t_warm:.1f}, trace {wall:.1f}, checks and "
            f"measurements {time.perf_counter() - t_meas:.1f}")
        results[tag] = res
        del engine

    def agree(x, y, what):
        a, b = results[x]["streams"], results[y]["streams"]
        same = sum(u == w for r in a for u, w in zip(a[r], b[r]))
        total = sum(len(a[r]) for r in a)
        whole = sum(a[r] == b[r] for r in a)
        log(f"  {x} vs {y}: {same}/{total} tokens agree position-wise, "
            f"{whole}/{len(a)} streams identical ({what}; reported, not "
            f"asserted)")

    for x, y, what in agreements:
        agree(x, y, what)
    return launches, results


# path name -> (speculation as in PATHS, paged); every one fused, greedy,
# on one trace whose prompts share a 128-token prefix, admitted in the full
# mode; each dense path is followed by its paged twin
PAGED_PATHS = (("prefix_fused", False, False),
               ("prefix_fused_paged", False, True),
               ("prefix_spec_fused", True, False),
               ("prefix_spec_fused_paged", True, True),
               ("prefix_tree_fused", TREE, False),
               ("prefix_tree_fused_paged", TREE, True))
PAGE = 16


def prefix_trace(cfg, n_requests=12, prefix_len=128, seed=7):
    """Requests whose prompts start with one shared ``prefix_len``-token
    prefix (eight pages of 16) followed by 8-64 tokens of their own, 32-48
    new tokens each."""
    import numpy as np

    from repro_torch.runtime.serving import Request

    rng = np.random.default_rng(seed)
    prefix = tuple(int(t) for t in rng.integers(1, cfg.vocab_size,
                                                prefix_len))
    reqs = []
    for i in range(n_requests):
        own = tuple(int(t) for t in rng.integers(
            1, cfg.vocab_size, int(rng.integers(8, 65))))
        reqs.append(Request(rid=i, prompt=prefix + own,
                            max_new_tokens=int(rng.integers(32, 49))))
    return reqs


def paged_end_to_end(torch, cfg, params, device="cuda"):
    """Serve full-width TinyLlama through ``PAGED_PATHS``: fused plain
    decode, fused greedy speculation (K = 4) and fused greedy tree
    speculation (TREE), each over a dense cache and over a paged one (page
    16, the worst-case pool of 8 slots x (512 / 16 + 1) = 264 pages), on
    ``prefix_trace``, every request admitted in the full
    mode (the radix keys on depth and width). Asserts per pair identical
    tokens, and per paged drive radix hits > 0, the page accounting after
    every tick, every fused launch paged, and nothing built after warmup;
    launch counts exactly as ``expected_launches``. Returns (launches per
    path, paged launches per path, results per path)."""
    from repro_torch.kernels import fused_decode as FD
    from repro_torch.models.paged import PagedLayout
    from repro_torch.runtime.serving import ServingEngine

    trace = prefix_trace(cfg)
    count_reset = counters()
    launches, paged_launches, results = {}, {}, {}
    for tag, spec, paged in PAGED_PATHS:
        layout = PagedLayout(page_size=PAGE) if paged else None
        engine = ServingEngine(
            params, cfg, batch_size=8, cache_capacity=512,
            prefill_threshold=8, fused=True, paged=layout,
            speculative=spec_config(spec), device=device)
        engine.warmup()
        engine.set_admission_mode(engine.ctrl.modes[-1])
        steps0 = {n: t.steps for n, t in engine.ctrl.telemetry.items()}
        reqs = copy.deepcopy(trace)
        for _, reset in count_reset.values():
            reset()
        t0 = time.perf_counter()
        for r in reqs:
            engine.submit(r)
        while engine.queue or engine.n_active:
            engine.step()
            if paged:
                engine.check_paged_invariants()
        wall = time.perf_counter() - t0
        run = {n: count() for n, (count, _) in count_reset.items()}
        n_paged = {"fused_decode": FD.paged_launch_count(),
                   "fused_verify": FD.paged_verify_launch_count()}
        want, steps = expected_launches(torch, engine, steps0, True, device)
        if run != want:
            fail(f"{tag}: launches {run}, expected {want} for (plain, draft, "
                 f"verify) layer steps (, prefill layers) {steps}")
        if FD.route_counts()["tc"] != run["fused_decode"] or \
                FD.verify_route_counts()["tc"] != run["fused_verify"]:
            fail(f"{tag}: routes {FD.route_counts()} / "
                 f"{FD.verify_route_counts()}; every launch over a bf16 "
                 f"cache must take the tensor-core route")
        want_paged = {k: run[k] if paged else 0 for k in n_paged}
        if n_paged != want_paged:
            fail(f"{tag}: paged launches {n_paged}, expected {want_paged}")
        if spec and not engine.spec_verify_launches:
            fail(f"{tag}: no speculative tick ran")
        if engine.spec_tree_launches != (engine.spec_verify_launches
                                         if isinstance(spec, tuple) else 0):
            fail(f"{tag}: {engine.spec_tree_launches} tree ticks of "
                 f"{engine.spec_verify_launches} speculative ticks")
        if engine.ctrl.stats["compiles"] != engine.compiles_after_warmup:
            fail(f"{tag}: a step was built after warmup")
        streams = {r.rid: list(r.generated) for r in reqs}
        for r in reqs:
            s = streams[r.rid]
            if len(s) != r.max_new_tokens or not all(0 <= t < cfg.vocab_size
                                                     for t in s):
                fail(f"{tag}: request {r.rid} stream is malformed")
        gen = sum(len(s) for s in streams.values())
        res = dict(streams=streams, tokens_per_s=gen / wall, wall_s=wall)
        note = ""
        if paged:
            st = engine.page_pool_stats()[cfg.n_groups]
            if not st["radix_hits"] > 0:
                fail(f"{tag}: no radix hit on a shared-prefix trace: {st}")
            res["pages"] = {k: st[k] for k in ("n_pages", "peak_in_use",
                                               "allocs", "radix_hits",
                                               "radix_misses",
                                               "radix_hit_rate")}
            note = (f"; pool {st['n_pages']} pages, peak {st['peak_in_use']}"
                    f" in use, {st['allocs']} allocations, radix hits "
                    f"{st['radix_hits']} / misses {st['radix_misses']}, "
                    f"page accounting checked after every tick")
        h = engine._h_spec if spec else engine._h_decode
        res.update(p50_ms=h.p50, p95_ms=h.p95)
        log(f"  e2e {tag}: {gen} tokens, {len(reqs)} requests in {wall:.2f} "
            f"s wall -> {gen / wall:.1f} tokens/s; {engine.decode_launches} "
            f"decode steps, {engine.spec_verify_launches} speculative ticks, "
            f"{engine.prefills} prefills; {'tick' if spec else 'step'} p50 "
            f"{h.p50:.3f} ms p95 {h.p95:.3f} ms{note}")
        log(f"    launches in this drive: " + ", ".join(
            f"{n} {c}" for n, c in run.items())
            + f" (paged: {n_paged}; as expected)")
        launches[tag], paged_launches[tag], results[tag] = run, n_paged, res
        del engine
    for (dense_tag, _, _), (paged_tag, _, _) in zip(PAGED_PATHS[::2],
                                                    PAGED_PATHS[1::2]):
        a, b = results[dense_tag]["streams"], results[paged_tag]["streams"]
        if a != b:
            same = sum(u == w for r in a for u, w in zip(a[r], b[r]))
            fail(f"{paged_tag} vs {dense_tag}: tokens differ ({same} of "
                 f"{sum(len(s) for s in a.values())} agree position-wise)")
        log(f"  {paged_tag} vs {dense_tag}: all {len(a)} streams identical "
            f"({sum(len(s) for s in a.values())} tokens)")
    return launches, paged_launches, results


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def smoke_reference(torch, arch="tinyllama-1.1b", **overrides):
    """The smoke model of ``arch`` (f32, with ``overrides``) on the card
    (kernels) vs the CPU (plain versions): decode at mixed widths, a slot
    prefill (with SSM layers a prompt of three chunks, through the scan
    kernel; MoE layers route it with capacity dispatch) and a verify pass
    with its candidates, unfused and, with attention layers, fused (for
    jamba the fused kernels without RoPE)."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.core import elastic
    from repro_torch.models.model import (decode_step, init_decode_cache,
                                          init_params, prefill, verify_step)

    cfg = dataclasses.replace(smoke_config(arch), **overrides)
    ssm = "ssm" in cfg.layer_pattern
    attn = "attn" in cfg.layer_pattern
    p_cpu = init_params(cfg, seed=3, device="cpu")
    p_gpu = {k: v for k, v in _move(p_cpu, "cuda").items()}
    worst = 0.0
    # fused reaches attention layers only
    for fused in ((False, True) if attn else (False,)):
        outs = []
        for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
            act = elastic.active_widths_batch(cfg, [0.5, 1.0], device=dev)
            cache = init_decode_cache(cfg, 2, 32, per_slot=True, device=dev)
            toks = torch.tensor([[5, 9, 3, 7], [2, 4, 6, 8]], device=dev)
            lg = []
            for t in range(toks.shape[1]):
                logits, cache = decode_step(p, cache, toks[:, t:t + 1], cfg,
                                            active=act, fused=fused)
                lg.append(logits.float().cpu())
            prompt = (torch.arange(1, 3 * cfg.ssm_chunk - 5, device=dev)[None]
                      if ssm else toks[:1])
            pl, _ = prefill(p, {"tokens": prompt}, cfg, cache_extra=4,
                            per_slot=True, slot=1, n_slots=2)
            lg.append(pl.float().cpu())
            vl, pend = verify_step(p, cache, toks, cfg, active=act,
                                   fused=fused)
            lg += [vl.float().cpu()] + [
                a.float().cpu() for a in pend["stack"]["pos0"].values()]
            outs.append(torch.cat([x.reshape(-1) for x in lg]))
        err = float((outs[0] - outs[1]).abs().max())
        if not math.isfinite(err) or err > ATOL_SMOKE:
            fail(f"{arch} smoke model fused={fused}: card vs CPU max |err| "
                 f"{err:.3e}")
        worst = max(worst, err)
    what = "decode, prefill, verify" + (", fused too" if attn else "")
    if not ssm:
        # the chunked prompt pass: the flash kernel on the card, the
        # model's chunked attention on the CPU; 29 tokens cut the kernel's
        # last tile short
        from repro_torch.kernels import flash_attention as FA

        ccfg = cfg.scaled(attn_impl="chunked", attn_chunk=8)
        prompt = (torch.arange(1, 30)[None] * 7) % cfg.vocab_size
        outs = []
        for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
            n0 = FA.launch_count()
            pl, pc = prefill(p, {"tokens": prompt.to(dev)}, ccfg,
                             cache_extra=4)
            if dev == "cuda" and FA.launch_count() != n0 + cfg.n_groups:
                fail(f"chunked prefill launched flash_attention "
                     f"{FA.launch_count() - n0} times, expected "
                     f"{cfg.n_groups}")
            outs.append(torch.cat([pl.float().cpu().reshape(-1)] + [
                a.float().cpu().reshape(-1) for a in pc["stack"]["pos0"]
                .values()]))
        err = float((outs[0] - outs[1]).abs().max())
        if not math.isfinite(err) or err > ATOL_SMOKE:
            fail(f"{arch} smoke model chunked prefill: card vs CPU max |err| "
                 f"{err:.3e}")
        worst = max(worst, err)
        what += ", chunked prefill through flash_attention"
    extra = "".join(f", {k} {v}" for k, v in overrides.items())
    log(f"  {arch} smoke model (f32{extra}) on the card vs plain versions on "
        f"the CPU ({what}): max |err| {worst:.3e} (atol {ATOL_SMOKE:.0e})")


def smoke_tree_engines(torch, arch="tinyllama-1.1b"):
    """The smoke model of ``arch`` (f32), served greedily on the card with a
    TREE token tree (unfused; for the attention model also fused, and fused
    over a paged cache, page 4) and without speculation, and on the CPU
    with the tree: every engine's streams must be the card's plain
    engine's, token for token, and nothing built after warmup."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.models.paged import PagedLayout
    from repro_torch.runtime.serving import ServingEngine, poisson_trace

    cfg = smoke_config(arch)
    p_cpu = init_params(cfg, seed=3, device="cpu")
    p_gpu = _move(p_cpu, "cuda")
    trace = poisson_trace(6, 100.0, seed=2, prompt_len=(1, 6),
                          new_tokens=(3, 12), vocab=cfg.vocab_size)
    runs = [("card plain", "cuda", False, False, False)]
    runs += [("card tree unfused", "cuda", TREE, False, False),
             ("cpu tree", "cpu", TREE, False, False)]
    if "attn" in cfg.layer_pattern:
        runs += [("card tree fused", "cuda", TREE, True, False),
                 ("card tree fused paged", "cuda", TREE, True, True)]
    streams = {}
    for name, dev, spec, fused, paged in runs:
        eng = ServingEngine(p_gpu if dev == "cuda" else p_cpu, cfg,
                            batch_size=3, cache_capacity=32,
                            prefill_threshold=3, fused=fused,
                            paged=PagedLayout(page_size=4) if paged else None,
                            speculative=spec_config(spec), device=dev)
        eng.warmup()
        out = eng.run(copy.deepcopy(trace), budget_fn=None, policy=None)
        if out["completed"] != len(trace) or \
                eng.ctrl.stats["compiles"] != eng.compiles_after_warmup:
            fail(f"{arch} smoke {name}: {out}")
        if spec and not eng.spec_tree_launches:
            fail(f"{arch} smoke {name}: no tree tick ran")
        streams[name] = {r.rid: r.generated for r in eng.completed}
    want = streams["card plain"]
    for name, got in streams.items():
        if got != want:
            fail(f"{arch} smoke model: {name} streams differ from the card's "
                 f"plain engine's")
    log(f"  {arch} smoke model (f32), greedy tree {TREE}: "
        f"{', '.join(streams)} all emit the same "
        f"{sum(len(s) for s in want.values())} tokens")


def _move(tree, dev):
    return {k: _move(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def prompt_pass_ms(torch, params, cfg, seq: int = 256, iters: int = 5,
                   impls=("einsum", "chunked")):
    """One full-depth prompt pass of ``seq`` tokens (batch 1), under each
    attention of ``impls`` (``"einsum"``, ``attn_impl="chunked"``: the
    flash kernel; None: the config's own, for a model without attention):
    host ms and device kernel ms of each."""
    from repro_torch.models.model import prefill

    toks = (torch.arange(seq, device="cuda")[None] * 31 + 7) % cfg.vocab_size
    out = {}
    for impl in impls:
        pcfg = cfg if impl is None else cfg.scaled(attn_impl=impl)

        def run():
            return prefill(params, {"tokens": toks}, pcfg, cache_extra=0)

        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) / iters * 1e3
        per = kernel_us(torch, run, iters)
        dev = sum(per.values()) / iters / 1e3
        top = sorted(per.items(), key=lambda kv: -kv[1])[:3]
        log(f"  prompt pass, {cfg.name}, {seq} tokens, depth {cfg.n_groups}, "
            f"{impl or 'own attention'}: host "
            f"{host:.3f} ms, device {dev:.3f} ms ({dev / seq * 1e3:.2f} us per "
            f"token; idle share {1 - dev / host:.3f}); heaviest: " + "; ".join(
                f"{v / iters / 1e3:.3f} ms {k[:50]}" for k, v in top))
        out[impl] = dict(host_ms=host, device_ms=dev)
    return out


def flash_decode_drive(torch, cfg, calls: int = 0):
    """The flash decode entry point driven as a caller would: one call per
    TinyLlama layer (``calls`` defaults to the depth) over the serving
    cache's shape (8 slots x 4 KV rows of 512 positions, group 8, bf16),
    each at its own length given as a device scalar. Counters are zeroed
    just before and read just after; the output is checked against the
    plain oracle ``ref.flash_decode_ref`` on the card."""
    from repro_torch.kernels import flash_decode as FDK
    from repro_torch.kernels import ref

    slots, S = 8, 512
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    calls = calls or cfg.n_groups * cfg.period
    gen = torch.Generator(device="cuda").manual_seed(15)
    kc, vc, _, _ = decode_cache(torch, gen, slots * KV, S, hd, False)
    q = torch.randn(calls, slots * H, hd, generator=gen,
                    device="cuda").to(torch.bfloat16)
    lens = torch.randint(1, S + 1, (calls, 1), generator=gen, device="cuda",
                         dtype=torch.int32)
    count_reset = counters()
    for _, reset in count_reset.values():
        reset()
    outs = [FDK.flash_decode(q[i], kc, vc, lens[i], group=H // KV)
            for i in range(calls)]
    torch.cuda.synchronize()
    run_launches = {n: count() for n, (count, _) in count_reset.items()}
    want = dict.fromkeys(KERNEL_NAMES, 0)
    want["flash_decode"] = calls
    if run_launches != want:
        fail(f"flash_decode drive: launches {run_launches}, expected {want}")
    if FDK.route_counts() != {"tc": calls, "fma": 0}:
        fail(f"flash_decode drive: routes {FDK.route_counts()}; a bf16 "
             f"cache must take the tensor-core route")
    err = 0.0
    for i in (0, calls - 1):
        ok, e = close(torch, outs[i], ref.flash_decode_ref(
            q[i], kc, vc, lens[i], group=H // KV))
        if not ok:
            fail(f"flash_decode drive call {i}: max |err| {e:.3e} vs oracle")
        err = max(err, e)
    log(f"  flash_decode entry point: {calls} calls at kv_len "
        f"{lens.min().item()}..{lens.max().item()}; launches " + ", ".join(
            f"{n} {c}" for n, c in run_launches.items())
        + f" (as expected); max |err| vs oracle {err:.3e}")
    return run_launches


# ---------------------------------------------------------------------------
# encoder-decoder (whisper-base) and vision-frontend (internvl2-2b) models
# ---------------------------------------------------------------------------

ENCDEC_ARCH = "whisper-base"
VLM_ARCH = "internvl2-2b"
# text tokens after internvl's 256 patches in its model-level drive
VLM_TEXT = 64
FRONTEND_ARCHS = (ENCDEC_ARCH, VLM_ARCH)
# engine paths (as in PATHS); neither family takes speculation
ENCDEC_PATHS = (("whisper_unfused", False, False, 0.0, 0, None),
                ("whisper_fused", True, False, 0.0, 0, None))
ENCDEC_AGREE = (("whisper_unfused", "whisper_fused",
                 "f32 fused projections vs bf16 unfused weights"),)
VLM_PATHS = (("internvl_fused", True, False, 0.0, 0, None),)
# model-level drives and card-vs-CPU checks, by their launch-count tags
ENCDEC_DRIVES = ("whisper_prefill_einsum", "whisper_prefill_chunked",
                 "whisper_decode_unfused", "whisper_decode_fused",
                 "whisper_vs_cpu")
VLM_DRIVES = ("internvl_prefill_einsum", "internvl_prefill_chunked",
              "internvl_decode_fused", "internvl_vs_cpu")


def check_cross_decode(torch, timer, shard_tp=0,
                       qdts=("bfloat16", "float32")):
    """B5 at whisper-base's cross-attention decode shape: 8 slots x 8
    heads over 64 KV rows of all 1500 encoder positions (kv_len 1500), hd
    64, group 1, a bf16 cache (the tensor-core route), with bf16 queries
    (the model's) and f32 ones (an f32 model's), against its plain version,
    timed beside it, beside SDPA over the same keys (bf16 queries) and
    beside its byte bound (K and V read once). With ``shard_tp``, at rank
    0's shard (``layer_config``: 4 of the 8 heads over 32 KV rows at
    tp = 2)."""
    from repro_torch.kernels import flash_decode as FDK

    F = torch.nn.functional
    cfg, _ = layer_config(torch, ENCDEC_ARCH, [1.0] * 8, shard_tp)
    B, H, KV, hd, Se = 8, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.enc_seq
    g = H // KV
    gen = torch.Generator(device="cuda").manual_seed(31)
    kc, vc, _, _ = decode_cache(torch, gen, B * KV, Se, hd, False)
    res = {}
    for qdt in (getattr(torch, n) for n in qdts):
        q = torch.randn(B * H, hd, generator=gen, device="cuda").to(qdt)

        def kern():
            return FDK.flash_decode(q, kc, vc, Se, group=g)

        def plain():
            return FDK.flash_decode_plain(q, kc, vc, Se, group=g)

        r0 = FDK.route_counts()["tc"]
        got = kern()
        if FDK.route_counts()["tc"] != r0 + 1:
            fail("flash_decode at the cross shape: not on the tensor-core "
                 "route")
        want = plain()
        torch.cuda.synchronize()
        rtol, atol = ((RTOL_BF16, ATOL_BF16) if qdt == torch.bfloat16
                      else (RTOL_F32, ATOL_F32))
        ok, err = close(torch, got, want, rtol=rtol, atol=atol)
        if not ok or not bool(torch.isfinite(got.float()).all()):
            fail(f"flash_decode cross shape, {qdt} queries: max |err| "
                 f"{err:.3e} beyond rtol {rtol:.2e} + atol {atol:.0e}")
        t_k, t_kw, t_p = timer.ms(kern), timer.wall_ms(kern), timer.ms(plain)
        t_l = None
        if qdt == torch.bfloat16:
            def lib():
                return F.scaled_dot_product_attention(
                    q.view(B * KV, g, 1, hd), kc[:, None], vc[:, None],
                    enable_gqa=True)
            t_l = timer.ms(lib)
        nbytes = 2 * kc.numel() * kc.element_size() + 2 * q.numel() * \
            q.element_size()
        ops_n = 4 * hd * Se * B * H
        bound, by = dense_bound(nbytes, ops_n, PEAK_BF16 if qdt ==
                                torch.bfloat16 else PEAK_F32)
        splits, rows = FDK.plan(B * KV, g, Se, qdt, kc.dtype, hd, "cuda")
        tag = f"cross q {str(qdt)[6:]}"
        lib_s = "none (f32 queries)" if t_l is None else f"{t_l:.4f} ms"
        log(f"  flash_decode {tag} (BKV={B * KV}, group {g}, S=kv_len={Se}, "
            f"hd={hd}, bf16 cache, route tc; {splits} splits of {rows} rows): "
            f"max|err| {err:.3e} (rtol {rtol:.2e} + atol {atol:.0e})  kernel "
            f"{t_k:.4f} ms (call, event-timed {t_kw:.4f} ms)  plain "
            f"{t_p:.4f} ms  SDPA {lib_s}  bound {bound:.5f} ms ({by}; "
            f"{nbytes / 1e6:.3f} MB); kernel at {bound / t_k:.3f} of the "
            f"bound")
        res[tag] = dict(max_abs_err=err, ms=t_k, wall_ms=t_kw, plain_ms=t_p,
                        bound_ms=bound, bound_by=by, library_ms=t_l,
                        splits=splits, rows_per_split=rows)
    return res


def decode_layer_launches(cfg, fused: bool) -> dict:
    """Hand-kernel launches of one decoder layer's decode step at runtime
    widths: the self-attention's 4 gated projections (unfused) or 1
    ``fused_decode`` (fused, its projections not ``morph_matmul`` counts);
    an encoder-decoder layer's cross-attention, 2 gated projections (query
    and output, in either engine) around 1 ``flash_decode``; the MLP's 3
    (SwiGLU) or 2 gated projections."""
    n = dict.fromkeys(KERNEL_NAMES, 0)
    if fused:
        n["fused_decode"] = 1
    else:
        n["morph_matmul"] = 4
    if cfg.is_encdec:
        n["morph_matmul"] += 2
        n["flash_decode"] = 1
    n["morph_matmul"] += 3 if cfg.activation == "swiglu" else 2
    return n


def prompt_pass_launches(cfg, chunked: bool) -> dict:
    """Hand-kernel launches of one full-depth prompt pass: under
    ``attn_impl="chunked"`` 1 ``flash_attention`` per attention (the
    encoder's layers, and per decoder layer its self-attention and, in an
    encoder-decoder model, its cross-attention); none otherwise (the
    prompts and the 1500 encoder positions stay under "auto"'s 2048)."""
    n = dict.fromkeys(KERNEL_NAMES, 0)
    if chunked:
        n["flash_attention"] = cfg.enc_layers + cfg.n_layers * (
            2 if cfg.is_encdec else 1)
    return n


def expected_launches_frontend(torch, engine, steps0, fused: bool, device):
    """Launch counts one whisper or internvl engine drive must show: the
    engine feeds these families token by token (no prefill, as in the
    reference), so ``decode_layer_launches`` per decoder layer-step."""
    steps = layer_steps(engine, steps0, engine.cfg)
    if engine.prefills or any(steps[1:]):
        fail(f"{engine.cfg.name}: {engine.prefills} prefills, layer steps "
             f"{steps}; the engine feeds these families token by token")
    if torch.device(device).type != "cuda":
        return dict.fromkeys(KERNEL_NAMES, 0), steps
    per = decode_layer_launches(engine.cfg, fused)
    return {k: v * steps[0] for k, v in per.items()}, steps


def frontend_batch(torch, cfg, n: int, text: int, seed: int = 0,
                   device="cuda"):
    """``n`` requests of ``text`` prompt tokens each and the frontend's
    seeded inputs (``data.make_batch``: whisper ``frames`` (n, 1500, 512),
    internvl ``patches`` (n, 256, 1024)), on the card."""
    from repro_torch.data import DataConfig, make_batch, to_device

    extra = cfg.frontend_seq if cfg.frontend == "vision_stub" else 0
    b = make_batch(cfg, DataConfig(seed=seed, global_batch=n,
                                   seq_len=extra + text), 0)
    b.pop("targets")
    return to_device(b, device)


def check_routes(what: str, launches: dict) -> None:
    """Every launch of the attention kernels in a bf16 drive (counted in
    ``launches`` since the counters were zeroed) on the tensor-core
    route."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FDK
    from repro_torch.kernels import fused_decode as FD

    for name, routes in (("flash_attention", FA.route_counts()),
                         ("fused_decode", FD.route_counts()),
                         ("fused_verify", FD.verify_route_counts()),
                         ("flash_decode", FDK.route_counts())):
        if routes["tc"] != launches[name]:
            fail(f"{what}: {name} routes {routes}; every launch over bf16 "
                 f"must take the tensor-core route")


def next_token_margins(torch, arch, a, b):
    """Where two prompt passes' last-position logits ``a`` and ``b`` (B,
    V) pick different greedy tokens, how close the call was: each pass's
    margin between its own pick and the other's, beside the largest
    |a - b| over that row and the median top-1 / top-2 gap of the rows
    that agree. A flip whose margins are far below the agreeing rows' gaps
    is a near tie that rounding decides."""
    top2 = a.topk(2, -1).values
    gap = top2[:, 0] - top2[:, 1]
    ia, ib = a.argmax(-1), b.argmax(-1)
    agree = ia == ib
    med = float(gap[agree].median()) if bool(agree.any()) else float("nan")
    flips = []
    for r in (~agree).nonzero().flatten().tolist():
        ta, tb = int(ia[r]), int(ib[r])
        flips.append(dict(row=r, margin_a=float(a[r, ta] - a[r, tb]),
                          margin_b=float(b[r, tb] - b[r, ta]),
                          row_max_abs_diff=float((a[r] - b[r]).abs().max())))
    log(f"  {arch} next-token flips, einsum vs chunked: " + ("; ".join(
        f"row {f['row']}: margin {f['margin_a']:.4f} in the einsum pass, "
        f"{f['margin_b']:.4f} in the chunked, row max |dlogit| "
        f"{f['row_max_abs_diff']:.4f}" for f in flips) or "none")
        + f"; median top-1/top-2 gap of the agreeing rows {med:.4f}; "
        f"max |dlogit| over all rows {float((a - b).abs().max()):.4f}")
    return dict(agree=int(agree.sum()), rows=int(a.shape[0]),
                median_gap_agreeing=med, flips=flips)


def frontend_model_drive(torch, cfg, params, text: int, fused_paths,
                         n_steps: int = 32, shallow_steps: int = 0):
    """The model-level drive of an encoder-decoder or frontend model at
    full width: 8 requests (``frontend_batch``) through one prompt pass
    under the einsum attention and one under ``attn_impl="chunked"`` (the
    flash kernel), the two passes' greedy next tokens compared; then from
    the chunked pass's cache, for each of ``fused_paths``, ``n_steps``
    greedy decode steps at full depth and ``shallow_steps`` at the first
    exit, the 8 slots at widths (0.5, 1) x 4. Counters are zeroed just
    before each prompt pass and each decode path and read just after; each
    must show its exact counts (``prompt_pass_launches``,
    ``decode_layer_launches`` per layer-step). Host ms and device kernel ms
    of each prompt pass and decode step; returns (launches by drive tag,
    results)."""
    from repro_torch.core import elastic
    from repro_torch.models.model import decode_step, prefill

    arch = "whisper" if cfg.is_encdec else "internvl"
    B = 8
    batch = frontend_batch(torch, cfg, B, text)
    extra = n_steps + shallow_steps + 4
    count_reset = counters()

    def zero():
        for _, reset in count_reset.values():
            reset()

    def read():
        torch.cuda.synchronize()
        return {n: count() for n, (count, _) in count_reset.items()}

    launches, res, caches, nxt, last = {}, {}, {}, {}, {}
    for impl in ("einsum", "chunked"):
        pcfg = cfg.scaled(attn_impl=impl)

        def run():
            return prefill(params, batch, pcfg, cache_extra=extra,
                           per_slot=True)

        zero()
        t0 = time.perf_counter()
        lg, cache = run()
        got = read()
        first = (time.perf_counter() - t0) * 1e3
        tag = f"{arch}_prefill_{impl}"
        want = prompt_pass_launches(cfg, impl == "chunked")
        if got != want:
            fail(f"{tag}: launches {got}, expected {want}")
        check_routes(tag, got)
        launches[tag] = got
        if not bool(torch.isfinite(lg.float()).all()):
            fail(f"{tag}: non-finite logits")
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
        per = kernel_us(torch, run, 1)
        dev = sum(per.values()) / 1e3
        top = sorted(per.items(), key=lambda kv: -kv[1])[:3]
        S = int(cache["pos"][0])
        log(f"  {tag}: {B} requests x {S} prompt positions"
            + (f" + {cfg.enc_seq} encoder frames" if cfg.is_encdec else "")
            + f", depth {cfg.n_groups}: host {host:.3f} ms (first call "
            f"{first:.1f} ms), device {dev:.3f} ms (idle share "
            f"{1 - dev / host:.3f}); launches " + ", ".join(
                f"{n} {c}" for n, c in got.items() if c)
            + " (as expected); heaviest: " + "; ".join(
                f"{v / 1e3:.3f} ms {k[:50]}" for k, v in top))
        res[tag] = dict(host_ms=host, device_ms=dev)
        caches[impl] = cache
        last[impl] = lg[:, -1, :cfg.vocab_size].float()
        nxt[impl] = last[impl].argmax(-1)
    same = int((nxt["einsum"] == nxt["chunked"]).sum())
    log(f"  {arch} prompt passes, einsum vs chunked: {same}/{B} greedy next "
        f"tokens agree (the flash kernel keeps p in f32 for P.V, the einsum "
        f"rounds it to bf16; reported, not asserted)")
    res[f"{arch}_prefill_agreement"] = next_token_margins(
        torch, arch, last["einsum"], last["chunked"])
    act = elastic.active_widths_batch(cfg, [0.5, 1.0] * (B // 2),
                                      device="cuda")
    exit_depth = min(m.depth for m in cfg.elastic.modes(cfg.n_groups))
    streams = {}
    for fused in fused_paths:
        tag = f"{arch}_decode_{'fused' if fused else 'unfused'}"
        runs = [(cfg.n_groups, n_steps)]
        if shallow_steps:
            runs.append((exit_depth, shallow_steps))
        zero()
        wall, toks = {}, {}
        with torch.no_grad():
            for depth, n in runs:
                cache = {"pos": caches["chunked"]["pos"].clone(),
                         "stack": {pn: {k: t.clone() for k, t in l.items()}
                                   for pn, l in
                                   caches["chunked"]["stack"].items()}}
                tok = nxt["chunked"][:, None]
                out = []
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    lg, cache = decode_step(params, cache, tok, cfg,
                                            depth=depth, active=act,
                                            fused=fused)
                    tok = lg[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
                    out.append(tok)
                torch.cuda.synchronize()
                wall[depth] = (time.perf_counter() - t0) / n * 1e3
                toks[depth] = torch.cat(out, 1)
            got = read()
            layer_steps_n = sum(d * cfg.period * n for d, n in runs)
            want = {k: v * layer_steps_n for k, v in
                    decode_layer_launches(cfg, fused).items()}
            if got != want:
                fail(f"{tag}: launches {got}, expected {want} for "
                     f"{layer_steps_n} layer-steps")
            check_routes(tag, got)
            streams[fused] = toks[cfg.n_groups]
            if not bool(((streams[fused] >= 0)
                         & (streams[fused] < cfg.vocab_size)).all()):
                fail(f"{tag}: a token out of the vocabulary")
            per = kernel_us(torch, lambda: decode_step(
                params, cache, tok, cfg, active=act, fused=fused), 2)
        dev = sum(per.values()) / 2 / 1e3
        top = sorted(per.items(), key=lambda kv: -kv[1])[:3]
        host = wall[cfg.n_groups]
        log(f"  {tag}: {' + '.join(f'{n} steps at depth {d}' for d, n in runs)}"
            f", B={B} at widths (0.5, 1): step at depth {cfg.n_groups} "
            f"host {host:.3f} ms ({B / host * 1e3:.1f} tokens/s), device "
            f"{dev:.3f} ms (idle share {1 - dev / host:.3f})"
            + "".join(f"; at depth {d} host {wall[d]:.3f} ms" for d, _ in
                      runs[1:])
            + "; launches " + ", ".join(f"{n} {c}" for n, c in got.items()
                                        if c)
            + f" ({layer_steps_n} layer-steps, as expected); heaviest: "
            + "; ".join(f"{v / 2e3:.3f} ms {k[:50]}" for k, v in top))
        launches[tag] = got
        res[tag] = dict(step_host_ms=host, step_device_ms=dev,
                        tokens_per_s=B / host * 1e3)
    if len(streams) == 2:
        a, b_ = streams[False], streams[True]
        log(f"  {arch} decode, unfused vs fused: "
            f"{int((a == b_).sum())}/{a.numel()} tokens agree position-wise "
            f"(f32 fused projections vs bf16 unfused weights; reported, not "
            f"asserted)")
    del caches
    return launches, res


def full_width_vs_cpu(torch, arch, n_layers=None, text: int = 4):
    """``arch`` at full width in f32 (``n_layers`` cuts the depth), seeded
    weights made on the card and copied to the CPU: one request's prompt
    pass under ``attn_impl="chunked"`` and 4 fused decode steps at full
    width, the card's kernels (flash_attention, fused_decode, morph_matmul
    and, for whisper, flash_decode, all on their f32 routes) against the
    plain versions on the CPU; the prompt pass's and every step's logits to
    ATOL_SMOKE. Returns the card's launches, checked exactly."""
    from repro_torch.configs import get_config
    from repro_torch.core import elastic
    from repro_torch.models.model import decode_step, init_params, prefill

    cfg = get_config(arch).scaled(dtype="float32", attn_impl="chunked")
    if n_layers:
        cfg = cfg.scaled(n_layers=n_layers)
    p_gpu = init_params(cfg, seed=1, device="cuda")
    p_cpu = _move(p_gpu, "cpu")
    b_gpu = frontend_batch(torch, cfg, 1, text, seed=1)
    count_reset = counters()
    outs = {}
    for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
        for _, reset in count_reset.values():
            reset()
        act = elastic.active_widths_batch(cfg, [1.0], device=dev)
        with torch.no_grad():
            lg, cache = prefill(p, _move(b_gpu, dev), cfg, cache_extra=4,
                                per_slot=True)
            got = [lg]
            for t in (5, 9, 3, 7):
                lg, cache = decode_step(p, cache, torch.tensor([[t]],
                                                               device=dev),
                                        cfg, active=act, fused=True)
                got.append(lg)
        sync(torch, dev)
        outs[dev] = [x.float().cpu() for x in got]
        launches = {n: count() for n, (count, _) in count_reset.items()}
    want = prompt_pass_launches(cfg, True)
    for k, v in decode_layer_launches(cfg, True).items():
        want[k] += 4 * cfg.n_layers * v
    if launches != want:
        fail(f"{arch} f32 on the card: launches {launches}, expected {want}")
    err = max(float((a - b).abs().max()) for a, b in zip(outs["cpu"],
                                                        outs["cuda"]))
    if not math.isfinite(err) or err > ATOL_SMOKE:
        fail(f"{arch} full width f32: card vs CPU max |err| {err:.3e}")
    log(f"  {arch} at full width, {cfg.n_layers} layers, f32 on the card "
        f"(chunked prompt pass, 4 fused decode steps) vs plain versions on "
        f"the CPU: max |err| {err:.3e} over the logits (atol "
        f"{ATOL_SMOKE:.0e}); card launches " + ", ".join(
            f"{n} {c}" for n, c in launches.items() if c) + " (as expected)")
    del p_gpu, p_cpu
    torch.cuda.empty_cache()
    return launches


def encdec_phase(torch, timer):
    """Phase 3 for ``whisper-base`` (98.8 M parameters, full width and
    depth): the model-level transcription drive (8 requests of 1500 seeded
    frames and a 4-token prompt; prompt passes under einsum and chunked
    attention; 32 greedy steps at depth 6 and 8 at depth 3, unfused and
    fused), the engine unfused and fused on 12 Poisson requests (token
    feed), and full depth in f32 on the card against the CPU."""
    from repro_torch.configs import get_config

    cfg = get_config(ENCDEC_ARCH)
    t0 = time.perf_counter()
    params = init_on_card(torch, cfg)
    launches, res = frontend_model_drive(torch, cfg, params, text=4,
                                         fused_paths=(False, True),
                                         shallow_steps=8)
    log(f"    seconds: model-level drive {time.perf_counter() - t0:.1f}")
    el, eres = end_to_end(torch, cfg, params, timer, n_requests=12,
                          prompt_len=(4, 16), new_tokens=(32, 64),
                          capacity=128, paths=ENCDEC_PATHS,
                          expect=expected_launches_frontend,
                          agreements=ENCDEC_AGREE)
    launches.update(el)
    res.update({k: {m: v for m, v in r.items() if m != "streams"}
                for k, r in eres.items()})
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches["whisper_vs_cpu"] = full_width_vs_cpu(torch, ENCDEC_ARCH)
    log(f"    seconds: card vs CPU {time.perf_counter() - t0:.1f}")
    return launches, res


def vlm_phase(torch, timer):
    """Phase 3 for ``internvl2-2b`` (1.898 B parameters, full width and
    depth): the model-level drive (8 requests of 256 seeded patches and 64
    text tokens; prompt passes under einsum and chunked attention; 32
    greedy fused steps), the fused engine on 12 Poisson requests (token
    feed), and 4 layers of full width in f32 on the card against the
    CPU."""
    from repro_torch.configs import get_config

    cfg = get_config(VLM_ARCH)
    t0 = time.perf_counter()
    params = init_on_card(torch, cfg)
    launches, res = frontend_model_drive(torch, cfg, params, text=VLM_TEXT,
                                         fused_paths=(True,))
    log(f"    seconds: model-level drive {time.perf_counter() - t0:.1f}")
    el, eres = end_to_end(torch, cfg, params, timer, n_requests=12,
                          prompt_len=(4, 16), new_tokens=(32, 64),
                          capacity=128, paths=VLM_PATHS,
                          expect=expected_launches_frontend, agreements=())
    launches.update(el)
    res.update({k: {m: v for m, v in r.items() if m != "streams"}
                for k, r in eres.items()})
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches["internvl_vs_cpu"] = full_width_vs_cpu(torch, VLM_ARCH,
                                                    n_layers=4, text=16)
    log(f"    seconds: card vs CPU {time.perf_counter() - t0:.1f}")
    return launches, res


# ---------------------------------------------------------------------------
# phase 4: training on the card
# ---------------------------------------------------------------------------

# ssd_scan backward vs its plain version on the card, f32: C.B^T comes from
# the forward's 3xTF32 products, the kernel restarts no sum the plain
# version keeps, and both sum in other orders; each gradient is held to
# 1e-3 of its own largest magnitude plus 1e-3 relative (the forward's
# tolerance), a bf16 dx to one bf16 rounding step more
RTOL_BWD = 1e-3
ATOL_BWD = 1e-3  # times the gradient's max |plain|
# whole-model gradients, card (scan kernels) vs the CPU plain route, f32:
# the relative error norm of each parameter's gradient
GRAD_REL = 1e-3
# distinct batches the base training steps cycle over
BASE_BATCHES = 4


def scan_bwd_bound(b, s, h, p, g, n, x_bytes):
    """(ms, bound_by, bytes, ops) of one backward scan at the card's peaks:
    the least f32 work over every tile length; x, dy, dt, A, B, C and the
    final state's gradient read once, dx, ddt, dA, dB and dC written once
    (``ssd_scan.bwd_cost``)."""
    import torch

    from repro_torch.kernels import ssd_scan as SSD

    ops, nbytes = SSD.bwd_cost(b, s, h, p, g, n, {4: torch.float32,
                                                  2: torch.bfloat16}[x_bytes])
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / PEAK_F32
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations",
            nbytes, ops)


def check_ssd_scan_bwd(torch, cfg, timer):
    """The scan's backward kernel against ``ssd_scan_bwd_plain`` on the
    card, on the forward kernel's kept workspace: at the Mamba2-370M
    training shape (B = 8, S = 256, 32 heads of 64, n = 128, one group) with
    x in f32 and in bf16, at width 0.5 (16 heads), at a ragged S = 200, and
    with dt = 0.5 so that a 64-step tile's decay (32 |A|, A in -[1, 16))
    passes 88. Each gradient's max |kernel - plain| against its tolerance;
    the kernel timed beside its plain version and its bound."""
    from repro_torch.kernels import ssd_scan as SSD

    h, p, g, n = (cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_ngroups,
                  cfg.ssm_state)
    gen = torch.Generator(device="cuda").manual_seed(19)
    res = {}
    for tag, (b, s, hh), xdt, big in (
            ("train f32", (8, 256, h), torch.float32, False),
            ("train bf16 x", (8, 256, h), torch.bfloat16, False),
            ("width 0.5", (8, 256, h // 2), torch.float32, False),
            ("ragged S=200", (8, 200, h), torch.float32, False),
            ("large decay", (2, 256, h), torch.float32, True)):
        x, dt, A, B, C = scan_inputs(torch, gen, b, s, hh, p, g, n)
        if big:
            dt = torch.full_like(dt, 0.5)
        x = x.to(xdt)
        A_bh = A.expand(b, hh).contiguous()
        dy = torch.randn(b, s, hh, p, generator=gen, device="cuda").to(xdt)
        ds = torch.randn(b, hh, p, n, generator=gen, device="cuda")
        _, _, ws = SSD.launch_bshn(x, dt, A_bh, B, C, keep_workspace=True)

        def kern():
            return SSD.launch_bwd(x, dt, A_bh, B, C, ws, dy, ds)

        def plain():
            return SSD.ssd_scan_bwd_plain(x, dt, A_bh, B, C, dy, ds)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        errs, worst = [], 0.0
        for name, gk, gp in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
            gk, gp = gk.float(), gp.float()
            scale = float(gp.abs().max())
            rtol = RTOL_BWD + (2.0 ** -7 if name == "dx"
                               and xdt == torch.bfloat16 else 0.0)
            err = (gk - gp).abs()
            e = float(err.max())
            if not (bool(torch.isfinite(gk).all())
                    and bool((err <= ATOL_BWD * scale + rtol * gp.abs()).all())):
                fail(f"ssd_scan_bwd {tag} {name}: max |err| {e:.3e} beyond "
                     f"atol {ATOL_BWD:.0e} x {scale:.3e} + rtol {rtol:.1e}")
            errs.append(f"{name} {e:.2e} (scale {scale:.2e})")
            worst = max(worst, e)
        t_k = timer.ms(kern)
        parts = {"carry": 0.0, "pass": 0.0, "tile": 0.0, "sum": 0.0}
        for name, t in timer.last.items():
            for part in parts:
                if f"ssd_bwd_{part}_kernel" in name:
                    parts[part] += t
        t_kw = timer.wall_ms(kern)
        t_p = timer.ms(plain)
        bound, by, nbytes, nops = scan_bwd_bound(b, s, hh, p, g, n,
                                                 x.element_size())
        log(f"  ssd_scan_bwd {tag} (b={b}, s={s}, h={hh}, p={p}, g={g}, "
            f"n={n}, x {str(xdt)[6:]}): max|kernel - plain| " + ", ".join(errs)
            + f" (atol {ATOL_BWD:.0e} x scale + rtol {RTOL_BWD:.0e}); kernel "
            f"{t_k:.4f} ms (call, event-timed {t_kw:.4f} ms) = tile-state "
            f"carry terms {parts['carry']:.4f} + reverse carry "
            f"{parts['pass']:.4f} + tile gradients {parts['tile']:.4f} + "
            f"group sums {parts['sum']:.4f}; plain {t_p:.4f} ms; bound "
            f"{bound:.4f} ms ({by}; {nbytes / 1e6:.2f} MB, {nops / 1e9:.3f} "
            f"GFLOP f32 at {PEAK_F32 / 1e12:.0f} TFLOP/s); library: none")
        res[tag] = dict(max_abs_err=worst, ms=t_k, wall_ms=t_kw, plain_ms=t_p,
                        bound_ms=bound, bound_by=by, per_launch=parts)
    return res


def check_model_grads(torch, mcfg, layers=4, b=2, s=256):
    """Full-width Mamba2-370M cut to ``layers`` layers, f32 activations:
    ``loss_fn`` gradients on the card (the scan kernel forward and
    backward) against the same params and batch through the plain route on
    the CPU (autograd through ``ssd_chunked``). Each parameter's relative
    error norm must stay within GRAD_REL, every gradient finite."""
    import dataclasses

    from repro_torch.data import DataConfig, make_batch, to_device
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.models.model import init_params, loss_fn
    from repro_torch.optim import grads_of, trainable
    from repro_torch.optim.optimizer import leaves_with_path

    cfg = mcfg.scaled(n_layers=layers, dtype="float32",
                      elastic=dataclasses.replace(mcfg.elastic,
                                                  exit_layers=(layers // 2,)))
    p_cpu = init_params(cfg, seed=5, device="cpu")
    batch = make_batch(cfg, DataConfig(seed=5, global_batch=b, seq_len=s), 0)
    out = {}
    for dev in ("cuda", "cpu"):
        p = trainable(_move(p_cpu, dev))
        f0, b0 = SSD.launch_count(), SSD.bwd_launch_count()
        loss, _ = loss_fn(p, to_device(batch, dev), cfg)
        g = grads_of(loss, p)
        sync(torch, dev)
        if dev == "cuda" and (SSD.launch_count() - f0, SSD.bwd_launch_count()
                              - b0) != (layers, layers):
            fail(f"model gradients on the card: {SSD.launch_count() - f0} "
                 f"forward and {SSD.bwd_launch_count() - b0} backward scans, "
                 f"expected {layers} each")
        out[dev] = (loss.item(), {k: t.detach().float().cpu()
                                  for k, t in leaves_with_path(g)})
    worst, where = 0.0, ""
    for k, gp in out["cpu"][1].items():
        gc = out["cuda"][1][k]
        if not bool(torch.isfinite(gc).all()):
            fail(f"model gradient {k} on the card is not finite")
        ref = float(gp.norm())
        d = float((gc - gp).norm())
        rel = d / ref if ref > 0 else d
        if rel > GRAD_REL:
            fail(f"model gradient {k}: card vs CPU relative error norm "
                 f"{rel:.3e} > {GRAD_REL:.0e}")
        if rel >= worst:
            worst, where = rel, k
    log(f"  mamba2-370m full width, {layers} layers, f32, B={b}, S={s}: "
        f"loss card {out['cuda'][0]:.6f} / CPU {out['cpu'][0]:.6f}; "
        f"{len(out['cpu'][1])} gradients, largest relative error norm "
        f"{worst:.3e} ({where}; bound {GRAD_REL:.0e}), all finite")
    return worst


def _ms(xs):
    return sum(xs) / len(xs) if xs else float("nan")


def train_drive(torch, cfg, n_steps, distill, ocfg_kw, seed=0, seq_len=256,
                must_fall=False):
    """Full-width, full-depth training of ``cfg`` on the card from seeded
    random weights: ``n_steps`` base ``make_train_step`` steps (B = 8,
    ``seq_len`` tokens (an encoder-decoder model also takes its frames),
    AdamW, cycling over BASE_BATCHES batches; with ``must_fall`` the last
    step's loss must be below the first's, on the same batch when
    ``n_steps`` is BASE_BATCHES + 1), then with
    ``distill`` DistillCycle over ``default_schedule`` (one epoch of 2
    teacher + 2 student steps a stage) and
    ``eval_modes(with_agreement=True)``. Every kernel count is zeroed
    just before the drive and read just after; each step's scan launches
    are checked as they come: a base step, as many forward and backward
    scans as SSM layers; a teacher step at the grown depth D, D and D; a
    student step at depth d, D + d forward (the teacher's no-grad forward
    and the student's) and d backward. Returns (launches, results, the
    DistillCycle-trained parameters or None)."""
    from repro_torch.core.distillcycle import (DistillCycle,
                                               DistillCycleConfig)
    from repro_torch.data import DataConfig, make_batch, to_device
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.optim import OptimizerConfig, warmup_cosine

    ssm = "ssm" in cfg.layer_pattern
    per_group = sum(k == "ssm" for k in cfg.layer_pattern)
    ocfg = OptimizerConfig(**ocfg_kw)
    dc = DataConfig(seed=seed, global_batch=8, seq_len=seq_len)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, ocfg, seed=seed, device="cuda")
    step = make_train_step(cfg, ocfg, remat="none",
                           lr_schedule=warmup_cosine(1.0, 2, n_steps))
    # the base steps cycle over BASE_BATCHES batches: in 20 steps of 2048
    # fresh tokens a model cannot learn a bigram table over a ~50 K vocab
    # (a token comes up about once), so fresh batches leave the loss at
    # log V; revisited batches show the optimizer lowering it
    batches = [to_device(make_batch(cfg, dc, i), "cuda")
               for i in range(BASE_BATCHES)]
    torch.cuda.synchronize()
    count_reset = counters()
    for _, reset in count_reset.values():
        reset()
    last = [SSD.launch_count(), SSD.bwd_launch_count(), time.perf_counter()]

    def scans_since(want_f, want_b, what):
        torch.cuda.synchronize()
        f, b_, t = SSD.launch_count(), SSD.bwd_launch_count(), \
            time.perf_counter()
        got = (f - last[0], b_ - last[1])
        ms = (t - last[2]) * 1e3
        last[:] = [f, b_, t]
        if got != (want_f, want_b):
            fail(f"{cfg.name} {what}: {got[0]} forward and {got[1]} backward "
                 f"scans, expected {want_f} and {want_b}")
        return ms

    L = cfg.n_groups * per_group
    losses, wall = [], []
    n_prof = 2
    for i in range(n_steps - n_prof):
        state, m = step(state, batches[i % BASE_BATCHES])
        wall.append(scans_since(L, L, f"base step {i}"))
        losses.append(m["loss"].item())
    prof_steps = iter(range(n_steps - n_prof, n_steps))

    def profiled():
        nonlocal state
        state, m = step(state, batches[next(prof_steps) % BASE_BATCHES])
        losses.append(m["loss"].item())

    per = kernel_us(torch, profiled, n_prof)
    scans_since(n_prof * L, n_prof * L, "profiled base steps")
    dev_ms = sum(per.values()) / n_prof / 1e3
    host_ms = _ms(wall[1:])
    top = sorted(per.items(), key=lambda kv: -kv[1])[:4]
    if not all(math.isfinite(v) for v in losses):
        fail(f"{cfg.name} base training: a loss is not finite: {losses}")
    first, tail = _ms(losses[:5]), _ms(losses[-5:])
    res = dict(base_losses=losses, base_step_ms=host_ms, base_device_ms=dev_ms,
               base_idle_share=1 - dev_ms / host_ms)
    log(f"  {cfg.name} base training, B=8, S={seq_len}"
        + (f" (+ {cfg.enc_seq} encoder frames)" if cfg.is_encdec else "")
        + f", {n_steps} steps, AdamW lr "
        f"{ocfg.lr:g}: loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of the "
        f"first 5 {first:.4f}, of the last 5 {tail:.4f}); step {host_ms:.1f} "
        f"ms wall (steps 1..{n_steps - n_prof - 1}), {dev_ms:.1f} ms device "
        f"(profiled steps), idle share {1 - dev_ms / host_ms:.3f}; heaviest: "
        + "; ".join(f"{v / n_prof / 1e3:.2f} ms {k[:48]}" for k, v in top))
    log(f"    base losses, full precision: {losses}")
    if distill and not tail < first:
        fail(f"{cfg.name} base loss did not fall: first 5 {first:.4f}, last 5 "
             f"{tail:.4f}")
    if must_fall and not losses[-1] < losses[0]:
        fail(f"{cfg.name} base loss did not fall: {losses}")
    params = None
    if distill:
        dcfg = DistillCycleConfig(epochs_per_stage=1, steps_per_epoch=2,
                                  epoch_lr_decay=1.0)
        cyc = DistillCycle(cfg, ocfg, dc, dcfg=dcfg)
        kind_ms = {"teacher": [], "student": []}

        def on_step(kind, mode, depth):
            d = mode.depth
            want = (depth, depth) if kind == "teacher" else (depth + d, d)
            kind_ms[kind].append(scans_since(
                want[0] * per_group, want[1] * per_group,
                f"{kind} step of {mode.name} (grown depth {depth})"))

        last[2] = time.perf_counter()
        params, _ = cyc.run(state["params"], state["opt"], on_step=on_step)
        ev = cyc.eval_modes(params, with_agreement=True)
        n_eval = 4 * (cfg.n_groups + sum(m.depth for m in cyc.schedule))
        scans_since(n_eval * per_group, 0, "eval_modes")
        hist = [{k: (round(v, 4) if isinstance(v, float) else v)
                 for k, v in h.items()} for h in cyc.history]
        vals = [v for h in cyc.history for k, v in h.items()
                if k.endswith(("loss", "ce", "kd"))]
        vals += [v["ce"] for v in ev.values()]
        if not all(math.isfinite(v) for v in vals):
            fail(f"{cfg.name} DistillCycle: a loss is not finite: {hist} {ev}")
        log(f"  DistillCycle, {len(cyc.schedule)} stages "
            f"({', '.join(m.name for m in cyc.schedule)}), 2 teacher + 2 "
            f"student steps a stage, {cyc.builds} step callables built: "
            f"teacher step {_ms(kind_ms['teacher']):.1f} ms, student step "
            f"{_ms(kind_ms['student']):.1f} ms wall (batch making included)")
        for h in hist:
            log(f"    {h}")
        log("  eval_modes(with_agreement=True): " + "; ".join(
            f"{k} CE {v['ce']:.4f} agreement {v['agreement']:.3f}"
            for k, v in ev.items()))
        log(f"    eval_modes, full precision: {ev}")
        res.update(history=hist, eval=ev,
                   teacher_step_ms=_ms(kind_ms["teacher"]),
                   student_step_ms=_ms(kind_ms["student"]))
    torch.cuda.synchronize()
    launches = {n_: count() for n_, (count, _) in count_reset.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    res["peak_gib"] = peak
    want_zero = [k for k in KERNEL_NAMES
                 if k not in (("ssd_scan", "ssd_scan_bwd") if ssm else ())]
    if any(launches[k] for k in want_zero):
        fail(f"{cfg.name} training launched {launches}; only the scan "
             f"kernels belong to its path")
    log(f"  {cfg.name} training drive: launches " + ", ".join(
        f"{k} {v}" for k, v in launches.items())
        + f" (each step as expected); peak device memory {peak:.2f} GiB")
    del state
    torch.cuda.empty_cache()
    return launches, res, params


def check_reproducible(torch, cfg, n_steps=2):
    """Two seeded full-depth ``make_train_step`` runs of ``cfg`` in one
    process (B = 8, S = 256, AdamW lr 2e-3, ``n_steps`` steps each on the
    first batches of ``DataConfig(seed=0)``): fails unless the parameters
    and both optimizer moments come out bit-identical."""
    from repro_torch.data import DataConfig, make_batch, to_device
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.optim import OptimizerConfig
    from repro_torch.optim.optimizer import leaves_with_path

    ocfg = OptimizerConfig(lr=2e-3)
    dc = DataConfig(seed=0, global_batch=8, seq_len=256)
    runs, losses = [], []
    for _ in range(2):
        state = init_train_state(cfg, ocfg, seed=0, device="cuda")
        step = make_train_step(cfg, ocfg, remat="none")
        hist = []
        for i in range(n_steps):
            state, m = step(state, to_device(make_batch(cfg, dc, i), "cuda"))
            hist.append(m["loss"].item())
        losses.append(hist)
        runs.append({f"{part}/{k}": t.detach().clone()
                     for part, tree in (("params", state["params"]),
                                        ("mu", state["opt"].mu),
                                        ("nu", state["opt"].nu))
                     for k, t in leaves_with_path(tree)})
        del state
        torch.cuda.empty_cache()
    differ = [k for k in runs[0] if not torch.equal(runs[0][k], runs[1][k])]
    if differ or losses[0] != losses[1]:
        fail(f"{cfg.name}: two seeded runs of {n_steps} train steps differ: "
             f"losses {losses}; {len(differ)} of {len(runs[0])} tensors, "
             f"first {differ[:4]}")
    log(f"  {cfg.name}, two seeded runs of {n_steps} train steps in one "
        f"process: losses {losses[0]} both times; all {len(runs[0])} "
        f"parameter and moment tensors bit-identical")
    del runs
    torch.cuda.empty_cache()


# phase 4's serving of the trained Mamba2 parameters (4 requests x 16 new
# tokens), as in PATHS
TRAINED_PATHS = (("mamba2_trained_plain", False, False, 0.0, 0, None),
                 ("mamba2_trained_spec", False, True, 0.0, 0, None))
TRAINED_AGREE = (("mamba2_trained_spec", "mamba2_trained_plain",
                  "verify pass vs decode steps, bf16 activations"),)


def training_phase(torch, cfg, mcfg, timer, full=True):
    """Phase 4: the scan's backward kernel against its plain version; with
    ``full``, the 4-layer full-width Mamba2 gradients against the CPU, the
    full-depth Mamba2-370M DistillCycle, the trained parameters served
    (they require grad: the engine ticks under ``no_grad``; plain and
    linear-speculative, 4 requests x 16 tokens, acceptance printed),
    TinyLlama-1.1B's train steps and whisper-base's (5 steps, 64 decoder
    tokens and 1500 frames a sequence; the last step's loss below the
    first's, on the same batch). Returns (backward kernel results,
    launches per path, results)."""
    phase("[phase 4] training: the ssd_scan backward kernel vs its plain "
          "version (Mamba2-370M training shapes)")
    bwd = check_ssd_scan_bwd(torch, mcfg, timer)
    torch.cuda.empty_cache()
    if not full:
        return bwd, {}, {}
    phase("[phase 4] training: full-width Mamba2-370M gradients, card vs CPU")
    check_model_grads(torch, mcfg)
    phase("[phase 4] training: full-depth Mamba2-370M steps reproduce bit for "
          "bit")
    check_reproducible(torch, mcfg)
    phase("[phase 4] training: full-width Mamba2-370M cut to 24 layers: base "
          "steps and DistillCycle, one card")
    # 24 of its 48 layers since PR 26 (the run's time)
    mcut = depth_cut(mcfg, 24, (12, 18))
    ml, mres, mparams = train_drive(torch, mcut, 20, True, dict(lr=2e-3))
    phase("[phase 4] serving the DistillCycle-trained Mamba2-370M parameters")
    n_grad = sum(t.requires_grad for t in _leaves(mparams))
    log(f"  {n_grad} of {len(list(_leaves(mparams)))} trained parameter "
        f"tensors require grad; served as they are")
    sl, sres = end_to_end(torch, mcut, mparams, n_requests=4,
                          prompt_len=(16, 64), new_tokens=(16, 16),
                          capacity=128, paths=TRAINED_PATHS,
                          expect=expected_launches_ssm,
                          agreements=TRAINED_AGREE)
    mres["served"] = {k: {m: v for m, v in r.items() if m != "streams"}
                      for k, r in sres.items()}
    del mparams
    torch.cuda.empty_cache()
    phase("[phase 4] training: full-width TinyLlama-1.1B train steps, one card")
    tl, tres, _ = train_drive(torch, cfg, 5, False, dict(lr=2e-3))
    phase("[phase 4] training: full-width whisper-base train steps, one card")
    from repro_torch.configs import get_config

    wl, wres, _ = train_drive(torch, get_config(ENCDEC_ARCH),
                              BASE_BATCHES + 1, False, dict(lr=2e-3),
                              seq_len=64, must_fall=True)
    return (bwd, dict(sl, mamba2_train=ml, tinyllama_train=tl,
                      whisper_train=wl),
            {"mamba2-370m": mres, "tinyllama-1.1b": tres,
             "whisper-base": wres})


# ---------------------------------------------------------------------------
# phase 3: failover (PR 23)
# ---------------------------------------------------------------------------

# drive name -> (arch, config overrides, speculation, paged page size,
# n requests, prompt lengths, new tokens, planned failure sites). Every
# drive is fused, greedy, 8 slots, capacity 512, prefill threshold 8,
# admitted in the full mode, on a Poisson trace at rate 1e6 (every arrival
# at t ~ 0, so the schedule does not depend on step times), seed 5, 30%
# interactive.
FAILOVER_DRIVES = (
    # TinyLlama at 8 of its 22 layers (an exit at 4) and Mamba2 at 24 of
    # 48: the later phases share the run's time
    ("tinyllama_fused_linear", "tinyllama-1.1b",
     dict(attn_impl="chunked", n_layers=8), "linear", 0, 12, (1, 64),
     (32, 64), ("decode", "verify", "prefill")),
    ("tinyllama_paged_tree", "tinyllama-1.1b",
     dict(attn_impl="chunked", n_layers=8), "tree", PAGE, 12, (1, 64),
     (32, 64), ("paged_decode", "tree_verify", "prefill")),
    ("mamba2_linear", "mamba2-370m", dict(n_layers=24), "linear", 0, 8,
     (1, 64), (16, 16), ("decode", "verify", "prefill")),
    # full width cut to 4 layers, f32 (an exit at 2 to draft from): the
    # kernels' f32 routes, where a replay's cache should land within f32
    # rounding of the source's
    ("tinyllama_f32_4layers", "tinyllama-1.1b",
     dict(attn_impl="chunked", dtype="float32", n_layers=4), "linear", 0, 12,
     (1, 64), (32, 64), ("decode", "verify", "prefill")),
)
FAILOVER_K = 2


def check_routes_f32(what: str, launches: dict) -> None:
    """Every attention kernel launch of an f32 drive on the FMA route."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_decode as FD

    for name, routes in (("flash_attention", FA.route_counts()),
                         ("fused_decode", FD.route_counts()),
                         ("fused_verify", FD.verify_route_counts())):
        if routes["fma"] != launches[name] or routes["tc"]:
            fail(f"{what}: {name} routes {routes}; every launch over f32 "
                 f"must take the FMA route")


def failover_spec(kind):
    from repro_torch.runtime.speculative import SpecConfig

    if kind == "tree":
        return SpecConfig(ks=(), trees=(TREE,), min_accept_rate=0.0)
    return SpecConfig(ks=(FAILOVER_K,), min_accept_rate=0.0)


def layer_launches(cfg, fused: bool, verify: bool) -> dict:
    """Hand-kernel launches of one layer group of a decode (``verify``
    False) or verify step: an attention layer fused is 1 ``fused_decode``
    or ``fused_verify`` plus the MLP's 3 ``morph_matmul`` (7 unfused); an
    SSM layer 4 ``morph_matmul``."""
    n = dict.fromkeys(KERNEL_NAMES, 0)
    for p in range(cfg.period):
        if cfg.layer_kind(p) == "ssm":
            n["morph_matmul"] += 4
        elif fused:
            n["fused_verify" if verify else "fused_decode"] += 1
            n["morph_matmul"] += 3
        else:
            n["morph_matmul"] += 7
    return n


def prefill_launches(cfg, depth: int) -> dict:
    """Hand-kernel launches of one prefill to ``depth`` groups: 1
    ``ssd_scan`` per SSM layer, and under ``attn_impl="chunked"`` 1
    ``flash_attention`` per attention layer."""
    n = dict.fromkeys(KERNEL_NAMES, 0)
    for p in range(cfg.period):
        if cfg.layer_kind(p) == "ssm":
            n["ssd_scan"] += depth
        elif cfg.attn_impl == "chunked":
            n["flash_attention"] += depth
    return n


def _add(total: dict, part: dict, times: int = 1) -> None:
    for k, v in part.items():
        total[k] += v * times


def slot_lanes(g, i: int, fed: int) -> dict:
    """Copies of slot ``i``'s cache in depth group ``g``, per leaf: K/V
    (and int8 scales) on its committed rows [0, fed) as a dense (G, rows,
    ...) lane, gathered through its page table when the cache is paged;
    recurrent SSM leaves whole."""
    from repro_torch.models.paged import is_paged_key

    out = {}
    for pn, layer in g.cache["stack"].items():
        for k, t in layer.items():
            if not is_paged_key(k):
                out[f"{pn}/{k}"] = t[:, i].clone()
            elif g.paging is None:
                out[f"{pn}/{k}"] = t[:, i, :min(fed, t.shape[2])].clone()
            else:
                ps = g.paging.ps
                pages = [int(p) for p in g.paging.table[i, :-(-fed // ps)]]
                rows = t[:, pages].reshape((t.shape[0], len(pages) * ps)
                                           + tuple(t.shape[3:]))
                out[f"{pn}/{k}"] = rows[:, :fed].clone()
    return out


def lane_delta(a: dict, b: dict) -> dict:
    """Max |a - b| per leaf and layer group of two ``slot_lanes``:
    ``"pos0/k[3]"`` is the K rows of group 3."""
    out = {}
    for k in a:
        d = (a[k].float() - b[k].float()).abs().reshape(a[k].shape[0], -1)
        for g in range(d.shape[0]):
            out[f"{k}[{g}]"] = float(d[g].max()) if d.shape[1] else 0.0
    return out


def rescore(torch, engine, lanes: dict, fed: int, width: float, tokens):
    """Logits (vocab,) after feeding ``tokens`` one at a time, from
    position ``fed``, to a one-slot cache holding ``lanes``: the engine's
    full-depth fused decode step at the slot's width."""
    from repro_torch.core import elastic
    from repro_torch.models.model import decode_step, init_decode_cache
    from repro_torch.models.paged import is_paged_key

    cfg = engine.cfg
    cache = init_decode_cache(cfg, 1, engine.cache_capacity, per_slot=True,
                              device=engine.device)
    for pn, layer in cache["stack"].items():
        for k, t in layer.items():
            lane = lanes[f"{pn}/{k}"]
            if is_paged_key(k):
                t[:, 0, :lane.shape[1]] = lane
            else:
                t[:, 0] = lane
    cache["pos"][0] = fed
    act = elastic.active_widths_batch(cfg, [width], device=engine.device)
    with torch.no_grad():
        for tok in tokens:
            lg, cache = decode_step(engine.params, cache,
                                    torch.tensor([[tok]],
                                                 device=engine.device),
                                    cfg, active=act, fused=engine.fused)
    return lg[0, -1, :cfg.vocab_size].float()


def near_ties(torch, engine, trace, ref, out, lanes,
               labels=("fault-free", "after failover"), step_floor=False):
    """For each request whose chaos stream parted from the fault-free one
    at generated index j (fault-free token a, chaos token b): rescore the
    position P that produced index j from each run's own cache of the
    request (``lanes``: "ref" / "chaos" -> rid -> its slot's lanes when it
    completed) cut to rows [0, P), both holding the same tokens, by
    feeding the token at P; it is a near tie when the fault-free cache's
    margin of a over b is at most twice the largest logit change between
    the two rescorings. With ``step_floor`` that change is taken as at
    least one bf16 step of the top logit: where the two runs computed
    position P itself through launches of other shapes (a verify of S = 5
    against one of S = 3, whose QKV plans its sums from the row count),
    the one-token rescoring reproduces neither's rounding, and identical
    cache rows give no change to measure. Returns the rows printed; fails
    on a divergence that is not a near tie, and on any in an SSM model
    (its recurrent state cannot be cut back to P)."""
    rows = []
    prompts = {r.rid: tuple(r.prompt) for r in trace}
    for rid, s in sorted(ref.items()):
        if out[rid] == s:
            continue
        j = next(k for k, (x, y) in enumerate(zip(s, out[rid])) if x != y)
        a, b = s[j], out[rid][j]
        full = prompts[rid] + s
        P = len(prompts[rid]) + j - 1  # the position whose logits gave j
        (_, width, src), (_, _, dst) = lanes["ref"][rid], lanes["chaos"][rid]
        if any(k.split("/")[-1] not in ("k", "v") for k in src):
            fail(f"request {rid} parted from the fault-free run at {j} in "
                 f"a model with recurrent state")
        cut = [{k: t[:, :P] for k, t in x.items()} for x in (src, dst)]
        ls, lr = (rescore(torch, engine, c, P, width, [full[P]])
                  for c in cut)
        top2 = torch.topk(ls, 2).values
        change = float((ls - lr).abs().max())
        margin = float(ls[a] - ls[b])
        step = (2.0 ** (math.floor(math.log2(abs(float(top2[0])))) - 7)
                if step_floor and float(top2[0]) != 0.0 else 0.0)
        row = dict(rid=rid, index=j, fault_free=a, chaos=b,
                   margin_a_over_b=margin,
                   top1_top2=float(top2[0] - top2[1]),
                   max_logit_change=change, bf16_step=step,
                   near_tie=margin <= 2 * max(change, step),
                   cache_rows_max_abs_delta=max(
                       lane_delta(cut[0], cut[1]).values()))
        rows.append(row)
        log(f"    rid {rid} parted at generated index {j} ({a} "
            f"{labels[0]}, {b} {labels[1]}): rescored at position {P} from "
            f"each "
            f"run's cache of it (rows differ by up to "
            f"{row['cache_rows_max_abs_delta']:.3e}), margin of {a} over "
            f"{b} {margin:.4f} (top-1 / top-2 {row['top1_top2']:.4f}), max "
            f"logit change {change:.4f}"
            + (f" (one bf16 step of the top logit: {step:.4f})"
               if step_floor else "") + ": "
            + ("a near tie" if row["near_tie"] else "NOT a near tie"))
        if not row["near_tie"]:
            fail(f"request {rid} parted from the {labels[0]} run at {j} "
                 f"with a margin {margin:.4f} above twice the logit change "
                 f"{max(change, step):.4f} between the two runs' caches")
    return rows


def failover_drive(torch, name, arch, overrides, spec_kind, page, n_req,
                   prompt_len, new_tokens, sites, device="cuda"):
    """One failover drive of ``FAILOVER_DRIVES``: two pre-warmed engines;
    the trace unsupervised on one, then under a counting supervisor on the
    other (the fault-free reference: streams, counters, launches per site);
    then, both engines reset from their clean snapshots, a chaos run
    ping-ponging them with one planned failure at each of ``sites``, at an
    occurrence the fault-free run reached. Launch counters are zeroed just
    before the chaos run and read just after it; the counts must equal the
    final engine's own (as for a fault-free run) plus what each replay and
    each interrupted tick launched, from the engines' replay calls and
    counters. Asserts every planned failure fired, the fault-free streams
    (or, in bf16, near ties: ``near_ties``) and counters, no request
    dropped or completed twice, and paged invariants; prints the recovery
    timings, the restored-vs-source cache |delta| per leaf and layer
    group, tokens/s unsupervised, supervised and chaos, the supervisor's
    snapshot time per tick, and peak memory. On the CPU (``device``) the
    wrappers count nothing and no launch is expected. Returns (launches,
    results)."""
    from repro_torch.configs import get_config
    from repro_torch.models.paged import PagedLayout
    from repro_torch.runtime.fault_tolerance import (ExecutorSupervisor,
                                                     FailurePlan)
    from repro_torch.runtime.serving import ServingEngine, poisson_trace

    cfg = get_config(arch)
    if "n_layers" in overrides:
        cfg = cfg.scaled(elastic=dataclasses.replace(
            cfg.elastic, exit_layers=(overrides["n_layers"] // 2,)))
    cfg = cfg.scaled(**overrides)
    t_all = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    params = init_on_card(torch, cfg, device)
    paged = PagedLayout(page_size=page) if page else None
    replays = []  # (kind, depth, C) per replay call, every engine
    # run tag -> rid -> (fed, width, its slot's lanes when it completed)
    lanes, tag = {}, ["unsupervised"]

    def build():
        eng = ServingEngine(params, cfg, batch_size=8, cache_capacity=512,
                            prefill_threshold=8, fused=True,
                            speculative=failover_spec(spec_kind),
                            paged=paged, device=device)
        eng.warmup()
        for meth, kind in (("_replay_launch", "decode"),
                           ("_replay_chunk", "chunk"),
                           ("_replay_prefill", "prefill")):
            def wrapped(g, *a, _f=getattr(eng, meth), _k=kind):
                C = a[0].shape[1] if _k == "chunk" else 1
                replays.append((_k, g.depth, C))
                return _f(g, *a)
            setattr(eng, meth, wrapped)
        complete = eng._complete

        def keep_lanes(g, slot, req, now_s):
            lanes.setdefault(tag[0], {})[req.rid] = (
                req.fed, g.widths[slot], slot_lanes(g, slot, req.fed))
            return complete(g, slot, req, now_s)

        eng._complete = keep_lanes
        return eng, eng.snapshot()

    t0 = time.perf_counter()
    (e0, clean0), (e1, clean1) = build(), build()
    t_warm = time.perf_counter() - t0
    trace = poisson_trace(n_req, 1e6, seed=5, prompt_len=prompt_len,
                          new_tokens=new_tokens, vocab=cfg.vocab_size,
                          interactive_frac=0.3)

    t0 = time.perf_counter()
    e1.run(copy.deepcopy(trace))
    sync(torch, device)
    wall_un = time.perf_counter() - t0
    un_streams = {r.rid: tuple(r.generated) for r in e1.completed}

    counter = FailurePlan()
    snap_s = []  # the supervisor's per-tick snapshot, timed
    snapshot0 = e0.snapshot

    def timed_snapshot():
        t = time.perf_counter()
        out = snapshot0()
        snap_s.append(time.perf_counter() - t)
        return out

    e0.snapshot = timed_snapshot
    tag[0] = "ref"
    t0 = time.perf_counter()
    sup = ExecutorSupervisor(lambda: e0, failure_plan=counter)
    sup.run_trace(copy.deepcopy(trace))
    sync(torch, device)
    wall_sup = time.perf_counter() - t0
    e0.snapshot = snapshot0
    ref = {r.rid: tuple(r.generated) for r in e0.completed}
    ref_counters = (e0.step_count, e0.decode_launches, e0.prefills,
                    e0.spec_verify_launches, e0.spec_generated_tokens)
    totals = dict(counter.site_counts)
    if sup.failovers or ref != un_streams:
        fail(f"{name}: the counting supervisor changed the run "
             f"({sup.failovers} failovers; streams equal to the "
             f"unsupervised run's: {ref == un_streams})")
    at = []
    for site in sites:
        if not totals.get(site):
            fail(f"{name}: the fault-free run never launched at {site!r}: "
                 f"{totals}")
        at.append((site, min(3, totals[site])))
    plan = FailurePlan(at_sites=tuple(at))

    # both engines back to a clean start (restore resets an engine fully)
    e0.restore(clean0)
    e1.restore(clean1)
    engines, idx = [e0, e1], [0]
    deltas, wasted = [], dict.fromkeys(KERNEL_NAMES, 0)

    class Chaos(ExecutorSupervisor):
        def _failover(self, snap, cause, detect_s):
            old = self.engine
            n_pre = old.prefills - snap.counters["prefills"]
            super()._failover(snap, cause, detect_s)
            # prefills the interrupted tick had already launched (its
            # admissions ran before the failing launch)
            _add(wasted, prefill_launches(cfg, old.admission_mode.depth),
                 n_pre * on_card)
            # one active depth group, and the failure came before its
            # launch: the failed engine's live slots hold the snapshot's
            # committed rows
            delta = {}
            for d, g in self.engine.groups.items():
                for i, r in enumerate(g.slots):
                    if r is None:
                        continue
                    src = slot_lanes(old.groups[d], i, r.fed)
                    dst = slot_lanes(g, i, r.fed)
                    for k, v in lane_delta(src, dst).items():
                        delta[k] = max(delta.get(k, 0.0), v)
            if delta:
                deltas.append(delta)

    def pingpong():
        idx[0] ^= 1
        return engines[idx[0]]

    replays.clear()
    tag[0] = "chaos"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    count_reset = counters()
    for _, reset in count_reset.values():
        reset()
    t0 = time.perf_counter()
    chaos = Chaos(pingpong, failure_plan=plan, max_failovers=len(at))
    summary = chaos.run_trace(copy.deepcopy(trace))
    sync(torch, device)
    wall_chaos = time.perf_counter() - t0
    run_launches = {n: count() for n, (count, _) in count_reset.items()}
    peak = (torch.cuda.max_memory_allocated() / 2**30 if on_card
            else float("nan"))
    eng = chaos.engine
    if on_card and cfg.dtype == "float32":
        check_routes_f32(f"failover {name}", run_launches)
    elif on_card:
        check_routes(f"failover {name}", run_launches)
    out = {r.rid: tuple(r.generated) for r in eng.completed}
    got_counters = (eng.step_count, eng.decode_launches, eng.prefills,
                    eng.spec_verify_launches, eng.spec_generated_tokens)
    if summary["failovers"] != len(at) or plan.fired_sites != set(at):
        fail(f"{name}: {summary['failovers']} failovers, fired "
             f"{sorted(plan.fired_sites)} of {at}")
    rids = [r.rid for r in eng.completed]
    if sorted(rids) != sorted(r.rid for r in trace) or eng.expired:
        fail(f"{name}: requests dropped or completed twice: {sorted(rids)}")
    eng.check_paged_invariants()
    diverged = {rid: next(j for j, (a, b) in enumerate(zip(out[rid], s))
                          if a != b)
                for rid, s in ref.items() if out[rid] != s}
    ties = near_ties(torch, eng, trace, ref, out, lanes) if diverged else []
    # a stream parted at a near tie accepts other drafts from there on, so
    # its ticks may differ; its prefills and its token count cannot
    exact = (0, 1, 2, 3, 4) if not diverged else (2,)
    if [got_counters[i] for i in exact] != [ref_counters[i] for i in exact] \
            or sum(map(len, out.values())) != sum(map(len, ref.values())):
        fail(f"{name}: counters (steps, decode launches, prefills, verify "
             f"launches, spec tokens) {got_counters} after the chaos run, "
             f"{ref_counters} fault-free")
    expect = (expected_launches if cfg.layer_kind(0) == "attn"
              else expected_launches_ssm)
    want, steps = expect(torch, eng, {m.name: 0 for m in eng.ctrl.modes},
                         True, device)
    n_single = n_chunk = n_pre = 0
    for kind, d, C in replays:
        if kind == "prefill":
            _add(want, prefill_launches(cfg, d), on_card)
            n_pre += 1
        else:
            _add(want, layer_launches(cfg, True, kind == "chunk"),
                 d * on_card)
            n_single += kind == "decode"
            n_chunk += kind == "chunk"
    _add(want, wasted)
    if run_launches != want:
        fail(f"{name}: chaos-run launches {run_launches}, expected {want} "
             f"(engine layer steps {steps}; replays: {n_single} one-token, "
             f"{n_chunk} chunks, {n_pre} prefills; interrupted ticks' "
             f"prefills {wasted})")
    fo = list(chaos.failover_log)
    gen = sum(len(s) for s in ref.values())
    res = dict(
        failovers=len(fo), sites=[list(a) for a in at],
        rebuild_ms=[e["rebuild_s"] * 1e3 for e in fo],
        replay_ms=[e["replay_s"] * 1e3 for e in fo],
        first_token_ms=[None if e["first_token_s"] is None
                        else e["first_token_s"] * 1e3 for e in fo],
        replay_launches=n_single + n_chunk, replay_chunk_launches=n_chunk,
        replay_prefills=n_pre,
        tokens_per_s_unsupervised=gen / wall_un,
        tokens_per_s_supervised=gen / wall_sup,
        tokens_per_s_chaos=gen / wall_chaos, peak_gib=peak,
        snapshot_ms_per_tick=sum(snap_s) / len(snap_s) * 1e3,
        supervised_ticks=len(snap_s),
        streams_identical=not diverged, diverged=diverged, near_ties=ties)
    if deltas:
        per_leaf = {k: max(d[k] for d in deltas) for k in deltas[0]}
        res["cache_max_abs_delta"] = max(per_leaf.values())
        kinds, first, zero, n_layers = {}, {}, {}, {}
        for k, v in per_leaf.items():
            leaf, g = k.split("/")[-1].rstrip("]").split("[")
            kinds[leaf] = max(kinds.get(leaf, 0.0), v)
            zero[leaf] = zero.get(leaf, 0) + (v == 0.0)
            n_layers[leaf] = n_layers.get(leaf, 0) + 1
            if g == "0":
                first[leaf] = max(first.get(leaf, 0.0), v)
        res.update(cache_max_abs_delta_by_leaf=kinds,
                   cache_first_layer_delta=first,
                   cache_bit_identical_layers=zero)
        log(f"    restored vs source cache on the live slots' committed "
            f"rows, {len(deltas)} failover(s): max |delta| by leaf "
            + ", ".join(f"{k} {v:.3e} (first layer group {first[k]:.3e}; "
                        f"{zero[k]} of {n_layers[k]} groups bit-identical)"
                        for k, v in kinds.items()))
    log(f"  failover {name} ({cfg.name}, {cfg.dtype}, fused, "
        f"{'paged ' + str(page) if page else 'dense'}, "
        f"{spec_kind} {TREE if spec_kind == 'tree' else FAILOVER_K}, "
        f"{n_req} requests, {gen} tokens): plan {at}, all fired; "
        f"{len(fo)} failovers: rebuild ms "
        + ", ".join(f"{x:.1f}" for x in res["rebuild_ms"]) + "; replay ms "
        + ", ".join(f"{x:.1f}" for x in res["replay_ms"])
        + "; first token after failover ms "
        + ", ".join("n/a" if x is None else f"{x:.1f}"
                    for x in res["first_token_ms"])
        + f"; replay: {n_single} one-token launches, {n_chunk} chunk "
        f"launches (C <= {REPLAY_C}), {n_pre} prompt prefills; tokens/s "
        f"unsupervised {res['tokens_per_s_unsupervised']:.1f}, supervised "
        f"fault-free {res['tokens_per_s_supervised']:.1f} (the snapshot "
        f"before each of its {len(snap_s)} ticks "
        f"{res['snapshot_ms_per_tick']:.3f} ms on the host), chaos "
        f"{res['tokens_per_s_chaos']:.1f}; counters {got_counters} ("
        f"fault-free {ref_counters}); peak {peak:.2f} GiB")
    log(f"    chaos-run launches " + ", ".join(
        f"{n} {c}" for n, c in run_launches.items() if c)
        + " (as expected: the engine's own steps, its replays and the "
        "interrupted ticks' prefills)")
    if diverged:
        log(f"    streams parted from the fault-free run in "
            f"{len(diverged)} of {len(ref)} requests, each a near tie "
            f"(above)")
    else:
        log(f"    every stream token-identical to the fault-free run "
            f"({len(ref)} requests)")
    log(f"    seconds: warmup of two engines {t_warm:.1f}, unsupervised "
        f"{wall_un:.1f}, supervised {wall_sup:.1f}, chaos {wall_chaos:.1f}, "
        f"drive {time.perf_counter() - t_all:.1f}")
    del e0, e1, engines, eng, chaos, sup, params
    # the engines sit in reference cycles (the wrapped methods above, the
    # supervisor class): collect them before the next drive's peak
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return run_launches, res


def failover_phase(torch, device="cuda"):
    """Phase 3's failover drives (``FAILOVER_DRIVES``). Fails on a stream
    that parted from the fault-free run in an f32 drive; in bf16 each
    parted stream must be a near tie (``near_ties``). Returns (launches
    per drive, results per drive)."""
    launches, results = {}, {}
    for spec in FAILOVER_DRIVES:
        name = spec[0]
        launches[name], results[name] = failover_drive(torch, *spec,
                                                       device=device)
        if "float32" in str(spec[2].get("dtype")) \
                and results[name]["diverged"]:
            fail(f"{name}: an f32 chaos run parted from the fault-free run")
    return launches, results


AUTOSCALE_ARCH = "tinyllama-1.1b"
AUTOSCALE_K = 2  # the draft length warmup builds
AUTOSCALE_CANDIDATE = 4  # the one the online MOGA may adopt
# The dwell (``AutoscaleConfig.cold_dispatches``) of the dense drives:
# with random weights a draft is accepted a few percent of the time, so a
# tick's acceptance window is often all zeros, and at a zero rate the
# policy keeps K = 2 (a longer draft gains nothing). With no dwell, a K = 4
# published at such a tick goes cold and retires at the next one, before
# any tick could take it; 32 dispatches (16 speculative ticks) give it
# that chance. The paged drive keeps none: its first retirement (a page
# bucket's 3 steps, the coldest unit) brings the table under its budget,
# so a published K = 4 stays live until a tick takes it, while a dwell
# would let the inactive depth's K = 2 (as cold, and first by name) go
# first instead of a bucket.
AUTOSCALE_DWELL = 32
# name, config overrides (``exit``: the 4-layer cut's draft exit), page
# size (0: dense), dwell, streams held strictly
AUTOSCALE_DRIVES = (
    ("autoscale_dense", {}, 0, AUTOSCALE_DWELL, False),
    ("autoscale_paged", {}, PAGE, 0, False),
    # an exit at 3 of 4 layers: acceptance ~6% (at 2, ~2%: the window
    # stays at zero too long)
    ("autoscale_f32_4layers", dict(dtype="float32", n_layers=4, exit=3), 0,
     AUTOSCALE_DWELL, True),
)


def autoscale_traces(cfg):
    """Two phases, as the reference's ``_two_phase_traces``: a burst of 8
    requests arriving at t = 0 (one per slot: all admitted at the first
    tick, the queue empty after it, so the first publication lands at an
    empty queue), prompts 16-128 (prefilled), 32-48 new tokens;
    then 6 sparse arrivals (30 / s, rids from 100), 16-32 new tokens, whose
    prompts alternate 80-112 tokens (prefilled) and 2-6 (fed token by
    token: the group steps plainly while one feeds, a paged plain tick at
    the table width the long ones need)."""
    import numpy as np

    from repro_torch.runtime.serving import poisson_trace

    t1 = poisson_trace(8, 1e6, seed=1, prompt_len=(16, 128),
                       new_tokens=(32, 48), vocab=cfg.vocab_size)
    for r in t1:
        r.arrival_s = 0.0
    t2 = poisson_trace(6, 30.0, seed=2, prompt_len=(2, 6),
                       new_tokens=(16, 32), vocab=cfg.vocab_size)
    rng = np.random.default_rng(3)
    for i, r in enumerate(t2):
        r.rid += 100
        if i % 2 == 0:
            n = int(rng.integers(80, 113))
            r.prompt = tuple(int(x) for x in rng.integers(1, cfg.vocab_size,
                                                          n))
    return t1, t2


def _pctl(xs, q):
    if not xs:
        return float("nan")
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] * 1e3


def _unit_label(unit):
    return ":".join(str(x) for x in unit)


def build_launches_expected(cfg, builds):
    """Kernel launches the autoscaler's builds' warm runs make, from the
    units built and the keys each returned: a linear (depth, K) unit runs
    its K-token draft at the draft depth (K fused decode layer-steps a
    draft layer) and its verify at the depth (one S = K + 1 fused verify a
    layer), each fused attention layer with its MLP's 3 ``morph_matmul``;
    a bucket unit one fused decode step per depth it built. Returns
    (counts per kernel, fused verify launches per S)."""
    n = dict.fromkeys(KERNEL_NAMES, 0)
    rows = {}
    for b in builds:
        unit = b["unit"]
        if unit[0] == "bucket":
            for key in b["keys"]:
                _add(n, layer_launches(cfg, True, False), key[1])
            continue
        _, depth, k = unit
        _add(n, layer_launches(cfg, True, False), k * b["draft_depth"])
        _add(n, layer_launches(cfg, True, True), depth)
        rows[k + 1] = rows.get(k + 1, 0) + depth * cfg.period
    return n, rows


def _run_ticks_timed(eng, trace, ticks, asc=None, policy=None):
    """``eng.run`` (with ``policy`` when given), every engine tick's host
    seconds appended to ``ticks["host"]`` and whether a unit of ``asc``
    was scheduled and not yet published at its start to
    ``ticks["in_flight"]``."""
    step = eng.step

    def timed(now_s=0.0):
        ticks["in_flight"].append(bool(asc is not None and asc._pending))
        t = time.perf_counter()
        dt = step(now_s=now_s)
        ticks["host"].append(time.perf_counter() - t)
        return dt

    eng.step = timed
    try:
        if policy is None:
            return eng.run(trace)
        return eng.run(trace, policy=policy, budget_fn=lambda t: 0.5)
    finally:
        del eng.step


def _tick_split(ticks):
    """(host seconds of the ticks with a build in flight, of the rest)."""
    busy = [t for t, f in zip(ticks["host"], ticks["in_flight"]) if f]
    idle = [t for t, f in zip(ticks["host"], ticks["in_flight"]) if not f]
    return busy, idle


def _instrument(asc, builds, gens):
    """Record each build (unit, seconds, thread, stream, keys, draft
    depth) and each MOGA generation's host seconds of ``asc``."""
    import threading

    build, gen = asc._build_unit, asc._run_generation

    def timed_build(unit, eng, stream=None):
        t = time.perf_counter()
        out = build(unit, eng, stream)
        dd = (eng.ctrl.spec_plan[unit[1]].draft_depth
              if unit[0] != "bucket" else 0)
        builds.append(dict(unit=unit, s=time.perf_counter() - t,
                           thread=threading.get_ident(),
                           stream=stream is not None, draft_depth=dd,
                           keys=[k for k, _, _ in out]))
        return out

    def timed_gen(*a):
        t = time.perf_counter()
        out = gen(*a)
        gens.append(time.perf_counter() - t)
        return out

    asc._build_unit, asc._run_generation = timed_build, timed_gen


def _await_builds(asc, timeout_s=300.0):
    """Wait for the background builder, publishing finished units on this
    thread as a serving tick would (over a mesh, on every rank at once)."""
    if not asc.await_builds(timeout_s):
        fail(f"autoscaler builds {sorted(asc._pending)} never finished")


def _expected_now(torch, eng, device):
    """``expected_launches`` of ``eng`` from its counters as they stand
    (taken before and after a run: the difference is the run's)."""
    expect = (expected_launches if eng.cfg.layer_kind(0) == "attn"
              else expected_launches_ssm)
    return expect(torch, eng, {m.name: 0 for m in eng.ctrl.modes}, True,
                  device)


def _autoscale_checks(torch, what, cfg, eng, asc, budget, compiles0,
                      before, spec0, run_launches, builds, bind_builds=()):
    """The checks every autoscaled run must pass (see ``autoscale_drive``):
    ``before`` is ``_expected_now`` and ``spec0`` the launches per
    speculative path as the run began; ``builds`` ran on the worker,
    ``bind_builds`` (a standby's re-publication) on this thread. Returns
    (launches expected of the builds, S = K + 1 verify launches on the
    serving thread)."""
    import threading

    from repro_torch.kernels import fused_decode as FD

    st = asc.stats
    device = eng.device
    on_card = device.type == "cuda"
    if st["tick_stalls"] or st["dropped"]:
        fail(f"{what}: {st['tick_stalls']} stalled ticks, {st['dropped']} "
             f"dropped builds: {st}")
    if eng.ctrl.compile_table_size > budget:
        fail(f"{what}: table {eng.ctrl.compile_table_size} over its budget "
             f"{budget}")
    if eng.ctrl.stats["compiles"] != compiles0 + st["published_keys"]:
        fail(f"{what}: {eng.ctrl.stats['compiles']} steps built, "
             f"{compiles0} at warmup + {st['published_keys']} published")
    main = threading.get_ident()
    if main in asc.worker_idents or any(
            b["thread"] == main or b["stream"] != on_card for b in builds):
        fail(f"{what}: a background build ran on the serving thread, or "
             f"off the worker's stream")
    after, steps = _expected_now(torch, eng, device)
    want = {k: after[k] - before[k] for k in after}
    if run_launches != want:
        fail(f"{what}: serving launches {run_launches}, expected {want} "
             f"(layer steps {steps})")
    k1 = AUTOSCALE_CANDIDATE + 1
    s5 = sum((t.launches - spec0.get(key, 0)) * key[0] * cfg.period
             for key, t in eng.spec_telemetry.items()
             if key[2] == AUTOSCALE_CANDIDATE)
    rows = FD.verify_launches_by_rows()
    if on_card and rows.get(k1, 0) != s5:
        fail(f"{what}: fused_verify at S = {k1} on the serving thread "
             f"{rows.get(k1, 0)} times, the K = {AUTOSCALE_CANDIDATE} "
             f"ticks ask {s5}")
    if not s5:
        fail(f"{what}: the adopted K = {AUTOSCALE_CANDIDATE} never ran on "
             f"the serving thread after its publication: acceptance "
             f"(launches, accepted, drafted) per path " + str(
                 {k: (t.launches, t.accepted, t.drafted)
                  for k, t in eng.spec_telemetry.items()})
             + f"; events " + str([
                 (e["event"], e["unit"], e["step"]) for e in
                 eng.metrics.events("autoscale_events", (
                     "step", "event", "unit", "generation", "detail"))
                 if e["event"] != "generation"]))
    want_b, want_rows = build_launches_expected(
        cfg, list(bind_builds) + list(builds))
    got_b = {k: asc.build_launches.get(k, {}).get("n", 0)
             for k in KERNEL_NAMES if k != "ssd_scan_bwd"}
    got_rows = {s_: n for s_, n in
                asc.build_launches.get("fused_verify_rows", {}).items() if n}
    if on_card and (got_b != {k: want_b[k] for k in got_b}
                    or got_rows != want_rows):
        fail(f"{what}: build launches {got_b} (verify rows {got_rows}), "
             f"expected {want_b} ({want_rows}) for the units "
             f"{[_unit_label(b['unit']) for b in builds]}")
    return want_b, s5


def autoscale_drive(torch, name, cfg, params, page, dwell, strict,
                    standby=False, device="cuda", executor=None):
    """One drive of the online autoscaler (``runtime.autoscale``) on
    ``cfg``: fused, greedy, 8 slots, capacity 512, prefill threshold 8,
    ``SpecConfig(ks=(2,), min_accept_rate=0.0)``, a block-paged cache when
    ``page``. A fixed-mode baseline (no autoscaler) serves
    ``autoscale_traces``' two phases; then an autoscaled engine
    (``table_budget`` = its warmup's builds + 1, candidate K = 4, interval
    1, population 8, 2 generations, seed 0, ``dwell`` dispatches; the
    admission mode pinned)
    serves them, the background builds awaited (and published on this
    thread) between the phases. Kernel counters are zeroed before the
    autoscaled run and read after it: they hold the serving thread's
    launches, exactly as the engine's counters ask; the builds' warm
    launches, counted apart by the autoscaler, exactly as the built units
    ask. Asserts a publication, a retirement, K = 4 in the published or
    retired units, the fused verify at S = 5 on the serving thread, the
    table within its budget, every build after warmup published
    (``compiles == compiles0 + published_keys``), no stalled tick, no
    dropped build, no build on the serving thread; paged: a bucket
    retired and plain launches rounded up to a live bucket. Streams equal
    the baseline's (``strict``) or part only at near ties (``near_ties``,
    its change floored at one bf16 step: the parting position's logits
    come from verify launches of other shapes in the two runs).
    With ``standby``, a pre-warmed engine with no autoscaler restores the
    snapshot cut at the phase boundary, an autoscaler binds it
    (re-publishing K = 4 synchronously) and it serves the second phase
    under the same checks; its state must equal the snapshot's. Prints
    generations, publications, retirements, front and table sizes, each
    build's seconds, the generations' host ms, the serving ticks' host ms
    p50 / p95 with a build in flight and without one, and peak memory.
    ``executor`` (a factory) serves every engine through it: a mesh
    rank's ``MeshExecutor`` runs the same drive on every rank.
    Returns (launches per run, results)."""
    from repro_torch.models.paged import PagedLayout
    from repro_torch.runtime.autoscale import (AutoscaleConfig,
                                               AutoscalePolicy, Autoscaler)
    from repro_torch.runtime.serving import ServingEngine
    from repro_torch.runtime.speculative import SpecConfig

    t_all = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    layout = PagedLayout(page_size=page) if page else None
    lanes, tag = {}, ["ref"]

    def build():
        eng = ServingEngine(params, cfg, batch_size=8, cache_capacity=512,
                            prefill_threshold=8, fused=True,
                            speculative=SpecConfig(ks=(AUTOSCALE_K,),
                                                   min_accept_rate=0.0),
                            paged=layout, device=device,
                            executor=executor() if executor else None)
        eng.warmup()
        complete = eng._complete

        def keep_lanes(g, slot, req, now_s):
            lanes.setdefault(tag[0], {})[req.rid] = (
                req.fed, g.widths[slot], slot_lanes(g, slot, req.fed))
            return complete(g, slot, req, now_s)

        eng._complete = keep_lanes
        return eng

    def scaler():
        return Autoscaler(AutoscaleConfig(
            interval_ticks=1, table_budget=budget,
            spec_ks=(AUTOSCALE_CANDIDATE,), pop_size=8, generations=2,
            seed=0, cold_dispatches=dwell))

    def streams(eng):
        return {r.rid: tuple(r.generated) for r in eng.completed}

    t1, t2 = autoscale_traces(cfg)
    trace = t1 + t2
    base = build()
    base.set_admission_mode(base.ctrl.modes[-1])
    base_ticks = {"host": [], "in_flight": []}
    t0 = time.perf_counter()
    _run_ticks_timed(base, copy.deepcopy(t1), base_ticks)
    _run_ticks_timed(base, copy.deepcopy(t2), base_ticks)
    sync(torch, device)
    wall_base = time.perf_counter() - t0
    ref = streams(base)
    del base

    tag[0] = "chaos"
    eng = build()
    pinned = eng.ctrl.modes[-1]
    budget = eng.compiles_after_warmup + 1
    asc = scaler()
    builds, gens, ticks = [], [], {"host": [], "in_flight": []}
    _instrument(asc, builds, gens)
    asc.bind(eng)
    policy = AutoscalePolicy(cfg, eng.ctrl, autoscaler=asc, batch_size=8,
                             cache_capacity=512, metrics=eng.metrics,
                             executor=eng.executor)
    rounded = []  # (needed pages, the ladder's bucket, the live one)
    if layout is not None:
        bucket_for = eng._bucket_for

        def counted_bucket_for(needed):
            got = bucket_for(needed)
            rounded.append((needed, min(b for b in eng._buckets
                                        if b >= needed), got))
            return got

        eng._bucket_for = counted_bucket_for
    compiles0 = eng.ctrl.stats["compiles"]
    before, _ = _expected_now(torch, eng, device)
    count_reset = counters()
    for _, reset in count_reset.values():
        reset()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _run_ticks_timed(eng, copy.deepcopy(t1), ticks, asc, policy)
    published_phase1 = asc.stats["published"]
    _await_builds(asc)
    snap = eng.snapshot() if standby else None
    _run_ticks_timed(eng, copy.deepcopy(t2), ticks, asc, policy)
    sync(torch, device)
    wall = time.perf_counter() - t0
    run_launches = {n: count() for n, (count, _) in count_reset.items()}
    peak = (torch.cuda.max_memory_allocated() / 2**30 if on_card
            else float("nan"))
    if on_card and cfg.dtype == "float32":
        check_routes_f32(name, run_launches)
    elif on_card:
        check_routes(name, run_launches)
    st = dict(asc.stats)
    units = asc._published_units + asc._retired_units
    if not st["published"] or not st["retired"] or \
            ("spec_k", pinned.depth, AUTOSCALE_CANDIDATE) not in units:
        fail(f"{name}: no adoption of K = {AUTOSCALE_CANDIDATE} at depth "
             f"{pinned.depth} and retirement: {st}, published "
             f"{asc._published_units}, retired {asc._retired_units}")
    want_b, s5 = _autoscale_checks(torch, name, cfg, eng, asc, budget,
                                   compiles0, before, {}, run_launches,
                                   builds)
    if layout is not None:
        eng.check_paged_invariants()
        up = [r for r in rounded if r[2] > r[1]]
        if not any(u[0] == "bucket" for u in asc._retired_units) or not up:
            fail(f"{name}: retired {asc._retired_units}; plain paged "
                 f"launches rounded up to a live bucket: {len(up)}")
    out = streams(eng)
    if sorted(out) != sorted(r.rid for r in trace):
        fail(f"{name}: requests dropped or completed twice")
    diverged = {rid: next(j for j, (a, b) in enumerate(zip(out[rid], s))
                          if a != b)
                for rid, s in ref.items() if out[rid] != s}
    if diverged and strict:
        fail(f"{name}: streams parted from the fixed-mode run in an f32 "
             f"drive: {diverged}")
    labels = ("fixed-mode", "autoscaled")
    ties = (near_ties(torch, eng, trace, ref, out, lanes, labels,
                      step_floor=True) if diverged else [])
    gen = sum(len(s) for s in ref.values())
    busy, idle = _tick_split(ticks)
    # the ticks a build overlapped come first; the fixed-mode run's ticks
    # of the same index served the same slots (nothing adopted yet)
    paired = [i for i, f in enumerate(ticks["in_flight"]) if f]
    res = dict(
        generations=st["generations"], published=st["published"],
        published_in_phase1=published_phase1,
        published_keys=st["published_keys"], retired=st["retired"],
        published_units=[_unit_label(u) for u in asc._published_units],
        retired_units=[_unit_label(u) for u in asc._retired_units],
        front=len(asc.front), table=eng.ctrl.compile_table_size,
        budget=budget, tick_stalls=st["tick_stalls"], dropped=st["dropped"],
        builds=[dict(unit=_unit_label(b["unit"]), s=b["s"],
                     keys=len(b["keys"])) for b in builds],
        generation_ms_p50=_pctl(gens, 0.5), generation_ms_p95=_pctl(gens, 0.95),
        tick_ms_in_flight=[_pctl(busy, q) for q in (0.5, 0.95)],
        ticks_in_flight=len(busy),
        tick_ms_idle=[_pctl(idle, q) for q in (0.5, 0.95)],
        ticks_idle=len(idle),
        tick_ms_in_flight_each=[ticks["host"][i] * 1e3 for i in paired],
        tick_ms_fixed_same_index=[base_ticks["host"][i] * 1e3
                                  for i in paired
                                  if i < len(base_ticks["host"])],
        tick_ms_fixed=[_pctl(base_ticks["host"], q) for q in (0.5, 0.95)],
        verify_s5_serving=s5, build_launches=want_b,
        tokens_per_s_fixed=gen / wall_base, tokens_per_s_autoscaled=gen / wall,
        peak_gib=peak, streams_identical=not diverged, diverged=diverged,
        near_ties=ties, run_launches=run_launches,
        events=[[e["step"], e["event"], e["unit"]] for e in
                eng.metrics.events("autoscale_events", (
                    "step", "event", "unit", "generation", "detail"))
                if e["event"] != "generation"])
    if layout is not None:
        res["rounded_up_launches"] = len([r for r in rounded if r[2] > r[1]])
        res["live_buckets"] = sorted(eng._avail_buckets)
    log(f"  {name} ({cfg.name}, {cfg.dtype}, depth {pinned.depth}, fused, "
        f"{'paged ' + str(page) if page else 'dense'}, K = {AUTOSCALE_K} "
        f"warmed, candidate K = {AUTOSCALE_CANDIDATE}, {len(trace)} "
        f"requests, {gen} tokens): {st['generations']} generations, "
        f"published {res['published_units']} ({st['published']}; "
        f"{published_phase1} in the burst), retired {res['retired_units']}, "
        f"front {len(asc.front)}, table {res['table']} (budget {budget}), "
        f"stalls 0, dropped 0")
    log("    background builds (s, on the worker's stream): " + ", ".join(
        f"{b['unit']} {b['s']:.3f}" for b in res["builds"])
        + f"; MOGA generation host ms p50 {res['generation_ms_p50']:.3f} "
        f"p95 {res['generation_ms_p95']:.3f}; serving tick host ms p50 / "
        f"p95 with a build in flight {res['tick_ms_in_flight'][0]:.3f} / "
        f"{res['tick_ms_in_flight'][1]:.3f} ({len(busy)} ticks: "
        + ", ".join(f"{x:.1f}" for x in res["tick_ms_in_flight_each"])
        + "; the fixed-mode run's same ticks "
        + ", ".join(f"{x:.1f}" for x in res["tick_ms_fixed_same_index"])
        + f"), without {res['tick_ms_idle'][0]:.3f} / "
        f"{res['tick_ms_idle'][1]:.3f} ({len(idle)} ticks); fixed-mode run "
        f"{res['tick_ms_fixed'][0]:.3f} / {res['tick_ms_fixed'][1]:.3f}; "
        f"fused_verify at S = {AUTOSCALE_CANDIDATE + 1} on the serving "
        f"thread {s5}; tokens/s fixed-mode {res['tokens_per_s_fixed']:.1f}, "
        f"autoscaled {res['tokens_per_s_autoscaled']:.1f}; peak "
        f"{peak:.2f} GiB"
        + (f"; {res['rounded_up_launches']} plain paged launches rounded "
           f"up to a live bucket (live {res['live_buckets']})"
           if layout is not None else ""))
    log(f"    serving launches " + ", ".join(
        f"{n} {c}" for n, c in run_launches.items() if c)
        + "; the builds' warm launches, apart: " + ", ".join(
        f"{n} {c}" for n, c in want_b.items() if c) + " (both as expected)")
    log(f"    streams: " + (f"parted from the fixed-mode run in "
                            f"{len(diverged)} of {len(ref)} requests, each "
                            f"a near tie (above)" if diverged else
                            f"all {len(ref)} token-identical to the "
                            f"fixed-mode run"))
    launches = {name: run_launches}
    if standby:
        launches[name + "_standby"], res["standby"] = _standby_run(
            torch, name, cfg, build, scaler, snap, budget, t2, trace, ref,
            lanes, tag, device)
    asc.close()
    log(f"    seconds: drive {time.perf_counter() - t_all:.1f}")
    del eng, asc, policy
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return launches, res


def _standby_run(torch, name, cfg, build, scaler, snap, budget, t2, trace,
                 ref, lanes, tag, device):
    """Drive 3 of the autoscale phase: a pre-warmed standby with no
    autoscaler restores ``snap`` (cut at the phase boundary), holds its
    autoscaler state until one binds, which re-publishes the adopted units
    synchronously (its build on this thread, counted apart); it then
    serves the second phase under ``_autoscale_checks``."""
    from repro_torch.runtime.autoscale import AutoscalePolicy

    what = name + "_standby"
    tag[0] = "standby"
    sb = build()
    warm = sb.ctrl.stats["compiles"]
    sb.restore(snap)
    if sb._pending_autoscale != snap.autoscale:
        fail(f"{what}: the bare standby did not hold the snapshot's "
             f"autoscaler state")
    asc = scaler()
    builds, gens, ticks = [], [], {"host": [], "in_flight": []}
    _instrument(asc, builds, gens)
    t0 = time.perf_counter()
    asc.bind(sb)
    bind_s = time.perf_counter() - t0
    pinned = sb.ctrl.modes[-1]
    if sb._pending_autoscale is not None or \
            AUTOSCALE_CANDIDATE not in sb.ctrl.spec_plan[pinned.depth].ks:
        fail(f"{what}: bind did not re-publish K = {AUTOSCALE_CANDIDATE}")
    if sb.ctrl.stats["compiles"] != warm + asc.stats["published_keys"]:
        fail(f"{what}: {sb.ctrl.stats['compiles']} built, {warm} at warmup "
             f"+ {asc.stats['published_keys']} re-published")
    got = asc.state_dict()
    for key in ("generation", "front", "published", "retired",
                "active_spec", "avail_buckets"):
        if got[key] != snap.autoscale[key]:
            fail(f"{what}: state {key} {got[key]} after bind, "
                 f"{snap.autoscale[key]} in the snapshot")
    bind_builds = list(builds)
    del builds[:]
    republished = [_unit_label(b["unit"]) for b in bind_builds]
    policy = AutoscalePolicy(cfg, sb.ctrl, autoscaler=asc, batch_size=8,
                             cache_capacity=512, metrics=sb.metrics)
    before, _ = _expected_now(torch, sb, device)
    spec0 = {k: t.launches for k, t in sb.spec_telemetry.items()}
    count_reset = counters()
    for _, reset in count_reset.values():
        reset()
    _run_ticks_timed(sb, copy.deepcopy(t2), ticks, asc, policy)
    sync(torch, device)
    run_launches = {n: count() for n, (count, _) in count_reset.items()}
    if torch.device(device).type == "cuda":
        check_routes(what, run_launches)
    want_b, s5 = _autoscale_checks(torch, what, cfg, sb, asc, budget, warm,
                                   before, spec0, run_launches, builds,
                                   bind_builds)
    out = {r.rid: tuple(r.generated) for r in sb.completed}
    if sorted(out) != sorted(r.rid for r in trace):
        fail(f"{what}: requests dropped or completed twice")
    diverged = {rid: next(j for j, (a, b) in enumerate(zip(out[rid], s))
                          if a != b)
                for rid, s in ref.items() if out[rid] != s}
    both = {"ref": lanes["ref"], "chaos": {**lanes["chaos"],
                                           **lanes.get("standby", {})}}
    ties = (near_ties(torch, sb, trace, ref, out, both,
                      ("fixed-mode", "standby"), step_floor=True)
            if diverged else [])
    res = dict(bind_s=bind_s, republished=republished,
               republished_keys=asc.stats["published_keys"],
               published=asc.stats["published"],
               retired=asc.stats["retired"],
               table=sb.ctrl.compile_table_size, verify_s5_serving=s5,
               build_launches=want_b, streams_identical=not diverged,
               diverged=diverged, near_ties=ties)
    log(f"  {what}: a bare pre-warmed standby restored the snapshot cut "
        f"at the phase boundary; bind re-published {republished} "
        f"({asc.stats['published_keys']} steps) on this thread in "
        f"{bind_s:.3f} s; generation {got['generation']}, front, "
        f"published, retired, active shapes and buckets equal to the "
        f"source's; the second phase served: fused_verify at S = "
        f"{AUTOSCALE_CANDIDATE + 1} {s5}, table {res['table']}, streams "
        + (f"parted in {len(diverged)} requests, each a near tie"
           if diverged else "token-identical to the fixed-mode run"))
    log(f"    serving launches " + ", ".join(
        f"{n} {c}" for n, c in run_launches.items() if c)
        + " (as expected)")
    asc.close()
    del sb
    return run_launches, res


def autoscale_phase(torch, device="cuda"):
    """Phase 3's autoscale drives (``AUTOSCALE_DRIVES``): full-width,
    full-depth TinyLlama-1.1B (f32 masters, bf16 activations) dense, with
    the standby drive on its snapshot, and paged (page 16); then cut to 4
    layers (an exit at 3) in f32, streams held strictly. Returns
    (launches per run, results per drive)."""
    from repro_torch.configs import get_config

    launches, results = {}, {}
    params = None
    for name, overrides, page, dwell, strict in AUTOSCALE_DRIVES:
        cfg = get_config(AUTOSCALE_ARCH)
        overrides = dict(overrides)
        if "exit" in overrides:
            cfg = cfg.scaled(elastic=dataclasses.replace(
                cfg.elastic, exit_layers=(overrides.pop("exit"),)))
        cfg = cfg.scaled(**overrides)
        if overrides or params is None:
            params = None  # the last drive's, freed before the next's
            gc.collect()
            params = init_on_card(torch, cfg, device)
        runs, results[name] = autoscale_drive(
            torch, name, cfg, params, page, dwell, strict,
            standby=name == "autoscale_dense", device=device)
        launches.update(runs)
        if overrides:
            params = None
    del params
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return launches, results


def restart_drive(torch, cfg, n_steps=4, every=2, fail_at=3):
    """Phase 4's restart drive (PR 23): full-width ``cfg`` (cut to 24 layers
    since PR 26)
    (B = 8, S = 256, AdamW lr 2e-3) for ``n_steps`` steps through
    ``TrainRunner`` with a checkpoint every ``every`` steps and a failure
    injected before step ``fail_at``; ``run_with_restarts`` resumes from
    the latest checkpoint. Its parameters and both moments must come out
    bit-identical to an uninterrupted run of the same steps. Prints save
    and restore seconds and bytes; the checkpoints go to a temporary
    directory, removed afterwards. The scans' counts are exact: 1 forward
    and 1 backward ``ssd_scan`` per SSM layer of every step run. Returns
    (launches, results)."""
    import shutil
    import tempfile

    from repro_torch.checkpoint.checkpointing import leaves_with_path
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime.fault_tolerance import FailurePlan, TrainRunner

    ocfg = OptimizerConfig(lr=2e-3)
    dc = DataConfig(seed=0, global_batch=8, seq_len=256)

    def init():
        return init_train_state(cfg, ocfg, seed=0, device="cuda")

    def flat(state):
        return {k: t.detach().clone() for k, t in leaves_with_path(state)}

    count_reset = counters()
    for _, reset in count_reset.values():
        reset()
    step = make_train_step(cfg, ocfg, remat="none")
    state = init()
    for i in range(n_steps):
        state, _ = step(state, make_batch(cfg, dc, i))
    sync(torch, "cuda")
    want = flat(state)
    del state
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        runner = TrainRunner(cfg, make_train_step(cfg, ocfg, remat="none"),
                             init, dc, tmp, ckpt_every=every, keep=1,
                             failure_plan=FailurePlan(at_steps=(fail_at,)))
        saves, restores = [], []
        save0, restore0 = runner.mgr.save, runner.mgr.restore

        def timed_save(*a, **k):
            t0 = time.perf_counter()
            out = save0(*a, **k)
            saves.append(time.perf_counter() - t0)
            return out

        def timed_restore(*a, **k):
            t0 = time.perf_counter()
            out = restore0(*a, **k)
            sync(torch, "cuda")
            restores.append(time.perf_counter() - t0)
            return out

        runner.mgr.save, runner.mgr.restore = timed_save, timed_restore
        t0 = time.perf_counter()
        got_state = runner.run_with_restarts(n_steps)
        sync(torch, "cuda")
        wall = time.perf_counter() - t0
        d = os.path.join(tmp, f"step_{n_steps:08d}")
        disk = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {n: count() for n, (count, _) in count_reset.items()}
    got = flat(got_state)
    nbytes = sum(t.numel() * t.element_size() for t in got.values())
    del got_state
    differ = [k for k in want if not torch.equal(want[k], got[k])]
    if want.keys() != got.keys() or differ:
        fail(f"{cfg.name} restart drive: {len(differ)} of {len(want)} "
             f"tensors differ from the uninterrupted run, first {differ[:4]}")
    ran = [m["step"] for m in runner.metrics_log]
    scans = cfg.n_layers * (n_steps + len(ran))
    expect = dict.fromkeys(KERNEL_NAMES, 0)
    expect.update(ssd_scan=scans, ssd_scan_bwd=scans)
    if launches != expect or not saves or not restores:
        fail(f"{cfg.name} restart drive: launches {launches}, expected "
             f"{expect}; {len(saves)} saves, {len(restores)} restores")
    res = dict(steps_run=ran, save_s=saves, restore_s=restores,
               checkpoint_bytes=nbytes, checkpoint_disk_bytes=disk,
               wall_s=wall)
    log(f"  {cfg.name} restart drive: {n_steps} steps, a checkpoint every "
        f"{every}, failure before step {fail_at}; steps run {ran}; all "
        f"{len(want)} parameter and moment tensors bit-identical to the "
        f"uninterrupted run; {len(saves)} saves of {nbytes / 1e9:.3f} GB "
        f"({disk / 1e9:.3f} GB on disk) in "
        + ", ".join(f"{s:.2f}" for s in saves) + " s; restore "
        + ", ".join(f"{s:.2f}" for s in restores)
        + f" s; {wall:.1f} s in all; scans {launches['ssd_scan']} forward, "
        f"{launches['ssd_scan_bwd']} backward (as expected)")
    del want, got
    torch.cuda.empty_cache()
    return launches, res


MESH_TP = 2  # two ranks sharing the one card
# the mesh drives' device ("cpu" rehearses them with the smoke configs)
MESH_DEVICE = "cuda"
# a bf16 parting's largest logit change between the mesh and local
# rescorings may be at most this many bf16 steps of the top logit (the
# tp = 2 drives measured up to 0.067 at a top logit in [2, 4), about 4
# steps; a wrong shard or a missing collective moves logits by their size)
MESH_MAX_CHANGE_STEPS = 16
# name, arch, config overrides, speculative (K or 0), requests, new tokens,
# streams held strictly (f32) or by near ties (bf16)
MESH_DRIVES = (
    # TinyLlama's bf16 drives at 6 of its 22 layers and Mamba2's at 6 of
    # its 48: the run's time
    ("tinyllama_tp2", "tinyllama-1.1b", dict(n_layers=6), 0, 8, (16, 32),
     False),
    ("tinyllama_tp2_k2", "tinyllama-1.1b", dict(n_layers=6), 2, 8, (8, 16),
     False),
    ("tinyllama_tp2_f32_4layers", "tinyllama-1.1b",
     dict(dtype="float32", n_layers=4), 2, 8, (16, 32), True),
    ("mamba2_tp2_6layers", "mamba2-370m", dict(n_layers=6), 0, 4, (8, 16),
     False),
    ("mamba2_tp2_f32_4layers", "mamba2-370m",
     dict(dtype="float32", n_layers=4), 0, 4, (8, 16), True),
    # the encoder-decoder, frontend and MoE families at full width
    # (internvl at 6 of its 24 layers, granite at 12 of 24: the run's
    # time); granite (16 of its 32 experts a rank) in f32: in
    # bf16 a
    # rank's rounding moves the router's top-8 choice at near ties, and a
    # moved expert changes its token's logits by more than the near-tie cap
    # (a parting's change of 0.091 over a cap of 0.063 on an H100)
    ("whisper_tp2", "whisper-base", {}, 0, 8, (8, 16), False),
    ("internvl_tp2", "internvl2-2b", dict(n_layers=6), 0, 8, (8, 16),
     False),
    ("granite_tp2_f32", "granite-moe-1b-a400m",
     dict(dtype="float32", n_layers=12), 0, 8, (8, 16), True),
    ("granite_tp2_f32_k2", "granite-moe-1b-a400m",
     dict(dtype="float32", n_layers=12), 2, 8, (4, 8), True),
)
# the model-level drives of the encoder-decoder and frontend families at
# tp = 2, in f32 (held to the local drive's logits to MESH_F32_ATOL): a
# prompt pass with frames or patches under attn_impl="chunked" (B6), then
# fused decode steps (whisper's cross-attention on B5)
MESH_MODEL_DRIVES = (("whisper_model_tp2", "whisper-base", 4, 8),
                     ("internvl_model_tp2", "internvl2-2b", 64, 4))
MESH_F32_ATOL = 1e-3
# serve_2d at (2, 1): TinyLlama at full width, 4 layers, f32, every prompt
# prefilled; each step call gathers 0.62 GB a rank through the host
# (gloo), ~2 s (PR 26, call 3): 4 requests of 2-4 new tokens
SERVE_2D_DRIVE = ("tinyllama_serve2d_dp2", "tinyllama-1.1b",
                  dict(dtype="float32", n_layers=4), 4, (2, 4))


def check_shard_shapes(torch, cfg, timer, tp=MESH_TP):
    """B1, B2 and B3 (linear S = 5) at the shapes a tp = ``tp`` rank of
    TinyLlama gives them (``sharding.plan_serve_shard``: 32 / 4 heads of 64
    over 2 ranks is 16 / 2 per rank, the MLP's 5632 columns 2816, the
    attention ``wo`` and MLP ``down`` contractions 1024 and 2816 rows),
    with rank 0's localized width gates (``tensor_parallel.localize`` of
    widths {0.25, 0.5, 1.0}: a global width past the rank's half clamps to
    its whole half). Each against its plain version, timed beside its
    bound and the library call as the full-shape rows are."""
    from repro_torch.core import elastic
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.tensor_parallel import localize

    sh = SH.plan_serve_shard(cfg, {"data": 1, "model": tp}, n_slots=8,
                             coord={"data": 0, "model": 0})
    widths = [0.25, 0.5, 1.0, 0.25, 0.5, 1.0, 0.5, 0.25]
    act = localize(elastic.active_widths_batch(cfg, widths, device="cuda"),
                   sh)
    log(f"  rank 0 of tp = {tp}: {sh.cfg.n_heads} / {sh.cfg.n_kv_heads} "
        f"heads of {sh.cfg.head_dim}, d_ff {sh.cfg.d_ff}; local gates "
        + json.dumps({k: v.tolist() for k, v in act.items()}))
    return dict(morph_matmul=check_morph_matmul(torch, sh.cfg, timer, act),
                fused_decode=check_fused_decode(torch, sh.cfg, timer, act),
                fused_verify=check_fused_verify(torch, sh.cfg, timer, act))


def check_family_shard_shapes(torch, timer, tp=MESH_TP):
    """The kernels at the shapes a tp = ``tp`` rank of the MoE,
    encoder-decoder and frontend families gives them (rank 0's shard,
    ``layer_config``): ``morph_matmul`` over one internvl decoder layer;
    ``fused_decode`` at granite's (8 / 4 heads of 64),
    whisper's (4 / 4 of 64) and internvl's (8 / 4 of 128) attention and
    ``fused_verify`` (S = 5) at granite's; ``flash_decode`` at whisper's
    cross-attention (32 KV rows x 1500, bf16 queries); ``flash_attention``
    at whisper's encoder and internvl's chunked prompt pass. Each
    against its plain version, timed beside its bound and the library
    call where the full-shape checks time one."""
    return dict(
        morph_matmul=check_morph_matmul_frontend(torch, timer, shard_tp=tp,
                                                 archs=(VLM_ARCH,)),
        granite=check_fused_attention_shapes(
            torch, timer, archs=("granite-moe-1b-a400m",),
            whats=("decode", "verify linear"), shard_tp=tp),
        frontend=check_fused_attention_shapes(
            torch, timer, archs=FRONTEND_ARCHS, whats=("decode",),
            shard_tp=tp),
        flash_decode=check_cross_decode(torch, timer, shard_tp=tp,
                                        qdts=("bfloat16",)),
        flash_attention=check_flash_attention_shards(torch, timer, tp))


def shard_row(res):
    return {k: res[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "library_ms") if k in res}


def depth_cut(cfg, n_layers, exits):
    """``cfg`` cut to ``n_layers`` layers with its exits at ``exits``."""
    return cfg.scaled(n_layers=n_layers, elastic=dataclasses.replace(
        cfg.elastic, exit_layers=tuple(exits)))


def mesh_config(arch, overrides):
    from repro_torch.configs import get_config, smoke_config

    cfg = (get_config(arch) if MESH_DEVICE == "cuda"
           else smoke_config(arch))
    if "n_layers" in overrides:
        cfg = cfg.scaled(elastic=dataclasses.replace(
            cfg.elastic, exit_layers=(overrides["n_layers"] // 2,)))
    return cfg.scaled(**overrides)


def mesh_engine(cfg, params, executor, spec_k, threshold=8, batch=8):
    from repro_torch.runtime.serving import ServingEngine
    from repro_torch.runtime.speculative import SpecConfig

    spec = (SpecConfig(ks=(spec_k,), min_accept_rate=0.0) if spec_k
            else None)
    eng = ServingEngine(params, cfg, batch_size=batch, cache_capacity=256,
                        prefill_threshold=threshold, fused=True,
                        speculative=spec, executor=executor,
                        device=MESH_DEVICE)
    eng.warmup()
    return eng


def mesh_trace(cfg, n, new_tokens):
    from repro_torch.runtime.serving import poisson_trace

    return poisson_trace(n, 1e6, seed=17, prompt_len=(1, 32),
                         new_tokens=new_tokens, vocab=cfg.vocab_size)


def staggered_drive(engine, trace):
    """Submit the trace one request a tick, each admitted at the next mode
    of ``mode_schedule`` (so the slots run mixed widths in several depth
    groups at once), then tick until all are done. Returns (host s,
    streams)."""
    reqs = copy.deepcopy(trace)
    sched = mode_schedule(engine.ctrl.modes)
    t0 = time.perf_counter()
    for i, r in enumerate(reqs):
        engine.set_admission_mode(sched[i % len(sched)])
        engine.submit(r)
        engine.step()
    while engine.queue or engine.n_active:
        engine.step()
    return time.perf_counter() - t0, {r.rid: list(r.generated) for r in reqs}


def check_mixed_modes(name, eng):
    """Fail unless ``eng``'s completed requests ran at a narrow width and
    at a shallower depth than the full model's."""
    full = eng.ctrl.modes[-1]
    modes = {eng.ctrl.mode_by_name[r.mode_name] for r in eng.completed}
    if not any(m.width < full.width for m in modes) or not any(
            m.depth < full.depth for m in modes):
        fail(f"{name}: requests ran only at {sorted(m.name for m in modes)}"
             f": no narrow width or no shallower depth")
    return sorted(m.name for m in modes)


def counted_drive(torch, eng, trace):
    """``staggered_drive`` with every launch counter zeroed just before and
    read just after: (host s, streams, launches)."""
    cs = counters()
    for _, reset in cs.values():
        reset()
    sync(torch, MESH_DEVICE)
    secs, out = staggered_drive(eng, trace)
    sync(torch, MESH_DEVICE)
    return secs, out, {k: c() for k, (c, _) in cs.items()}


def rescore_batch(eng, items, rid0):
    """The logits that decide generated index ``len(forced)`` of each
    ``(prompt, forced, mode name)`` of ``items`` through ``eng``, a plain
    engine with a free slot per item and the drive's prefill threshold
    (the drive's own engine, once it is idle): each request
    admitted at its own mode on a tick of its own (its prompt prefilled or
    fed, as in the drive), then fed ``forced`` in place of its own samples,
    all together; a row is taken from the launch whose token completes its
    request. So the rescoring takes the drive's route to that index."""
    from repro_torch.runtime.serving import Request

    @dataclasses.dataclass
    class Forced(Request):
        forced: tuple = ()

        def next_input(self):
            if self.fed < len(self.prompt):
                return self.prompt[self.fed]
            return self.forced[len(self.generated) - 1]

    rows, last = {}, {}
    sample, complete = eng._sample, eng._complete

    def keep(lg, keys):
        last["lg"] = lg
        return sample(lg, keys)

    def done(g, slot, req, now_s):
        lg = last["lg"]  # a prompt pass's logits have one row
        row = lg[0 if lg.shape[0] == 1 else slot, :eng.cfg.vocab_size]
        rows[req.rid] = row.float().clone()  # the vocab's, not the padding's
        return complete(g, slot, req, now_s)

    eng._sample, eng._complete = keep, done
    for k, (prompt, forced, mode_name) in enumerate(items):
        eng.set_admission_mode(eng.ctrl.mode_by_name[mode_name])
        eng.submit(Forced(rid=rid0 + k, prompt=tuple(prompt),
                          max_new_tokens=len(forced) + 1,
                          forced=tuple(forced)))
        eng.step()
    while eng.queue or eng.n_active:
        eng.step()
    eng._sample, eng._complete = sample, complete
    return [rows[rid0 + k] for k in range(len(items))]


def mesh_ranks(rank, world, out_dir):
    """One rank of ``mesh_phase``'s tp = 2 drives (``MESH_DRIVES``), both
    ranks on the one card over gloo. Every drive serves the same trace
    (``staggered_drive``: one request a tick, each at the next mode, so the
    requests must cover a narrow width and a shallower depth) through a
    ``MeshExecutor`` engine on both ranks; rank 0 also serves it through a
    ``LocalExecutor`` engine. Streams and launch counts must be identical
    on both ranks; f32 drives must give the local drive's streams, bf16
    drives may part from it only at near ties (a parted request's common
    prefix is rescored through mesh and local engines with a slot per
    parted request along the drive's route (``rescore_batch``): the local
    margin of its token over the mesh's must lie within twice the largest
    logit change between the two, or one bf16 step of the top logit, either
    way, and that change at most ``MESH_MAX_CHANGE_STEPS`` bf16 steps of
    the top logit). Every
    rank's launch counts of a plain or an f32 drive must equal the local
    drive's (a rank launches its shard's kernels as often as the local
    drive launches the whole ones). Rank 0 writes the results to
    ``out_dir/mesh.json``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.models.model import init_params
    from repro_torch.runtime.serving import LocalExecutor, MeshExecutor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_serve_mesh(1, world, device=MESH_DEVICE)
    results = {}
    for name, arch, overrides, spec_k, n_req, new_tokens, strict in \
            MESH_DRIVES:
        t_all = time.perf_counter()
        cfg = mesh_config(arch, overrides)
        params = init_params(cfg, seed=0, device=MESH_DEVICE)
        trace = mesh_trace(cfg, n_req, new_tokens)
        eng = mesh_engine(cfg, params, MeshExecutor(mesh, device=MESH_DEVICE),
                          spec_k)
        secs, out, launches = counted_drive(torch, eng, trace)
        gen = sum(len(s) for s in out.values())
        res = dict(tokens_per_s=gen / secs, generated=gen, host_s=secs,
                   launches=launches, decode_launches=eng.decode_launches,
                   verify_launches=eng.spec_verify_launches,
                   prefills=eng.prefills,
                   modes=check_mixed_modes(name, eng))
        if not spec_k:
            host, dev = step_width_ms(torch, eng, 1.0, iters=5)
            res.update(step_host_ms=host, step_device_ms=dev)
        got = [None] * world
        dist.all_gather_object(got, (out, launches))
        if any(g[0] != got[0][0] for g in got):
            fail(f"{name}: the ranks' streams differ")
        if any(g[1] != got[0][1] for g in got):
            fail(f"{name}: the ranks' launches differ: {[g[1] for g in got]}")
        res["launches_per_rank"] = [g[1] for g in got]
        modes = {r.rid: r.mode_name for r in eng.completed}
        parted = loc = None
        if rank == 0:
            loc = mesh_engine(cfg, params, LocalExecutor(MESH_DEVICE), spec_k)
            l_secs, ref, l_launches = counted_drive(torch, loc, trace)
            res.update(local_tokens_per_s=gen / l_secs,
                       local_launches=l_launches)
            if not spec_k:
                host, dev = step_width_ms(torch, loc, 1.0, iters=5)
                res.update(local_step_host_ms=host, local_step_device_ms=dev)
            # a speculative bf16 drive's launches follow its acceptance,
            # which follows its streams: only plain and f32 drives are held
            if (not spec_k or strict) and any(
                    lp != l_launches for lp in res["launches_per_rank"]):
                fail(f"{name}: the ranks launched {res['launches_per_rank']}"
                     f", the local drive {l_launches}")
            prompts = {r.rid: tuple(r.prompt) for r in trace}
            parted = []
            for rid, s in sorted(ref.items()):
                if out[rid] != s:
                    j = next(k for k, (a, b) in enumerate(zip(s, out[rid]))
                             if a != b)
                    parted.append((rid, j, (prompts[rid], tuple(s[:j])),
                                   s[j], out[rid][j]))
            if strict and parted:
                fail(f"{name}: f32 mesh streams parted from the local "
                     f"drive's at {[(p[0], p[1]) for p in parted]}")
        box = [parted]
        dist.broadcast_object_list(box, src=0)
        parted = box[0]
        rows = []
        if parted:
            items = [(*fed, modes[rid]) for rid, _, fed, _, _ in parted]
            # a plain drive's own engines rescore (their slots are free
            # now); a speculative one's would verify, so plain ones are built
            lms = rescore_batch(eng if not spec_k else mesh_engine(
                cfg, params, MeshExecutor(mesh, device=MESH_DEVICE), 0),
                items, 10**6)
            lls = (rescore_batch(loc if not spec_k else mesh_engine(
                cfg, params, LocalExecutor(MESH_DEVICE), 0), items, 10**6)
                if rank == 0 else [])
            for (rid, j, _, a, b), lm, ll in zip(parted, lms, lls):
                top = float(ll.max())
                step = 2.0 ** (math.floor(math.log2(abs(top))) - 7) \
                    if top else 0.0
                change = float((ll - lm).abs().max())
                margin = float(ll[a] - ll[b])
                cap = MESH_MAX_CHANGE_STEPS * step
                row = dict(rid=rid, index=j, local=a, mesh=b,
                           margin=margin, max_logit_change=change,
                           bf16_step=step, change_cap=cap,
                           near_tie=abs(margin) <= 2 * max(change, step)
                           and change <= cap)
                rows.append(row)
                log(f"    {name}: rid {rid} parted at generated index {j} "
                    f"({a} local, {b} mesh): local margin {margin:.4f}, "
                    f"max logit change mesh vs local {change:.4f} (cap "
                    f"{cap:.4f}), bf16 step {step:.4f}: "
                    + ("a near tie" if row["near_tie"] else "NOT a near tie"))
                if change > cap:
                    fail(f"{name}: rid {rid}: the mesh's logits moved by "
                         f"{change:.4f} from the local drive's, above "
                         f"{MESH_MAX_CHANGE_STEPS} bf16 steps ({cap:.4f})")
                if not row["near_tie"]:
                    fail(f"{name}: rid {rid} parted from the local drive at "
                         f"{j} with a margin of {margin:.4f} (the rescoring "
                         f"must reproduce the local choice to within it) "
                         f"beyond twice the logit change "
                         f"{max(change, step):.4f}")
        res.update(parted=len(parted), requests=n_req, near_ties=rows,
                   seconds=time.perf_counter() - t_all)
        results[name] = res
        if rank == 0:
            log(f"  {name}: {gen} tokens, {res['tokens_per_s']:.1f} tok/s "
                f"over tp = {world} ranks sharing the card (local "
                f"{res['local_tokens_per_s']:.1f}); launches per rank "
                f"{res['launches_per_rank']}, local {res['local_launches']}"
                + (f"; full-depth w1.0 step host {res['step_host_ms']:.3f} "
                   f"ms device {res['step_device_ms']} ms (local host "
                   f"{res['local_step_host_ms']:.3f} device "
                   f"{res['local_step_device_ms']})"
                   if not spec_k else "")
                + f"; modes {res['modes']}; {len(parted)} of {n_req} "
                f"streams parted; "
                f"{res['seconds']:.1f} s")
        del eng, loc, params
        if MESH_DEVICE == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
    results.update(mesh_model_drives(torch, rank, world, mesh))
    results.update(mesh_autoscale_drive(torch, rank, world, mesh))
    results.update(serve_2d_drive(torch, rank, world))
    if rank == 0:
        with open(os.path.join(out_dir, "mesh.json"), "w") as f:
            json.dump(results, f)


def _f32_model_drive(torch, cfg, params, shard, batch, n_steps):
    """``frontend_model_drive``'s prompt pass (``attn_impl="chunked"``)
    and ``n_steps`` greedy fused decode steps at full width on ``params``,
    inside ``shard``'s context (None: the local drive); counters zeroed
    before and read after. Returns (logits (B, 1 + n_steps, V), launches,
    prompt-pass host ms)."""
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.parallel.tensor_parallel import shard_context

    count_reset = counters()
    for _, reset in count_reset.values():
        reset()
    sync(torch, MESH_DEVICE)
    with torch.no_grad(), shard_context(shard):
        t0 = time.perf_counter()
        lg, cache = prefill(params, batch, cfg, cache_extra=n_steps + 4,
                            per_slot=True)
        sync(torch, MESH_DEVICE)
        host = (time.perf_counter() - t0) * 1e3
        out = [lg[:, -1:, :cfg.vocab_size].float()]
        for _ in range(n_steps):
            tok = out[-1][:, -1].argmax(-1)[:, None]
            lg, cache = decode_step(params, cache, tok, cfg, fused=True)
            out.append(lg[:, -1:, :cfg.vocab_size].float())
    sync(torch, MESH_DEVICE)
    return (torch.cat(out, 1),
            {n: count() for n, (count, _) in count_reset.items()}, host)


def mesh_model_drives(torch, rank, world, mesh):
    """``MESH_MODEL_DRIVES``: whisper-base and internvl2-2b at full width
    in f32 on every rank (a ``MeshExecutor``'s shard, the model code under
    its context), 8 requests through a prompt pass with frames or patches
    under ``attn_impl="chunked"`` and greedy fused decode steps; rank 0
    runs the same drive on the whole model. Every rank's launches must
    equal the local drive's (B6 once per attention of the prompt pass, B5
    once per decoder layer-step for whisper's cross-attention) and the
    logits the local drive's to ``MESH_F32_ATOL``."""
    import torch.distributed as dist

    from repro_torch.models.model import init_params
    from repro_torch.runtime.serving import MeshExecutor

    results = {}
    for name, arch, text, n_steps in MESH_MODEL_DRIVES:
        t_all = time.perf_counter()
        cfg = mesh_config(arch, dict(dtype="float32")).scaled(
            attn_impl="chunked")
        params = init_params(cfg, seed=0, device=MESH_DEVICE)
        batch = frontend_batch(torch, cfg, 8, text, device=MESH_DEVICE)
        ex = MeshExecutor(mesh, device=MESH_DEVICE).bind(cfg, 8, 64)
        shard_params = ex.place_params(params)
        got, launches, host = _f32_model_drive(
            torch, ex.shard.cfg, shard_params, ex.comm, batch, n_steps)
        every = [None] * world
        dist.all_gather_object(every, launches)
        if any(e != launches for e in every):
            fail(f"{name}: the ranks' launches differ: {every}")
        res = dict(launches_per_rank=every, prompt_host_ms=host,
                   steps=n_steps)
        if rank == 0:
            want, l_launches, l_host = _f32_model_drive(
                torch, cfg, params, None, batch, n_steps)
            err = float((got - want).abs().max())
            same = bool((got.argmax(-1) == want.argmax(-1)).all())
            if l_launches != launches:
                fail(f"{name}: a rank launched {launches}, the local drive "
                     f"{l_launches}")
            if not math.isfinite(err) or err > MESH_F32_ATOL or not same:
                fail(f"{name}: logits {err:.3e} from the local drive's "
                     f"(atol {MESH_F32_ATOL:.0e}), tokens same: {same}")
            if MESH_DEVICE == "cuda" and (
                    not launches["flash_attention"] or (
                        cfg.is_encdec and not launches["flash_decode"])):
                fail(f"{name}: the prompt pass or the cross-attention "
                     f"decode left its kernel: {launches}")
            res.update(max_abs_err=err, local_prompt_host_ms=l_host,
                       local_launches=l_launches)
            log(f"  {name}: 8 requests, prompt pass (chunked) + {n_steps} "
                f"fused steps in f32 at tp = {world}: launches per rank "
                + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
                + f" (= local); logits max |mesh - local| {err:.3e} (atol "
                f"{MESH_F32_ATOL:.0e}), greedy tokens identical; prompt "
                f"pass host {host:.1f} ms (local {l_host:.1f}); "
                f"{time.perf_counter() - t_all:.1f} s")
        res["seconds"] = time.perf_counter() - t_all
        results[name] = res
        del params, shard_params, ex, batch
        if MESH_DEVICE == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
    return results


def mesh_autoscale_drive(torch, rank, world, mesh):
    """The autoscale phase's f32 drive (``autoscale_drive``: TinyLlama 4
    layers in f32, exit 3, K = 2 warmed, candidate K = 4, table budget
    warmup + 1, the two-phase trace) with every engine a ``MeshExecutor``
    over tp = ``world``, beside the same trace fixed-mode on the mesh
    (streams identical: f32). Each rank runs ``autoscale_drive``'s checks
    (a publication and a retirement, K = 4 taken on the serving thread,
    fused_verify at S = 5, serving launches as the engine's counters ask
    of a local engine, build launches apart, no stall, no drop, the table
    within its budget); then every rank's publish and retire ticks,
    serving launches, build launches and streams must be equal."""
    import contextlib
    import io

    import torch.distributed as dist

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.runtime.serving import MeshExecutor

    name = "autoscale_tp2_f32_4layers"
    t_all = time.perf_counter()
    base = (get_config(AUTOSCALE_ARCH) if MESH_DEVICE == "cuda"
            else smoke_config(AUTOSCALE_ARCH))
    cfg = base.scaled(elastic=dataclasses.replace(base.elastic,
                                                  exit_layers=(3,)),
                      dtype="float32", n_layers=4)
    params = init_params(cfg, seed=0, device=MESH_DEVICE)
    quiet = (contextlib.nullcontext() if rank == 0
             else contextlib.redirect_stdout(io.StringIO()))
    with quiet:
        launches, res = autoscale_drive(
            torch, name, cfg, params, 0, AUTOSCALE_DWELL, True,
            device=MESH_DEVICE,
            executor=lambda: MeshExecutor(mesh, device=MESH_DEVICE))
    mine = {k: res[k] for k in ("events", "run_launches", "build_launches",
                                "published", "retired", "table")}
    every = [None] * world
    dist.all_gather_object(every, mine)
    for k in mine:
        if any(e[k] != mine[k] for e in every):
            fail(f"{name}: the ranks' {k} differ: {[e[k] for e in every]}")
    res.update(launches_per_rank=[e["run_launches"] for e in every],
               seconds=time.perf_counter() - t_all)
    if rank == 0:
        log(f"  {name}: publish / retire ticks on every rank "
            f"{res['events']}; serving launches per rank "
            f"{res['run_launches']}, builds' apart {res['build_launches']}"
            f"; tokens/s fixed-mode {res['tokens_per_s_fixed']:.1f}, "
            f"autoscaled {res['tokens_per_s_autoscaled']:.1f}; "
            f"{res['seconds']:.1f} s")
    del params
    if MESH_DEVICE == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()
    return {name: res}


def serve_2d_drive(torch, rank, world):
    """``SERVE_2D_DRIVE``: ``serve_2d`` over a (``world``, 1) mesh (the
    weights split over ``data``, 4 slots a rank): each rank must hold
    ``param_specs(..., "serve_2d")``'s cut (half the weights), serve the
    local drive's streams (f32) with its launches, and the ranks the same;
    prints the gathers' host ms per step call and a full-depth step's host
    and device ms beside the local engine's."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.models.model import init_params
    from repro_torch.parallel import sharding as SH
    from repro_torch.runtime.serving import LocalExecutor, MeshExecutor

    name, arch, overrides, n_req, new_tokens = SERVE_2D_DRIVE
    t_all = time.perf_counter()
    mesh = make_serve_mesh(world, 1, device=MESH_DEVICE)
    cfg = mesh_config(arch, overrides)
    params = init_params(cfg, seed=0, device=MESH_DEVICE)
    trace = mesh_trace(cfg, n_req, new_tokens)
    eng = mesh_engine(cfg, params, MeshExecutor(
        mesh, policy="serve_2d", device=MESH_DEVICE), 0, threshold=1)
    s2d = eng.executor.comm.serve2d
    specs = SH.param_specs(params, cfg, mesh, "serve_2d")
    held = SH.shard_params(params, specs, mesh)
    flat = list(_leaves(eng.params))
    if not all(torch.equal(a, b) for a, b in zip(flat, _leaves(held))):
        fail(f"{name}: a held leaf is not param_specs' serve_2d cut")
    held_gb = sum(t.numel() * t.element_size() for t in flat) / 1e9
    full_gb = sum(t.numel() * t.element_size()
                  for t in _leaves(params)) / 1e9
    s2d.gather_s, s2d.views = 0.0, 0
    secs, out, launches = counted_drive(torch, eng, trace)
    gather_ms = s2d.gather_s / max(s2d.views, 1) * 1e3
    host, dev = step_width_ms(torch, eng, 1.0, iters=1)
    gen = sum(len(x) for x in out.values())
    every = [None] * world
    dist.all_gather_object(every, (out, launches))
    if any(e != every[0] for e in every):
        fail(f"{name}: the ranks' streams or launches differ")
    res = dict(tokens_per_s=gen / secs, generated=gen, held_gb=held_gb,
               full_gb=full_gb, gather_ms_per_step=gather_ms,
               step_calls=s2d.views, step_host_ms=host, step_device_ms=dev,
               launches_per_rank=[e[1] for e in every],
               modes=check_mixed_modes(name, eng))
    del eng
    if rank == 0:
        loc = mesh_engine(cfg, params, LocalExecutor(MESH_DEVICE), 0,
                          threshold=1)
        l_secs, ref, l_launches = counted_drive(torch, loc, trace)
        l_host, l_dev = step_width_ms(torch, loc, 1.0, iters=1)
        if out != ref:
            fail(f"{name}: f32 serve_2d streams parted from the local "
                 f"drive's")
        if launches != l_launches:
            fail(f"{name}: a rank launched {launches}, the local drive "
                 f"{l_launches}")
        res.update(local_tokens_per_s=gen / l_secs, local_launches=l_launches,
                   local_step_host_ms=l_host, local_step_device_ms=l_dev)
        log(f"  {name}: serve_2d over ({world}, 1), each rank holding "
            f"{held_gb:.3f} of {full_gb:.3f} GB (param_specs' cut); {gen} "
            f"tokens identical to the local drive's, launches per rank "
            f"{launches} (= local); {gen / secs:.1f} tok/s (local "
            f"{gen / l_secs:.1f}); gathers {gather_ms:.3f} host ms per step "
            f"call ({s2d.views} calls); full-depth w1.0 step host "
            f"{host:.3f} ms device {dev} ms (local {l_host:.3f} / {l_dev}); "
            f"modes {res['modes']}; {time.perf_counter() - t_all:.1f} s")
        del loc
    res["seconds"] = time.perf_counter() - t_all
    del params
    if MESH_DEVICE == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()
    return {name: res}


def mesh_world_one(torch):
    """``MeshExecutor`` at world size 1 over NCCL in this process: the
    full-width fused TinyLlama drive (``staggered_drive``, mixed widths and
    depths) must give the ``LocalExecutor`` drive's tokens and per-kernel
    launch counts."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.runtime.serving import LocalExecutor, MeshExecutor

    cfg = mesh_config("tinyllama-1.1b", {})
    params = init_on_card(torch, cfg)
    trace = mesh_trace(cfg, 8, (16, 32))
    try:
        mesh = make_serve_mesh(1, 1, device="cuda")
        if dist.get_backend() != "nccl":
            fail(f"world size 1 on one card chose {dist.get_backend()}")
        eng = mesh_engine(cfg, params, MeshExecutor(mesh), 0)
        secs, out, launches = counted_drive(torch, eng, trace)
        modes = check_mixed_modes("world size 1", eng)
        del eng
        loc = mesh_engine(cfg, params, LocalExecutor("cuda"), 0)
        l_secs, ref, l_launches = counted_drive(torch, loc, trace)
        del loc
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if out != ref:
        fail("MeshExecutor at world size 1 parted from LocalExecutor")
    if launches != l_launches:
        fail(f"MeshExecutor at world size 1 launched {launches}, "
             f"LocalExecutor {l_launches}")
    gen = sum(len(s) for s in out.values())
    log(f"  world size 1 over NCCL: {gen} tokens identical to the local "
        f"drive's, launches identical {launches}; {gen / secs:.1f} tok/s "
        f"(local {gen / l_secs:.1f}); modes {modes}")
    del params
    torch.cuda.empty_cache()
    return dict(tokens_per_s=gen / secs, local_tokens_per_s=gen / l_secs,
                launches=launches, generated=gen, modes=modes)


def mesh_phase(torch):
    """Phase 3's mesh drives: (a) world size 1 over NCCL in this process
    (``mesh_world_one``), (b) tp = 2 as two ranks sharing the card over
    gloo (``mesh_ranks``, started by ``launch.mesh.spawn_ranks``; a rank's
    failure fails the phase). Two ranks on one card measure the
    collectives' placement, not multi-card speed. Returns (launches per
    drive: rank 0's, results)."""
    import tempfile

    from repro_torch.launch.mesh import spawn_ranks

    t0 = time.perf_counter()
    results = {"world1_nccl": mesh_world_one(torch)}
    out_dir = tempfile.mkdtemp(prefix="mesh_phase_")
    spawn_ranks(mesh_ranks, MESH_TP, (out_dir,), device=MESH_DEVICE)
    with open(os.path.join(out_dir, "mesh.json")) as f:
        results.update(json.load(f))
    launches = {"mesh_world1_nccl": results["world1_nccl"]["launches"]}
    for name, res in results.items():
        if "launches_per_rank" in res:
            launches[name] = res["launches_per_rank"][0]
    log(f"  mesh phase: {time.perf_counter() - t0:.1f} s")
    return launches, results


# ---------------------------------------------------------------------------
# phase 4: training on a (data, model) mesh
# ---------------------------------------------------------------------------

TRAIN_MESHES = ((2, 1), (1, 2))  # (dp, tp): two ranks sharing the card
TRAIN_MESH_LR = 1e-3
TRAIN_MESH_BATCH = (8, 256)  # B, S
# name, arch, (dp, tp), steps, grad dtype, sequence parallelism,
# bf16-gradient matmul
TRAIN_MESH_DRIVES = (
    ("mamba2_dp2", "mamba2-370m", (2, 1), 3, "float32", False, False),
    ("mamba2_tp2", "mamba2-370m", (1, 2), 3, "float32", False, False),
    ("tinyllama_tp2_sp_bf16mm", "tinyllama-1.1b", (1, 2), 2, "float32", True,
     True),
    ("tinyllama_dp2_grad_bf16", "tinyllama-1.1b", (2, 1), 2, "bfloat16",
     False, False),
)
# Tolerances of a mesh drive against the one-card step on the same seeded
# state and batches. f32 activations (Mamba2): the first step's loss rtol
# 1e-5, later steps' 1e-4 (their parameters may already differ by a few lr
# where a near-zero gradient took the other sign); step-1 gradients before
# the optimizer |mesh - card| <= 1e-4 max |g| of each leaf; parameters after
# the last step at most 0.1% of the elements beyond 0.01 lr. bf16
# activations (TinyLlama; the tensor-parallel partials are rounded to bf16
# before their f32 sum): losses within 8 bf16 steps (8 x 2^-8 relative);
# step-1 gradients within twice the card's own bf16-vs-f32 gradient
# difference plus 2^-8 of the leaf's max |g|, leaf by leaf: rounding noise
# (an H100 run saw a fifth of the elements moved by over 0.25 lr after two
# AdamW steps, so a parameter count is no check in bf16). Every drive: max |mesh - card| of a parameter <= 2 lr
# a step (AdamW moves an element by about lr a step) + 1e-6.
TRAIN_MESH_TOL = {"float32": dict(loss1=1e-5, loss=1e-4, near=0.01,
                                  share=1e-3),
                  "bfloat16": dict(loss1=8 * 2.0 ** -8, loss=8 * 2.0 ** -8,
                                   near=None, share=None)}


def train_mesh_cfg(arch):
    from repro_torch.configs import get_config

    if arch == "mamba2-370m":  # f32 activations, 8 of its 48 layers
        return depth_cut(get_config(arch), 8, (4, 6)).scaled(dtype="float32")
    return depth_cut(get_config(arch), 2, (1,))  # bf16 activations


def train_mesh_batches(cfg, n):
    from repro_torch.data import DataConfig, make_batch

    B, S = TRAIN_MESH_BATCH
    dc = DataConfig(seed=0, global_batch=B, seq_len=S)
    return [make_batch(cfg, dc, i) for i in range(n)]


def _cpu_tree(tree):
    return {k: _cpu_tree(v) if isinstance(v, dict) else
            v.detach().float().cpu() for k, v in tree.items()}


def train_mesh_local(torch, arch, steps, gdt, bf16mm):
    """The one-card reference of a mesh drive: the seeded state, the same
    batches, ``make_train_step`` without a mesh. Returns (losses, the
    parameters after the last step, the step-1 gradients and, for bf16
    activations, the step-1 gradients with f32 activations, on the
    host)."""
    from repro_torch.data import to_device
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models.layers import set_bf16_grad_matmul
    from repro_torch.models.model import loss_fn
    from repro_torch.optim import OptimizerConfig
    from repro_torch.optim.optimizer import grads_of

    cfg = train_mesh_cfg(arch)
    ocfg = OptimizerConfig(lr=TRAIN_MESH_LR)
    batches = [to_device(b, "cuda") for b in train_mesh_batches(cfg, steps)]
    state = init_train_state(cfg, ocfg, seed=0, device="cuda")
    step = make_train_step(cfg, ocfg, remat="none", grad_dtype=gdt)
    g32 = None
    if cfg.dtype != "float32":
        loss, _ = loss_fn(state["params"], batches[0],
                          cfg.scaled(dtype="float32"))
        g32 = _cpu_tree(grads_of(loss, state["params"]))
    set_bf16_grad_matmul(bf16mm)
    try:
        loss, _ = loss_fn(state["params"], batches[0], cfg)
        g = _cpu_tree(grads_of(loss, state["params"]))
        losses = []
        for b in batches:
            state, m = step(state, b)
            losses.append(m["loss"].item())
    finally:
        set_bf16_grad_matmul(False)
    out = (losses, _cpu_tree(state["params"]), g, g32)
    del state
    torch.cuda.empty_cache()
    return out


def _flat_paths(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat_paths(v, p)
        else:
            yield p, v


def compare_train(name, act, steps, losses, params, grads, ref):
    """A mesh drive's losses, gathered step-1 gradients and parameters
    against its one-card reference ``ref`` (``TRAIN_MESH_TOL`` of the
    activation dtype ``act``). Returns the worst errors."""
    r_losses, r_params, r_grads, r_g32 = ref
    tol = TRAIN_MESH_TOL[act]
    for i, (a, b) in enumerate(zip(losses, r_losses)):
        rt = tol["loss1"] if i == 0 else tol["loss"]
        if not (math.isfinite(a) and abs(a - b) <= rt * abs(b)):
            fail(f"train mesh {name}: step {i} loss {a!r} vs one card "
                 f"{b!r} beyond rtol {rt:.1e}")
    worst = {"loss_rel": max(abs(a - b) / abs(b)
                             for a, b in zip(losses, r_losses))}
    gw, got_g = 0.0, dict(_flat_paths(grads))
    g32 = dict(_flat_paths(r_g32)) if r_g32 is not None else None
    for path, want in _flat_paths(r_grads):
        got = got_g[path]
        scale = max(float(want.abs().max()), 1e-30)
        e = float((got - want).abs().max())
        lim = 1e-4 * scale if g32 is None else (
            2 * float((want - g32[path]).abs().max()) + 2.0 ** -8 * scale)
        if e > lim:
            fail(f"train mesh {name}: step-1 gradient {path} max |err| "
                 f"{e:.3e} beyond {lim:.3e} (max |g| {scale:.3e})")
        gw = max(gw, e / scale)
    worst["grad_rel"] = gw
    lim = 2 * steps * TRAIN_MESH_LR + 1e-6
    got_p = dict(_flat_paths(params))
    n_far = n_all = 0
    pw = 0.0
    for path, want in _flat_paths(r_params):
        d = (got_p[path] - want).abs()
        e = float(d.max())
        if e > lim:
            fail(f"train mesh {name}: parameter {path} max |err| {e:.3e} "
                 f"beyond 2 lr a step ({lim:.3e})")
        if tol["near"] is not None:
            n_far += int((d > tol["near"] * TRAIN_MESH_LR).sum())
        n_all += d.numel()
        pw = max(pw, e)
    if tol["share"] is not None and n_far > tol["share"] * n_all:
        fail(f"train mesh {name}: {n_far} of {n_all} parameter elements "
             f"beyond {tol['near']} lr of the one-card step (at most "
             f"{tol['share']:.0e} of them may be)")
    worst.update(param_max_abs=pw, param_share_beyond=n_far / n_all)
    return worst


def _ref_key(arch, steps, gdt, bf16mm):
    return f"ref_{arch}_{steps}_{gdt}_{int(bf16mm)}"


def train_mesh_ranks(rank, world, out_dir, drives=TRAIN_MESH_DRIVES,
                     shapes=TRAIN_MESHES):
    """One rank of ``train_mesh_phase``'s drives (``drives``, by default
    ``TRAIN_MESH_DRIVES``: both ranks on the one card over gloo, the (2, 1)
    and (1, 2) meshes of ``shapes`` over the same two ranks; with a card a
    rank, NCCL). Each drive builds the sharded state
    (``init_train_state(mesh=...)``; the rise of ``memory_allocated``
    beside the dry-run's reckoning of it), takes the step-1 gradients where
    takes the step-1 gradients (``step.grads``) and ``steps`` mesh steps (the last one
    profiled on rank 0), counting every kernel launch on this rank; rank 0
    gathers the gradients and parameters and holds them to the one-card
    reference (``out_dir/ref_*.pt``), and writes the results to
    ``out_dir/train_mesh.json``."""
    import torch

    from repro_torch.data import to_device
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import _mesh
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models.layers import set_bf16_grad_matmul
    from repro_torch.models.model import init_params
    from repro_torch.optim import OptimizerConfig
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel import tensor_parallel as TP

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    meshes = {s: _mesh(s, ("data", "model"), device="cuda") for s in shapes}
    results = {}
    for name, arch, shape, steps, gdt, sp, bf16mm in drives:
        t_all = time.perf_counter()
        mesh = meshes[shape]
        cfg = train_mesh_cfg(arch)
        ocfg = OptimizerConfig(lr=TRAIN_MESH_LR)
        batches = [to_device(b, "cuda")
                   for b in train_mesh_batches(cfg, steps)]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        state = init_train_state(cfg, ocfg, seed=0, device="cuda", mesh=mesh)
        torch.cuda.synchronize()
        rise = torch.cuda.memory_allocated() - before
        pred = dryrun.train_state_bytes(cfg, ocfg, SH.axis_sizes(mesh),
                                        SH.mesh_coord(mesh))
        pred_all = pred["params_bytes"] + pred["opt_bytes"]
        if abs(rise - pred_all) > 0.01 * pred_all + 2**20:
            fail(f"train mesh {name} rank {rank}: the sharded state took "
                 f"{rise} B of device memory, the dry-run reckons {pred_all} B")
        gsh = SH.shardings_for(SH.param_specs(
            init_params(cfg, device="meta"), cfg, mesh, "train"), mesh)
        step = make_train_step(cfg, ocfg, remat="none", grad_dtype=gdt,
                               grad_shardings=gsh)
        shards = SH.train_state_shardings(cfg, ocfg, mesh)
        sp_ctx = SH.activation_sharding(mesh, SH.residual_specs(
            mesh, "train") if sp else {})
        count_reset = counters()
        for _, reset in count_reset.values():
            reset()
        TP.reset_staged()
        set_bf16_grad_matmul(bf16mm)
        losses, wall, grads = [], [], None
        dev_ms = float("nan")
        try:
            with sp_ctx:
                _, g = step.grads(state["params"], batches[0])
                grads = _cpu_tree(TP.gather_tree(g, shards["params"], mesh))
                del g
                torch.cuda.synchronize()
                staged0 = TP.staged_seconds()
                for i, b in enumerate(batches):
                    if i == len(batches) - 1 and rank == 0:
                        box = {}

                        def one(b=b, box=box):
                            box["out"] = step(state, b)

                        per = kernel_us(torch, one, 1)
                        state, m = box["out"]
                        dev_ms = sum(per.values()) / 1e3
                    else:
                        t0 = time.perf_counter()
                        state, m = step(state, b)
                        torch.cuda.synchronize()
                        wall.append((time.perf_counter() - t0) * 1e3)
                    losses.append(m["loss"].item())
                staged1 = TP.staged_seconds()
        finally:
            set_bf16_grad_matmul(False)
        launches = {k: count() for k, (count, _) in count_reset.items()}
        L = cfg.n_layers if "ssm" in cfg.layer_pattern else 0
        calls = steps + 1  # and the step-1 gradients
        want = {k: 0 for k in launches}
        want.update(ssd_scan=L * calls, ssd_scan_bwd=L * calls)
        if launches != want:
            fail(f"train mesh {name} rank {rank}: launches {launches}, "
                 f"expected {want}")
        params = _cpu_tree(TP.gather_tree(state["params"], shards["params"],
                                          mesh))
        res = dict(mesh=list(shape), steps=steps, grad_dtype=gdt, sp=sp,
                   bf16_grad_matmul=bf16mm, losses=losses,
                   launches_per_rank=launches,
                   state_bytes_allocated=rise, state_bytes_dryrun=pred_all,
                   step_wall_ms=_ms(wall[1:] or wall), step_device_ms=dev_ms,
                   staged_collective_ms_per_step=(
                       staged1["s"] - staged0["s"]) * 1e3 / steps,
                   staged_collectives_per_step=(
                       staged1["n"] - staged0["n"]) / steps)
        if rank == 0:
            ref = torch.load(os.path.join(out_dir, f"{_ref_key(
                arch, steps, gdt, bf16mm)}.pt"), weights_only=False)
            res.update(compare_train(name, cfg.dtype, steps, losses, params,
                                     grads, ref))
            del ref
            res["idle_share"] = 1 - dev_ms / res["step_wall_ms"]
            res["seconds"] = time.perf_counter() - t_all
            log(f"  {name} ({arch} {cfg.n_layers} layers, (dp, tp) = "
                f"{shape}, {gdt} gradients{', SP' if sp else ''}"
                f"{', bf16-dW matmul' if bf16mm else ''}): losses {losses}; "
                f"step {res['step_wall_ms']:.1f} ms wall, "
                f"{dev_ms:.1f} ms device (rank 0), idle share "
                f"{res['idle_share']:.3f}, host-staged collectives "
                f"{res['staged_collective_ms_per_step']:.1f} ms a step "
                f"({res['staged_collectives_per_step']:.0f} calls); state "
                f"{rise / 2**20:.1f} MiB allocated vs {pred_all / 2**20:.1f} "
                f"MiB reckoned by the dry-run; launches {launches}; worst "
                + json.dumps({k: res[k] for k in ('loss_rel', 'grad_rel',
                                                  'param_max_abs',
                                                  'param_share_beyond')
                              if k in res}))
        results[name] = res
        del state, step, params, grads, batches
        gc.collect()
        torch.cuda.empty_cache()
    if rank == 0:
        with open(os.path.join(out_dir, "train_mesh.json"), "w") as f:
            json.dump(results, f)


def train_mesh_world_one(torch, ref):
    """``make_train_step(grad_shardings=...)`` at world size 1 over NCCL in
    this process (the Mamba2 drive's 3 steps): bit for bit the one-card
    step's losses and parameters."""
    import torch.distributed as dist

    from repro_torch.data import to_device
    from repro_torch.launch.mesh import _mesh
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models.model import init_params
    from repro_torch.optim import OptimizerConfig
    from repro_torch.parallel import sharding as SH

    name, arch, _, steps = TRAIN_MESH_DRIVES[0][:4]
    cfg = train_mesh_cfg(arch)
    ocfg = OptimizerConfig(lr=TRAIN_MESH_LR)
    batches = [to_device(b, "cuda") for b in train_mesh_batches(cfg, steps)]
    try:
        mesh = _mesh((1, 1), ("data", "model"), device="cuda")
        if dist.get_backend() != "nccl":
            fail(f"world size 1 on one card chose {dist.get_backend()}")
        state = init_train_state(cfg, ocfg, seed=0, device="cuda", mesh=mesh)
        step = make_train_step(cfg, ocfg, remat="none", grad_shardings=SH.
                               shardings_for(SH.param_specs(init_params(
                                   cfg, device="meta"), cfg, mesh, "train"),
                                   mesh))
        losses = []
        for b in batches:
            state, m = step(state, b)
            losses.append(m["loss"].item())
        params = _cpu_tree(state["params"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    r_losses, r_params = ref[:2]
    differ = [p for p, t in _flat_paths(r_params)
              if not torch.equal(dict(_flat_paths(params))[p], t)]
    if losses != r_losses or differ:
        fail(f"mesh train step at world size 1 parted from the one-card "
             f"step: losses {losses} vs {r_losses}; parameters {differ}")
    log(f"  world size 1 over NCCL: {steps} Mamba2 mesh steps bit for bit "
        f"the one-card step's (losses {losses})")
    del state, step
    torch.cuda.empty_cache()
    return dict(losses=losses, bitwise=True)


def chunked_train_check(torch, prompt_launches):
    """A full-width TinyLlama-1.1B train step cut to 2 layers, f32, B = 1,
    S = 4096 under ``attn_impl="chunked"``: no ``flash_attention`` launch
    (the gradient pass takes the plain ``attention_chunked``) and the
    ``"einsum"`` route's loss within 1e-5; the fused chunked serving drive
    did launch it (``prompt_launches``, its exact count asserted by
    ``end_to_end``; None under ``--skip-e2e``)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch, to_device
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.optim import OptimizerConfig

    base = depth_cut(get_config("tinyllama-1.1b"), 2, (1,)).scaled(
        dtype="float32")
    ocfg = OptimizerConfig(lr=1e-4)
    batch = make_batch(base, DataConfig(seed=0, global_batch=1,
                                        seq_len=4096), 0)
    out = {}
    for impl in ("chunked", "einsum"):
        cfg = base.scaled(attn_impl=impl)
        state = init_train_state(cfg, ocfg, seed=0, device="cuda")
        step = make_train_step(cfg, ocfg, remat="full")
        FA.reset_launch_count()
        t0 = time.perf_counter()
        state, m = step(state, to_device(batch, "cuda"))
        torch.cuda.synchronize()
        out[impl] = dict(loss=m["loss"].item(), launches=FA.launch_count(),
                         ms=(time.perf_counter() - t0) * 1e3)
        del state, step
        torch.cuda.empty_cache()
    c, e = out["chunked"], out["einsum"]
    if c["launches"] or e["launches"]:
        fail(f"a train step launched flash_attention: {out}")
    if not abs(c["loss"] - e["loss"]) <= 1e-5 * abs(e["loss"]):
        fail(f"chunked train step loss {c['loss']!r} vs einsum "
             f"{e['loss']!r} beyond rtol 1e-5")
    if prompt_launches is not None and not prompt_launches:
        fail("the fused chunked drive launched no flash_attention")
    log(f"  TinyLlama 2 layers f32 train step at S = 4096 under "
        f"attn_impl=\"chunked\": loss {c['loss']:.6f} (einsum "
        f"{e['loss']:.6f}), 0 flash_attention launches ({c['ms']:.0f} ms; "
        f"einsum {e['ms']:.0f} ms); the fused chunked prompt drive: "
        f"{prompt_launches} launches")
    return dict(chunked=c, einsum=e, prompt_drive_launches=prompt_launches)


def train_mesh_phase(torch, prompt_launches):
    """Phase 4's mesh training: the chunked train step routed around the
    flash kernel (``chunked_train_check``), the one-card references of
    ``TRAIN_MESH_DRIVES``, the world-size-1 NCCL drive
    (``train_mesh_world_one``) and the drives as two gloo ranks sharing the
    card (``train_mesh_ranks``; a rank's failure fails the phase). Two
    ranks on one card measure the collectives' placement, not multi-card
    speed. Returns (rank 0's launches per drive, results)."""
    import tempfile

    from repro_torch.launch.mesh import spawn_ranks

    t0 = time.perf_counter()
    log(f"  card: {card_line()}")
    results = {"chunked_train": chunked_train_check(torch, prompt_launches)}
    out_dir = tempfile.mkdtemp(prefix="train_mesh_")
    for i, (_, arch, _, steps, gdt, _, bf16mm) in enumerate(
            TRAIN_MESH_DRIVES):
        path = os.path.join(out_dir, f"{_ref_key(arch, steps, gdt, bf16mm)}.pt")
        if os.path.exists(path):
            continue
        ref = train_mesh_local(torch, arch, steps, gdt, bf16mm)
        if i == 0:
            results["world1_nccl"] = train_mesh_world_one(torch, ref)
        torch.save(ref, path)
        del ref
    spawn_ranks(train_mesh_ranks, 2, (out_dir,), device="cuda")
    with open(os.path.join(out_dir, "train_mesh.json")) as f:
        results.update(json.load(f))
    launches = {n: r["launches_per_rank"] for n, r in results.items()
                if "launches_per_rank" in r}
    log(f"  train mesh phase: {time.perf_counter() - t0:.1f} s")
    return launches, results


def check_ssd_train_shards(torch, mcfg, timer):
    """The scan kernel and its backward at the Mamba2-370M mesh step's
    rank shapes (S = 256, f32): dp = 2, 4 rows of 32 heads; tp = 2, 8 rows
    of 16 heads. Each against its plain version (``ssd_chunked`` /
    ``ssd_scan_bwd_plain``), timed beside it and its bound."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as SSD

    h, p, g, n, q = (mcfg.ssm_nheads, mcfg.ssm_head_dim, mcfg.ssm_ngroups,
                     mcfg.ssm_state, mcfg.ssm_chunk)
    gen = torch.Generator(device="cuda").manual_seed(27)
    res = {}
    for tag, (b, hh) in (("dp2 rank (4 rows, 32 heads)", (4, h)),
                         ("tp2 rank (8 rows, 16 heads)", (8, h // 2))):
        s = TRAIN_MESH_BATCH[1]
        x, dt, A, B, C = scan_inputs(torch, gen, b, s, hh, p, g, n)
        (yk, sk), (yp, sp_) = (ops.ssd_scan_bshn(x, dt, A, B, C, chunk=q),
                               SSD.ssd_chunked(x, dt, A, B, C, q))
        torch.cuda.synchronize()
        ferr = 0.0
        for what, got, want in (("y", yk, yp), ("state", sk, sp_)):
            ok, e = close(torch, got, want, rtol=RTOL_SCAN, atol=ATOL_SCAN)
            if not ok or not bool(torch.isfinite(got).all()):
                fail(f"ssd_scan {tag} {what}: max |err| {e:.3e}")
            ferr = max(ferr, e)
        t_f = timer.ms(lambda: ops.ssd_scan_bshn(x, dt, A, B, C, chunk=q))
        t_fp = timer.ms(lambda: SSD.ssd_chunked(x, dt, A, B, C, q))
        fb, fby, _, _, _ = scan_bound(b, s, hh, p, g, n)
        A_bh = A.expand(b, hh).contiguous()
        dy = torch.randn(b, s, hh, p, generator=gen, device="cuda")
        ds = torch.randn(b, hh, p, n, generator=gen, device="cuda")
        _, _, ws = SSD.launch_bshn(x, dt, A_bh, B, C, keep_workspace=True)

        def kern():
            return SSD.launch_bwd(x, dt, A_bh, B, C, ws, dy, ds)

        def plain():
            return SSD.ssd_scan_bwd_plain(x, dt, A_bh, B, C, dy, ds)

        berr = 0.0
        for nm, gk, gp in zip(("dx", "ddt", "dA", "dB", "dC"), kern(),
                              plain()):
            scale = float(gp.abs().max())
            err = (gk.float() - gp.float()).abs()
            if not (bool(torch.isfinite(gk).all()) and bool(
                    (err <= ATOL_BWD * scale + RTOL_BWD * gp.abs()).all())):
                fail(f"ssd_scan_bwd {tag} {nm}: max |err| "
                     f"{float(err.max()):.3e} (scale {scale:.3e})")
            berr = max(berr, float(err.max()))
        t_b = timer.ms(kern)
        t_bp = timer.ms(plain)
        bb, bby, _, _ = scan_bwd_bound(b, s, hh, p, g, n, 4)
        log(f"  ssd_scan at the Mamba2 mesh step's {tag}: forward max|err| "
            f"{ferr:.3e}, kernel {t_f:.4f} ms, plain {t_fp:.4f} ms, bound "
            f"{fb:.4f} ms ({fby}); backward max|err| {berr:.3e}, kernel "
            f"{t_b:.4f} ms, plain {t_bp:.4f} ms, bound {bb:.4f} ms ({bby})")
        res[tag] = dict(
            forward=dict(max_abs_err=ferr, ms=t_f, plain_ms=t_fp,
                         bound_ms=fb, bound_by=fby, library_ms=None),
            backward=dict(max_abs_err=berr, ms=t_b, plain_ms=t_bp,
                          bound_ms=bb, bound_by=bby, library_ms=None))
    return res


# the cost phase: B, cache, prompt; the trace's argument + temp bytes held to
# the train step's max_memory_allocated rise within this ratio band (PERF.md
# section 6: the caching allocator rounds each block up and cuBLAS keeps its
# workspaces there; the trace frees a tensor where eager does)
COST_B, COST_CACHE, COST_PROMPT = 8, 512, 256
COST_MEM_RATIO = (0.75, 1.5)


def _counted_step(torch, fn):
    """(out, kernel name -> launches, device ms) of one call of ``fn`` on
    the card, every wrapper's count zeroed just before and read just
    after, under the profiler (device ms: the sum of the call's kernels;
    device activity alone: recording a train step's host ops as well costs
    seconds of host time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cs = counters()
    for _, reset in cs.values():
        reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    dev = sum(r.self_device_time_total for r in prof.key_averages()
              if r.device_type == DeviceType.CUDA) / 1e3
    return out, {k: get() for k, (get, _) in cs.items()}, dev


def _hold_launches(what, traced, counted):
    want = {k: v for k, v in counted.items() if v}
    got = {k: v for k, v in traced.launches().items() if v}
    if got != want:
        fail(f"cost phase, {what}: traced launches {got} != the wrappers' "
             f"counters {want}")
    return got


def cost_phase(torch, cfg, mcfg, card):
    """The op-trace walker (``launch.op_analysis``) held to the card: at
    the published width and full depth, B = 8, cache 512, bf16
    activations, seeded weights. For each step the same step function is
    traced on meta copies of its arguments (host only) and run once on the
    card: every kernel's traced launches must equal its wrapper's counter
    over the real step. TinyLlama's unfused and fused decode steps (the
    serve controller's full-depth step): the traced bytes must be at least
    ``step_bytes``; a Mamba2 train step (phase 4's B = 8, S = 256,
    AdamW): B4 and its backward, and the trace's argument + temp bytes
    beside the step's ``max_memory_allocated`` rise, within
    COST_MEM_RATIO; on its parameters, Mamba2's decode step and 256-token
    prompt pass. Prints each step's traced bytes, ``memory_s`` and
    ``compute_s`` beside its device ms."""
    from repro_torch.core import elastic
    from repro_torch.core.morph import make_serve_controller
    from repro_torch.core.neuroforge.hw import H100
    from repro_torch.data import DataConfig, make_batch, to_device
    from repro_torch.launch import op_analysis as OA
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models.model import init_decode_cache, prefill
    from repro_torch.optim import OptimizerConfig

    res = {}

    def report(what, traced, counted, dev_ms, floor=None):
        launches = _hold_launches(what, traced, counted)
        mem_s, comp_s = traced.bytes / H100.hbm_bw, traced.flops / \
            H100.peak_flops
        row = dict(launches=launches, bytes=traced.bytes,
                   flops=traced.flops, memory_ms=mem_s * 1e3,
                   compute_ms=comp_s * 1e3, device_ms=dev_ms,
                   trace_ops=traced.n_ops)
        extra = ""
        if floor is not None:
            if traced.bytes < floor:
                fail(f"cost phase, {what}: traced bytes {traced.bytes:.4e} "
                     f"below step_bytes {floor:.4e}")
            row.update(step_bytes=floor, ratio=traced.bytes / floor)
            extra = (f", step_bytes {floor / 1e9:.3f} GB (traced / "
                     f"step_bytes {traced.bytes / floor:.3f})")
        log(f"  {what}: launches {launches} traced = counted; traced "
            f"{traced.bytes / 1e9:.3f} GB, {traced.flops / 1e9:.2f} GFLOP "
            f"({traced.n_ops} aten ops){extra}; memory_s "
            f"{mem_s * 1e3:.4f} ms, compute_s {comp_s * 1e3:.4f} ms at "
            f"H100 peaks; device {dev_ms:.4f} ms ({card})")
        res[what] = row

    B = COST_B
    # a Mamba2 train step first, on a clean allocator: its memory beside
    # the trace's; its parameters then serve the Mamba2 decode step
    ocfg = OptimizerConfig(lr=2e-3)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(mcfg, ocfg, seed=0, device="cuda")
    batch = to_device(make_batch(mcfg, DataConfig(seed=0, global_batch=B,
                                                  seq_len=COST_PROMPT), 0),
                      "cuda")
    step = make_train_step(mcfg, ocfg, remat="none")
    traced = OA.trace(step, OA.meta_like(state), OA.meta_like(batch))
    _, counted, dev = _counted_step(torch, lambda: step(state, batch))
    rise = torch.cuda.max_memory_allocated() - base
    want = traced.argument_bytes + traced.peak_temp_bytes
    ratio = rise / want
    report(f"mamba2 train step (B = {B}, S = {COST_PROMPT}, AdamW)", traced,
           counted, dev)
    arg_gib = traced.argument_bytes / 2**30
    log(f"  mamba2 train step memory: trace argument {arg_gib:.3f} + temp "
        f"{traced.peak_temp_bytes / 2**30:.3f} = "
        f"{want / 2**30:.3f} GiB; the card's max_memory_allocated rise "
        f"{rise / 2**30:.3f} GiB (ratio {ratio:.3f}, band "
        f"{COST_MEM_RATIO}) ({card})")
    res["mamba2 train memory"] = dict(argument_bytes=traced.argument_bytes,
                                      temp_bytes=traced.peak_temp_bytes,
                                      max_allocated_rise=rise, ratio=ratio)
    if not COST_MEM_RATIO[0] <= ratio <= COST_MEM_RATIO[1]:
        fail(f"cost phase: the train step's memory rise {rise} is "
             f"{ratio:.3f}x the trace's argument + temp bytes {want}, "
             f"outside {COST_MEM_RATIO}")
    mparams = state["params"]
    del state, batch, step
    torch.cuda.empty_cache()
    for arch, c in (("mamba2", mcfg), ("tinyllama", cfg)):
        params = mparams if arch == "mamba2" else init_on_card(torch, c)
        active = elastic.active_widths_batch(c, [1.0] * B, device="cuda")
        tok = torch.ones((B, 1), dtype=torch.int64, device="cuda")
        for fused in ((False, True) if arch == "tinyllama" else (False,)):
            ctrl = make_serve_controller(params, c, fused=fused)
            step = ctrl.step_for(ctrl.modes[-1])
            cache = init_decode_cache(c, B, COST_CACHE, per_slot=True,
                                      device="cuda")
            floor = params_cache_bytes(c, params, cache)
            what = f"{arch} {'fused' if fused else 'unfused'} decode step"
            t0 = time.perf_counter()
            with torch.no_grad():
                traced = OA.trace(step, OA.meta_like(params),
                                  OA.meta_like(cache), OA.meta_like(tok),
                                  OA.meta_like(active))
                host = time.perf_counter() - t0
                _, counted, dev = _counted_step(
                    torch, lambda: step(params, cache, tok, active))
            report(what, traced, counted, dev, floor)
            res[what]["trace_host_s"] = host
        if arch == "mamba2":
            gen = torch.Generator(device="cuda").manual_seed(3)
            batch = {"tokens": torch.randint(0, c.vocab_size,
                                             (B, COST_PROMPT), generator=gen,
                                             device="cuda")}
            with torch.no_grad():
                traced = OA.trace(lambda p, b: prefill(p, b, c),
                                  OA.meta_like(params), OA.meta_like(batch))
                _, counted, dev = _counted_step(
                    torch, lambda: prefill(params, batch, c))
            report(f"mamba2 {COST_PROMPT}-token prompt pass", traced,
                   counted, dev)
        del params
        mparams = None
        torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-e2e", action="store_true",
                    help="stop after the kernel checks")
    args = ap.parse_args(argv)
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    phase("[phase 1] device and build")
    card = card_line()
    log(f"  card: {card}")
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"  built {sorted(secs)} in {time.perf_counter() - t0:.1f} s "
        f"(parallel nvcc, sm_90a)")
    for name in _build.KERNELS:
        for ln in _build.ptxas_report(name):
            log(f"    {name}: {ln}")
    tc_libs = ("morph_matmul", "flash_attention", "fused_decode",
               "flash_decode", "fused_verify", "ssd_scan")
    with concurrent.futures.ThreadPoolExecutor(len(tc_libs)) as pool:
        for name, sass in zip(tc_libs, pool.map(sass_mma, tc_libs)):
            log(f"  {name}: {sass}")

    cfg = get_config("tinyllama-1.1b")
    mcfg = get_config("mamba2-370m")
    timer = Timer(torch)
    phase("[phase 2] kernels vs plain versions (full TinyLlama shapes, bf16)")
    read_rate(torch, timer, cfg)
    mm = check_morph_matmul(torch, cfg, timer)
    mmv = check_morph_matmul_verify(torch, cfg, timer)
    mm64 = check_morph_matmul_verify(torch, cfg, timer, S=8)
    log(f"  morph_matmul per TinyLlama layer: 40 rows / 8 rows = "
        f"{mmv['ms'] / mm['ms']:.2f}x, 64 rows / 8 rows = "
        f"{mm64['ms'] / mm['ms']:.2f}x")
    fd = check_fused_decode(torch, cfg, timer)
    fv = check_fused_verify(torch, cfg, timer)
    rc = check_replay_chunk(torch, cfg, timer)
    pg = check_paged(torch, cfg, timer)
    tv = check_tree_verify(torch, cfg, timer)
    fa = check_flash_attention(torch, cfg, timer)
    fdk = check_flash_decode(torch, cfg, timer)
    phase("[phase 2] fused decode and verify at the MoE families' attention "
          "shapes (granite: group 2; jamba: group 4, no RoPE)")
    moe_attn = check_fused_attention_shapes(torch, timer)
    phase("[phase 2] whisper-base and internvl2-2b shapes: the cross-"
          "attention decode on flash_decode, the gated projections, the "
          "fused decode layer")
    cross = check_cross_decode(torch, timer)
    mmf = check_morph_matmul_frontend(torch, timer)
    ed_attn = check_fused_attention_shapes(torch, timer, archs=FRONTEND_ARCHS,
                                           whats=("decode",))
    phase(f"[phase 2] morph_matmul, fused decode and fused verify at "
          f"TinyLlama's tp = {MESH_TP} shard shapes")
    shard = check_shard_shapes(torch, cfg, timer)
    phase(f"[phase 2] morph_matmul, fused decode and verify, flash_decode "
          f"and flash_attention at the granite, whisper and internvl tp = "
          f"{MESH_TP} shard shapes")
    fam = check_family_shard_shapes(torch, timer)
    phase("[phase 2] kernels vs plain versions (full Mamba2-370M shapes)")
    mms, mmsv = check_morph_matmul_ssm(torch, mcfg, timer)
    ssd = check_ssd_scan(torch, mcfg, timer)
    phase("[phase 2] ssd_scan and its backward at the Mamba2 mesh train "
          "step's rank shapes")
    ssd_tr = check_ssd_train_shards(torch, mcfg, timer)
    torch.cuda.empty_cache()

    launches = {p[0]: dict.fromkeys(KERNEL_NAMES)
                for p in (PATHS + SSM_PATHS + MOE_PATHS + PAGED_PATHS
                          + TRAINED_PATHS + ENCDEC_PATHS + VLM_PATHS
                          + tuple((t,) for t in ENCDEC_DRIVES + VLM_DRIVES)
                          + (("flash_decode_entry",), ("mamba2_train",),
                             ("tinyllama_train",), ("whisper_train",)))}
    paged_launches = {p[0]: dict.fromkeys(("fused_decode", "fused_verify"))
                      for p in PAGED_PATHS}
    max_err = max(r["max_abs_err"] for r in tv.values())
    failover_launches, failover_res = {}, {}
    autoscale_launches, autoscale_res = {}, {}
    mesh_launches, mesh_res = {}, {}
    train_mesh_launches, train_mesh_res = {}, {}
    if not args.skip_e2e:
        phase("[phase 3] end to end: tinyllama-1.1b, full width, 8 of its "
              "22 layers, one card")
        smoke_reference(torch)
        smoke_tree_engines(torch)
        # 8 of its 22 layers (exits 4 and 6): the run's time
        tcut = depth_cut(cfg, 8, (4, 6))
        params = init_on_card(torch, tcut)
        # 10 requests on 8 slots: the queued 2 are admitted at later modes
        launches, _ = end_to_end(torch, tcut, params, timer, n_requests=10)
        phase("[phase 3] end to end: tinyllama-1.1b over a block-paged KV "
              "cache, one card")
        pl, paged_launches, _ = paged_end_to_end(torch, tcut, params)
        launches.update(pl)
        prompt_pass_ms(torch, params, tcut)
        del params
        torch.cuda.empty_cache()
        phase("[phase 3] the flash_decode entry point at the serving cache's "
              "shape")
        launches["flash_decode_entry"] = flash_decode_drive(torch, cfg)
        phase("[phase 3] end to end: mamba2-370m, full width, 8 of its 48 "
              "layers, one card")
        smoke_reference(torch, "mamba2-370m")
        smoke_tree_engines(torch, "mamba2-370m")
        # a sixth of its depth: the later phases share the run's time; 10
        # requests on 8 slots
        mcut = depth_cut(mcfg, 8, (4, 6))
        mparams = init_on_card(torch, mcut)
        ssm_launches, _ = end_to_end(torch, mcut, mparams,
                                     timer, n_requests=10, paths=SSM_PATHS,
                                     expect=expected_launches_ssm,
                                     agreements=SSM_AGREE)
        launches.update(ssm_launches)
        phase("[phase 3] an 8-layer Mamba2-370M prompt pass")
        prompt_pass_ms(torch, mparams, mcut, impls=(None,))
        del mparams
        torch.cuda.empty_cache()
        phase("[phase 3] end to end: granite-moe-1b-a400m, full width, one "
              "card")
        smoke_reference(torch, "granite-moe-1b-a400m")
        smoke_reference(torch, "mixtral-8x22b", sliding_window=8)
        smoke_reference(torch, "jamba-v0.1-52b")
        # a quarter of its depth (6 of 24 layers, exits 3 and 4; full depth
        # until the mesh phase came, 12 layers until its PR 26 drives, which
        # serve granite at full depth): the later phases share the run's
        # time
        gcfg = depth_cut(get_config("granite-moe-1b-a400m"), 6, (3, 4))
        gparams = init_on_card(torch, gcfg)
        moe_launches, _ = end_to_end(torch, gcfg, gparams, timer,
                                     n_requests=12, paths=MOE_PATHS,
                                     expect=expected_launches_moe,
                                     agreements=MOE_AGREE)
        launches.update(moe_launches)
        del gparams
        torch.cuda.empty_cache()
        phase("[phase 3] end to end: whisper-base (encoder-decoder), full "
              "width, one card")
        ed_launches, ed_res = encdec_phase(torch, timer)
        launches.update(ed_launches)
        phase("[phase 3] end to end: internvl2-2b (vision frontend), full "
              "width, one card")
        vl_launches, vl_res = vlm_phase(torch, timer)
        launches.update(vl_launches)
        log("  encoder-decoder and frontend drives: " + json.dumps(
            {**ed_res, **vl_res}))
        phase("[phase 3] failover: snapshot, restore by chunked replay and "
              "ExecutorSupervisor chaos drives, full width, one card")
        failover_launches, failover_res = failover_phase(torch)
        phase("[phase 3] the online autoscaler: live MOGA, background "
              "builds on their own stream, publish / retire under a table "
              "budget, a bare standby from a snapshot, full width, one card")
        autoscale_launches, autoscale_res = autoscale_phase(torch)
        phase(f"[phase 3] mesh serving: MeshExecutor at world size 1 over "
              f"NCCL, then tp = {MESH_TP} as two ranks sharing the card "
              f"over gloo (placement, not multi-card speed)")
        mesh_launches, mesh_res = mesh_phase(torch)
    bwd, train_launches, train_res = training_phase(
        torch, cfg, mcfg, timer, full=not args.skip_e2e)
    launches.update(train_launches)
    if not args.skip_e2e:
        phase("[phase 4] training: a 24-layer Mamba2-370M TrainRunner "
              "restart, bit for bit")
        failover_launches["mamba2_restart"], failover_res["mamba2_restart"] \
            = restart_drive(torch, depth_cut(mcfg, 24, (12, 18)))
        phase("[phase 4] training on a (data, model) mesh: attention under "
              "autograd off the flash kernel, the world-size-1 NCCL step, "
              "Mamba2-370M and TinyLlama-1.1B at (2, 1) and (1, 2) as two "
              "ranks sharing the card over gloo")
        train_mesh_launches, train_mesh_res = train_mesh_phase(
            torch, launches["fused_chunked"]["flash_attention"])
    phase("[phase 4] the op-trace cost walker held to the card: traced "
          "launches vs the counters, bytes vs step_bytes, memory vs "
          "max_memory_allocated")
    cost_res = cost_phase(torch, cfg, mcfg, card)

    # every check above raises on failure, so reaching here means each
    # kernel built, launched and matched its plain version. ``launches`` is
    # the count from the path the kernel carries (morph_matmul: the default
    # unfused TinyLlama engine; fused_decode: ``fused=True``; fused_verify:
    # greedy speculative ``fused=True``; ssd_scan: the plain Mamba2 engine's
    # prefills; flash_attention: the fused TinyLlama engine under
    # ``attn_impl="chunked"``, its prefills; flash_decode: its own entry
    # point, the reference's only caller, drive flash_decode_entry);
    # ``launches_by_path`` gives every path's own count, ``encdec_launches``
    # / ``vlm_launches`` whisper's and internvl's (flash_decode's model
    # path: whisper's cross-attention decode).
    status = "ok" if not args.skip_e2e else "ok (kernel checks only)"

    def by_path(name):
        return {p: c[name] for p, c in launches.items()}

    def granite(name):
        return {p[0]: launches[p[0]][name] for p in MOE_PATHS}

    def family(name, paths, drives):
        return {t: launches[t][name] for t in
                [p[0] for p in paths] + list(drives)}

    def encdec(name):
        return family(name, ENCDEC_PATHS, ENCDEC_DRIVES + ("whisper_train",))

    def vlm(name):
        return family(name, VLM_PATHS, VLM_DRIVES)

    def failover(name):
        return {d: c[name] for d, c in failover_launches.items()}

    def autoscale(name):
        return {d: c[name] for d, c in autoscale_launches.items()}

    def mesh(name):
        return {d: c[name] for d, c in mesh_launches.items()}

    def mesh_train(name):
        return {d: c[name] for d, c in train_mesh_launches.items()}

    def autoscale_builds(name):
        return {d: r["build_launches"][name] for d, r in
                autoscale_res.items()}

    def moe_shapes(kind):
        return {a: {w: r for w, r in res.items()
                    if w.startswith(kind)} for a, res in moe_attn.items()}

    def paged_summary(kind):
        return {v: {m: r[kind][m] for m in ("ms", "dense_ms", "plain_ms",
                                            "bound_ms", "bound_by",
                                            "max_abs_err", "attention")}
                for v, r in pg.items()}

    def others(res, main):
        return {k: {m: r[m] for m in ("ms", "plain_ms", "bound_ms",
                                      "library_ms")}
                for k, r in res.items() if r is not main}

    prompt = ssd["prompt S=256"]
    fa_main = fa["prompt S=256"]
    fd_main = fdk["serving bf16 kv_len=512"]
    kernels = [
        dict(name="morph_matmul", route="cuda", status=status,
             source="src/repro_torch/csrc/morph_matmul.cu",
             replaces="src/repro/kernels/morph_matmul.py:68",
             launches=launches["unfused"]["morph_matmul"],
             launches_by_path=by_path("morph_matmul"),
             granite_launches=granite("morph_matmul"),
             encdec_launches=encdec("morph_matmul"),
             vlm_launches=vlm("morph_matmul"),
             failover_launches=failover("morph_matmul"),
             autoscale_launches=autoscale("morph_matmul"),
             autoscale_build_launches=autoscale_builds("morph_matmul"),
             mesh_launches=mesh("morph_matmul"),
             shard_shapes_tp2=shard_row(shard["morph_matmul"]),
             family_shard_shapes_tp2={a: shard_row(r) for a, r in
                                      fam["morph_matmul"].items()},
             max_abs_err=max(mm["max_abs_err"], mmv["max_abs_err"],
                             shard["morph_matmul"]["max_abs_err"],
                             *(r["max_abs_err"] for r in
                               fam["morph_matmul"].values()),
                             mms["max_abs_err"], mmsv["max_abs_err"],
                             *(r["max_abs_err"] for r in mmf.values())),
             ms=mm["ms"], plain_ms=mm["plain_ms"], bound_ms=mm["bound_ms"],
             bound_by="bytes", library_ms=mm["library_ms"],
             wall_ms=mm["wall_ms"],
             verify_shape={k: mmv[k] for k in ("ms", "wall_ms", "plain_ms",
                                               "bound_ms", "library_ms")},
             rows64_shape={k: mm64[k] for k in ("ms", "wall_ms", "plain_ms",
                                                "bound_ms", "library_ms")},
             mamba2_layer={k: mms[k] for k in ("ms", "plain_ms", "bound_ms",
                                               "library_ms")},
             mamba2_verify_shape={k: mmsv[k] for k in ("ms", "plain_ms",
                                                       "bound_ms",
                                                       "library_ms")},
             frontend_layers={a: {k: r[k] for k in ("ms", "plain_ms",
                                                     "bound_ms", "library_ms",
                                                     "max_abs_err")}
                              for a, r in mmf.items()}),
        dict(name="fused_decode", route="cuda", status=status,
             source="src/repro_torch/csrc/fused_decode.cu",
             replaces="src/repro/kernels/fused_decode.py:377",
             launches=launches["fused"]["fused_decode"],
             launches_by_path=by_path("fused_decode"),
             granite_launches=granite("fused_decode"),
             encdec_launches=encdec("fused_decode"),
             vlm_launches=vlm("fused_decode"),
             failover_launches=failover("fused_decode"),
             autoscale_launches=autoscale("fused_decode"),
             autoscale_build_launches=autoscale_builds("fused_decode"),
             mesh_launches=mesh("fused_decode"),
             shard_shapes_tp2=shard_row(shard["fused_decode"]),
             family_shard_shapes_tp2={
                 a: r["decode"] for a, r in
                 list(fam["granite"].items()) + list(fam["frontend"].items())},
             moe_attention_shapes=moe_shapes("decode"),
             frontend_attention_shapes={a: r["decode"]
                                        for a, r in ed_attn.items()},
             max_abs_err=max(fd["max_abs_err"],
                             shard["fused_decode"]["max_abs_err"], max(
                 r["decode"]["max_abs_err"] for r in list(moe_attn.values())
                 + list(ed_attn.values()) + list(fam["granite"].values())
                 + list(fam["frontend"].values()))),
             ms=fd["ms"],
             plain_ms=fd["plain_ms"], bound_ms=fd["bound_ms"],
             bound_by=fd["bound_by"], library_ms=None,
             per_launch=fd["per_launch"],
             attention_plan=dict(splits=fd["splits"],
                                 rows_per_split=fd["rows_per_split"]),
             paged=paged_summary("decode"),
             paged_launches_by_path={p: c["fused_decode"]
                                     for p, c in paged_launches.items()}),
        dict(name="fused_verify", route="cuda", status=status,
             source="src/repro_torch/csrc/fused_verify.cu",
             replaces="src/repro/kernels/fused_decode.py:621",
             launches=launches["spec_fused"]["fused_verify"],
             launches_by_path=by_path("fused_verify"),
             granite_launches=granite("fused_verify"),
             failover_launches=failover("fused_verify"),
             autoscale_launches=autoscale("fused_verify"),
             autoscale_build_launches=autoscale_builds("fused_verify"),
             mesh_launches=mesh("fused_verify"),
             shard_shapes_tp2=shard_row(shard["fused_verify"]),
             family_shard_shapes_tp2={
                 a: r["verify linear"] for a, r in fam["granite"].items()},
             autoscale_verify_s5_serving={
                 d: r["verify_s5_serving"] for d, r in autoscale_res.items()},
             replay_chunk={k: rc[k] for k in (
                 "rows", "max_abs_err", "ms", "wall_ms", "paged_ms",
                 "plain_ms", "bound_ms", "bound_by", "per_launch",
                 "attention")},
             moe_attention_shapes=moe_shapes("verify"),
             max_abs_err=max(fv["max_abs_err"], rc["max_abs_err"], max_err,
                             shard["fused_verify"]["max_abs_err"], *(
                                 r["verify linear"]["max_abs_err"]
                                 for r in fam["granite"].values()), max(
                 r[w]["max_abs_err"] for r in moe_attn.values()
                 for w in ("verify linear", "verify tree"))), ms=fv["ms"],
             plain_ms=fv["plain_ms"], bound_ms=fv["bound_ms"],
             bound_by=fv["bound_by"], library_ms=None,
             check_pass_ms=fv["check_pass_ms"], per_launch=fv["per_launch"],
             attention_plan=dict(splits=fv["splits"],
                                 rows_per_split=fv["rows_per_split"]),
             paged=paged_summary("verify"),
             paged_launches_by_path={p: c["fused_verify"]
                                     for p, c in paged_launches.items()},
             tree={k: {m: r[m] for m in ("nodes", "max_abs_err", "ms",
                                         "paged_ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms",
                                         "attention", "attention_plan")}
                   for k, r in tv.items()},
             tree_launches=launches["tree_fused"]["fused_verify"]),
        dict(name="ssd_scan", route="cuda", status=status,
             source="src/repro_torch/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan.py:27",
             launches=launches["mamba2_plain"]["ssd_scan"],
             launches_by_path=by_path("ssd_scan"),
             failover_launches=failover("ssd_scan"),
             mesh_launches=mesh("ssd_scan"),
             mesh_train_launches_per_rank=mesh_train("ssd_scan"),
             train_shard_shapes={k: r["forward"] for k, r in ssd_tr.items()},
             max_abs_err=max([r["max_abs_err"] for r in ssd.values()]
                             + [r["forward"]["max_abs_err"]
                                for r in ssd_tr.values()]),
             ms=prompt["ms"], plain_ms=prompt["plain_ms"],
             bound_ms=prompt["bound_ms"], bound_by=prompt["bound_by"],
             library_ms=None, per_launch=prompt["per_launch"],
             other_shapes={k: {m: r[m] for m in ("ms", "plain_ms",
                                                  "bound_ms", "per_launch")}
                           for k, r in ssd.items() if r is not prompt}),
        dict(name="flash_attention", route="cuda", status=status,
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:26",
             launches=launches["fused_chunked"]["flash_attention"],
             launches_by_path=by_path("flash_attention"),
             encdec_launches=encdec("flash_attention"),
             vlm_launches=vlm("flash_attention"),
             failover_launches=failover("flash_attention"),
             mesh_launches=mesh("flash_attention"),
             train_step_s4096_chunked_launches=train_mesh_res.get(
                 "chunked_train", {}).get("chunked", {}).get("launches"),
             mesh_train_launches_per_rank=mesh_train("flash_attention"),
             shard_shapes_tp2=others(fam["flash_attention"], None),
             max_abs_err=max(r["max_abs_err"] for r in list(fa.values())
                             + list(fam["flash_attention"].values())),
             ms=fa_main["ms"], plain_ms=fa_main["plain_ms"],
             bound_ms=fa_main["bound_ms"], bound_by=fa_main["bound_by"],
             library_ms=fa_main["library_ms"], library=fa_main["library"],
             other_shapes=others(fa, fa_main)),
        dict(name="flash_decode", route="cuda", status=status,
             source="src/repro_torch/csrc/flash_decode.cu",
             replaces="src/repro/kernels/flash_decode.py:31",
             launches=launches["flash_decode_entry"]["flash_decode"],
             launches_by_path=by_path("flash_decode"),
             encdec_launches=encdec("flash_decode"),
             vlm_launches=vlm("flash_decode"),
             launched_on="its own entry point (drive flash_decode_entry, "
                         "the reference's only caller; launches and the "
                         "times at the serving cache's shape) and "
                         "whisper-base's cross-attention decode (1 launch "
                         "per decoder layer-step, every whisper drive: "
                         "encdec_launches; times at that shape: "
                         "cross_attention)",
             cross_attention=cross,
             mesh_launches=mesh("flash_decode"),
             cross_attention_shard_tp2=fam["flash_decode"],
             max_abs_err=max(r["max_abs_err"] for r in list(fdk.values())
                             + list(cross.values())
                             + list(fam["flash_decode"].values())),
             ms=fd_main["ms"], plain_ms=fd_main["plain_ms"],
             bound_ms=fd_main["bound_ms"], bound_by=fd_main["bound_by"],
             library_ms=fd_main["library_ms"],
             other_shapes=others(fdk, fd_main),
             empty_kernel_floor_ms={k: r["floor_ms"] for k, r in fdk.items()
                                    if "floor_ms" in r},
             skeleton_ms={k: r["skeleton_ms"] for k, r in fdk.items()
                          if "skeleton_ms" in r}),
    ]
    bwd_main = bwd["train f32"]
    kernels.append(dict(
        name="ssd_scan_bwd", route="cuda", status=status,
        source="src/repro_torch/csrc/ssd_scan_bwd.cu",
        replaces="src/repro/kernels/ssd_scan.py:27",
        replaces_note="the backward of that kernel's function, which has no "
                      "Pallas backward: the reference differentiates "
                      "ssd_chunked (src/repro/models/ssm.py:78) with XLA",
        launches=launches["mamba2_train"]["ssd_scan_bwd"],
        launches_by_path=by_path("ssd_scan_bwd"),
        failover_launches=failover("ssd_scan_bwd"),
        mesh_train_launches_per_rank=mesh_train("ssd_scan_bwd"),
        train_shard_shapes={k: r["backward"] for k, r in ssd_tr.items()},
        max_abs_err=max([r["max_abs_err"] for r in bwd.values()]
                        + [r["backward"]["max_abs_err"]
                           for r in ssd_tr.values()]),
        ms=bwd_main["ms"], plain_ms=bwd_main["plain_ms"],
        bound_ms=bwd_main["bound_ms"], bound_by=bwd_main["bound_by"],
        library_ms=None, per_launch=bwd_main["per_launch"],
        other_shapes={k: {m: r[m] for m in ("ms", "plain_ms", "bound_ms",
                                             "max_abs_err")}
                      for k, r in bwd.items() if r is not bwd_main}))
    phase("[phase 5] summary")
    if train_res:
        log("  training: " + json.dumps(
            {k: {m: v for m, v in r.items() if m not in ("history",
                                                          "base_losses")}
             for k, r in train_res.items()}))
    if failover_res:
        log("  failover: " + json.dumps(failover_res))
    if autoscale_res:
        log("  autoscale: " + json.dumps(autoscale_res))
    if mesh_res:
        log("  mesh: " + json.dumps(mesh_res))
    if train_mesh_res:
        log("  train mesh: " + json.dumps(train_mesh_res))
    log("  cost phase: " + json.dumps(cost_res))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
