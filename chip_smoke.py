#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repo root on a machine with a CUDA card and ``nvcc``.  Phases,
each of which raises on failure (the script then exits non-zero and prints
no result):

1. environment: the card's name and power limit, torch/CUDA/nvcc versions;
   TF32 off for float32 matmuls and convolutions;
2. build: the hand-written kernels from ``src/repro_torch/kernels/csrc``;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, at the offline and serving paths' shapes, in float32 and bfloat16,
   with kernel, plain and library times and the bound from bytes and
   operations (attention: each case's body, tensor-core or CUDA-core, and
   KV split count, with split cases on long caches; the copy-on-write fork
   also: in place, no pool-sized allocation, aliased lists refused; the SSD
   chunk step at mamba2-370m's decode, prefill, two-group and ragged
   shapes, bf16 on the tensor-core body and f32 on the CUDA-core body, each
   heads-per-block choice timed at the decode and prefill shapes; the K/V
   scatters at LLaDA's 8 KB and Dream's 1 KB rows, dense and paged, under
   the serving masks, each with its block shape; the host µs and the
   kernels of one masked ``ops.scatter_rows_paged`` call, which must be
   1; the importance score at LLaDA's, Dream's and mamba2-370m's widths,
   on contiguous planes and through a skip stage's ``idx``, and the
   variation score at LLaDA's and Dream's, each with its block shape; the
   host µs and kernels of one indexed ``ops.importance_score``
   call, which must be 1; paged attention and the paged scatter at a
   sparse-served layout, with evicted rows and reclaimed pages, each beside
   the same call without the holes); the int8 KV cache's kernels: dense
   and paged attention on int8 codes with their scales (1q, 2q: bf16 on
   the tensor-core body, f32 on the CUDA-core body, every mask option,
   a split long cache; each beside the bf16 kernel on the dequantized
   cache and "dequantize + SDPA"), the quantizing scatter dense and paged
   (3q, 4q: LLaDA's 128-byte and Dream's 16-byte scale rows, with and
   without masks, codes and scales bit-equal to the plain version, one
   kernel per ``ops`` call) and the fork of the scale pools (5q); kernels
   1, 2, 1q and 2q at gemma3-1b's head_dim 256 (Lq 32, 4 query heads on 1
   KV head; a dense cache of 704 rows, 4 paged slots of 704, a split cache
   of 4096; window 512 and off; bf16 on the tensor-core body, f32 on the
   CUDA-core body) and the K/V scatters at its 512-byte rows; the SSD
   chunk step at Jamba's widths (128 heads of 64, d_state 64), its served
   decode and offline prefill shapes, bf16 on the tensor-core body and f32
   on the CUDA-core body (8j), and at a TP-2 rank's 64 heads (8t); kernel
   1 as the vision model's
   cross-attention (1x: Lq 32 over 1,601 keys, 32 on 8 heads of 128),
   SeamlessM4T's (1xs: 256 keys, 16 heads of 64) and its encoder's
   attention (1e: 256 x 256, D 64), and SeamlessM4T's at a TP-2 rank's 8
   heads (1xt), both bodies, each beside SDPA; the
   threefry key chain's known answers on the card, a draw of the sampled
   path's shape with bits equal to the CPU's, and the draw's time;
4. cross-device checks on reduced models in float32, the card (kernels)
   against the CPU (plain versions): offline ES generation (greedy tokens
   equal, final-block confidences within 1e-4); a staggered request trace
   through the paged ``StreamScheduler`` with early advance, parallel
   decoding (so blocks fill early and rows advance before their phase wrap)
   and the adaptive cache (every request's tokens equal); sampled serving
   with prefix sharing on LLaDA and Dream (top-p), two duplicate-prompt
   cohorts forking (tokens equal on the card, the CPU and the card's
   unshared run); sampled preemption (tokens equal the uninterrupted run);
   quarantine of a row with NaN written into its page; reduced mamba2-370m
   es greedy and sampled, and served on dense slots (tokens equal);
   Sparse-dLLM eviction offline dense and paged (tokens and the retained
   set equal), sparse serving with page reclaim (``pages_reclaimed`` equal
   and > 0), lazy reservation on a tight pool (a stall and a growth, the
   lazy gauges equal); the int8 cache offline es, dense and paged, on
   LLaDA and Dream (tokens equal), served with prefix sharing and with
   preemption (tokens equal), and ``gather_refresh`` served with the
   adaptive cache off and on (tokens equal the CPU's and the card's without
   it, the compact branch ran); reduced olmoe-1b-7b (capacity factor 0.5:
   picks drop), granite-moe-1b-a400m, gemma3-1b (window 16, every second
   layer global, prompt 40) and chatglm3-6b offline es (tokens equal), and
   gemma3 and olmoe served through the paged scheduler (tokens equal);
   reduced Jamba (16 layers, two periods; capacity factor 0.5, weights x2)
   offline es (tokens equal), and served on the paged pool with sampled
   prefix sharing (forks) and with preemption (a spill; tokens equal);
   reduced llama-3.2-vision-11b (with ``enc_proj``) and seamless-m4t-large-v2
   offline es with ``enc_embeds`` (tokens equal; SeamlessM4T greedy and
   sampled), kernel 1 launched as cross-attention and in the encoder;
5. offline path: LLaDA-8B at full width in bfloat16, ``DEPTH_5`` of its 32
   layers (random weights from a seeded generator on the card), ES
   generation, with each kernel's launches counted over that run;
6. serving path: the same model through the paged ``StreamScheduler``
   (early advance, adaptive cache) with staggered requests, launches
   counted over that run;
7. sampled serving: Dream-7B at full width in bfloat16, depth cut to
   ``DEPTH_7`` of its 28 layers, through the paged scheduler, temperature 0.2 and top-p 0.95, the same requests three
   times: with prefix sharing (7a: the copy-on-write fork runs), with
   preemption on a tight pool (7b: a class-1 arrival spills a class-0
   resident, which resumes) and with neither (7c);
8. Mamba-2: mamba2-370m at full width in bfloat16 (seeded random weights
   on the card), depth cut to ``MAMBA_LAYERS`` of its 48 layers, offline es
   and dualcache generation and the dense-slot ``StreamScheduler`` with
   early advance, through the SSD chunk kernel;
9. block-causal ES-dLLM with the sliding window: LLaDA-8B at full width,
   depth cut to ``DEPTH_9_10`` layers, offline and through the paged
   scheduler with the persistent prefix store;
10. Sparse-dLLM eviction and lazy page reservation: phase 9's model
   offline with es+sparse and sparse-only (each ``generate`` timed in turns
   with es), then a lazy, windowed, sparse trace through
   the paged scheduler (every request completes; pages are deferred at
   admission, an extent grows, a row stalls and resumes, a page is
   reclaimed; one window of its repeated run's steps profiled);
11. the int8 KV cache and ``gather_refresh``: LLaDA-8B (phase 5's model)
   offline es with ``kv_cache_dtype="int8"`` timed in turns with bf16 (11a:
   wall, attention and scatter device ms, KV bytes, tokens equal to
   bf16's), phase 6's trace with the int8 cache and ``gather_refresh`` (11b:
   against phase 6 of the same run; the compact branch must run), and a
   sampled prefix-sharing trace of two duplicate cohorts (11c: the scale
   pools fork);
12. the rest of the serving runtime: LLaDA-8B (phase 5's model) through the
   lock-step ``BatchServer`` at batch 8, 16 requests in two batches (12a:
   ``stats.tps``, each batch's wall, the first batch's tokens equal to one
   ``engine.generate`` of the same prompts and key), and phase 6's trace
   through ``ShardedStreamScheduler`` with 2 lanes on the one card (12b:
   (i) least loaded, (ii) disaggregated, a refresh lane at prompt 128 and a
   decode lane at 64; page conservation checked after every step; each
   decode-lane request of (ii) equal to its single-shard replay);
13. the MoE and remaining dense archs at full width in bfloat16 (seeded
   random weights on the card): olmoe-1b-7b (13a: depth cut to
   ``DEPTH_13A`` of its 16 layers, 64 experts top-8) offline es at phase 5's shape and phase 6's served trace, the
   share of routing picks dropped at capacity over one prefill and one
   decode, and one profiled window of the served trace split into the
   expert matmuls, the rest of the MoE FFN and kernels 2 and 4;
   gemma3-1b (13b: depth cut to ``DEPTH_13B`` of its 26 layers, head_dim
   256, window 512 on its local layers)
   offline es at prompt 640 and served with prompts of 544-640, its
   attention launches carrying the window on the local layers only; and
   one offline es ``generate`` each of llama3-8b, qwen2-1.5b, chatglm3-6b
   and granite-moe-1b-a400m at full width, depth cut to ``DEPTH_13C`` (13c);
14. the Jamba hybrid: jamba-v0.1-52b at full width in bfloat16 (seeded
   random weights on the card), two of its four periods (16 layers), every
   earlier model freed first: offline es at phase 5's shape, three timed
   ``generate`` calls and one dualcache, the launches per kernel, the MoE
   share of picks dropped, a profiled ``generate``'s busy share and its
   device ms split into kernels 1, 3, 6, 8, the MoE FFN and the rest (14a);
   phase 6's served trace on the paged pool with early advance and no
   adaptive cache, run twice with equal tokens (14b); a sampled
   duplicate-cohort trace with prefix sharing (forks), then preemption on a
   tight pool (a spill and a resume) (14c);
15. the encoder-conditioned archs at full width in bfloat16 (seeded random
   weights and ``enc_embeds`` made on the card): llama-3.2-vision-11b,
   ``DEPTH_15A`` of its 40 layers (cross layers over 1,601 image tokens),
   offline es at phase 5's shape, timed twice (equal tokens) and
   dualcache, kernel 1's launches as self- and as cross-attention, the
   cross planes' bytes, a profiled
   ``generate``'s busy share and the cross-attention's device ms (15a);
   phase 6's trace on the paged pool without the adaptive cache, with a
   profiled window, then 7b's plan on its tight pool (spills, and every
   resume encoded again: ``Model.encode`` counted) (15b);
   seamless-m4t-large-v2, 24 decoder and 6 encoder layers, offline es
   greedy (a block's [mask] rows tie: each block unmasks in its prefill)
   and sampled, and phase 6's trace on a paged pool with no K/V plane, run
   twice with equal tokens (15c);
16. training: qwen2-1.5b at full width and depth (28 layers, 1.544 B
   parameters) in its config's float32, seeded random weights made on the
   card, 8 ``make_train_step`` steps with remat on synthetic 4 x 512
   batches (CE chunks of 256, lr 1e-3, warmup 1): every loss finite and
   falling, no hand-written kernel launched; s a step, tokens/s, TFLOP/s
   and peak memory.  Phase 4 also trains reduced qwen2-1.5b and
   olmoe-1b-7b two steps on the card against the CPU (losses, the
   parameters' moves, no kernel launch) and checks that every kernel
   wrapper refuses an input that requires grad;
17. tensor parallelism: LLaDA-8B at TP 2, two processes on the one card,
   one rank each, over gloo (its ``all_reduce`` takes CUDA tensors through
   the host; NCCL refuses two ranks on one card): f32 at ``TP_DEPTH_A``
   layers, one block offline es greedy, every rank's tokens equal to TP 1's
   (17a); bf16 at ``TP_DEPTH_B`` layers, one offline generate of one block
   and phase 6's served trace cut to three requests, per-rank memory,
   times, all-reduces a step and the device time inside them (17b); the dry
   run of 17b's configuration (``launch/dryrun.py`` on fake tensors: its
   rank-0 ``argument_size`` must equal rank 0's measured bytes of
   parameters and state) and the single-pod dry runs of llada-8b and
   dream-7b at decode_32k (17c).  Phase 3 also holds kernels 1-4 at the 16
   heads a TP-2 rank launches them with;
18. tensor parallelism on the SSM, hybrid, cross-attention and encoder
   stacks, in phase 17's two ranks: mamba2-370m (8 of 48 layers) and
   seamless-m4t-large-v2 (uncut) in f32, one block offline es greedy, every
   rank's tokens equal to TP 1's and confidences within 1e-4 (18a);
   jamba-v0.1-52b at 16 of 32 layers in bf16, one offline generate of one
   block and phase 6's served trace cut to three requests, ``ssm`` and
   ``ssm_norm`` all-reduces once a mixer layer and pass, kernel 8 at the
   rank's 64 of 128 SSM heads, per-rank memory, times and the device time
   inside the all-reduces (18b); the dry run of 18b's configuration
   (rank-0 ``argument_size`` equal to the measured bytes) and the
   single-pod dry runs of jamba-v0.1-52b at all 32 layers and
   llama-3.2-vision-11b at decode_32k (18c).  Phase 3 also holds kernel 8
   at a TP-2 rank's 64 Jamba heads (decode and prefill) and kernel 1 as
   SeamlessM4T's cross-attention at 8 of 16 heads;
19. training under FSDP x TP: a ``(data=2, model=2)`` mesh of four gloo
   ranks sharing the card (``Model(mode="train")``, ``sharding/fsdp.py``),
   TF32 off in every rank: qwen2-1.5b at full width cut to 4 of 28 layers
   (19a) and mamba2-370m cut to 4 of 48 (19b), f32, two train steps of
   synthetic 4 x 256 batches (CE chunks of 128, lr 1e-3) against the same
   two steps at TP 1 in this process: losses within 1e-5 relative, grad
   norms within 1e-5 at step 1 and 1e-4 at step 2 (``fsdp_metric_rtol``),
   every rank's gathered parameters equal, the ranks that hold
   one piece of a leaf bit-equal, rank 0's gathered parameters within the
   bound ``fsdp_param_errs`` states of TP 1's, no hand-written kernel
   launched; s a step, per-rank memory, the all-reduces, all-gathers and
   reduce-scatters a step by site with their bytes and device ms (gloo
   through the host on one card, not a multi-card figure); the dry run of
   19a's configuration at ``debug=(2, 2)``, its ``argument_size`` equal to
   rank 0's measured bytes of parameters, moments, key and rows (19c).

On phases 5, 6, 7, 9, 10, 11, 12, 13, 14 and 15 every attention launch must take
the tensor-core body (on phase 11 reading int8 codes, with every K/V write the
quantizing scatter), and phases 5 and 6 must keep one attention launch per
call; on phase
9 every attention launch must carry the block-causal options; on phases 8
and 14 every SSD chunk launch must take the tensor-core body, and phase 8's
offline es ``generate`` must keep its 66 a layer.  Each path profile
sums the device time of the port's kernels over its whole trace.

The second-to-last line is the ``kernels`` JSON record, the last line
``{"ok": true, "device": {...}}``.  Details also go to
``build/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 3.35 TB/s,
# 989 TFLOP/s bf16 tensor cores, 67 TFLOP/s float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

SEED = 0
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:146",
    "paged_flash_attention": "src/repro/kernels/flash_attention.py:208",
    "scatter_rows": "src/repro/kernels/scatter_kv.py:45",
    "scatter_rows_paged": "src/repro/kernels/scatter_kv.py:78",
    "importance": "src/repro/kernels/importance.py:30",
    "variation": "src/repro/kernels/importance.py:66",
    "fork_pages": "src/repro/kernels/scatter_kv.py:122",
    "ssd_chunks": "src/repro/kernels/ssd_scan.py:70",
    # the int8 cache's forms of the same TPU kernels
    "flash_attention_int8": "src/repro/kernels/flash_attention.py:146",
    "paged_flash_attention_int8": "src/repro/kernels/flash_attention.py:208",
    "quantize_scatter_rows": "src/repro/kernels/scatter_kv.py:45",
    "quantize_scatter_rows_paged": "src/repro/kernels/scatter_kv.py:78",
    "fork_pages_scales": "src/repro/kernels/scatter_kv.py:122",
    # gemma3's head_dim 256 (the TPU kernels take any D % 128 == 0)
    "flash_attention_d256": "src/repro/kernels/flash_attention.py:146",
    "paged_flash_attention_d256": "src/repro/kernels/flash_attention.py:208",
    # Jamba's SSD widths
    "ssd_chunks_jamba": "src/repro/kernels/ssd_scan.py:70",
    # kernel 1 as the encoder archs' cross-attention and encoder attention
    "flash_attention_cross": "src/repro/kernels/flash_attention.py:146",
    "flash_attention_cross_seamless": "src/repro/kernels/flash_attention.py:146",
    "flash_attention_encoder": "src/repro/kernels/flash_attention.py:146",
    # kernels 1-4 at the head counts a tensor-parallel rank launches them with
    "flash_attention_tp2": "src/repro/kernels/flash_attention.py:146",
    "paged_flash_attention_tp2": "src/repro/kernels/flash_attention.py:208",
    "scatter_rows_tp2": "src/repro/kernels/scatter_kv.py:45",
    "scatter_rows_paged_tp2": "src/repro/kernels/scatter_kv.py:78",
    # kernels 8 and 1 at a TP-2 rank's SSM and cross-attention heads (phase 18)
    "ssd_chunks_tp2": "src/repro/kernels/ssd_scan.py:70",
    "flash_attention_cross_tp2": "src/repro/kernels/flash_attention.py:146",
}
SOURCES = {
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "paged_flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "scatter_rows": "src/repro_torch/kernels/csrc/scatter_kv.cu",
    "scatter_rows_paged": "src/repro_torch/kernels/csrc/scatter_kv.cu",
    "importance": "src/repro_torch/kernels/csrc/importance.cu",
    "variation": "src/repro_torch/kernels/csrc/importance.cu",
    "fork_pages": "src/repro_torch/kernels/csrc/scatter_kv.cu",
    "ssd_chunks": "src/repro_torch/kernels/csrc/ssd_scan.cu",
    "flash_attention_int8": "src/repro_torch/kernels/csrc/flash_tc.cuh",
    "paged_flash_attention_int8": "src/repro_torch/kernels/csrc/flash_tc.cuh",
    "quantize_scatter_rows": "src/repro_torch/kernels/csrc/scatter_kv.cu",
    "quantize_scatter_rows_paged": "src/repro_torch/kernels/csrc/scatter_kv.cu",
    "fork_pages_scales": "src/repro_torch/kernels/csrc/scatter_kv.cu",
    "flash_attention_d256": "src/repro_torch/kernels/csrc/flash_tc.cuh",
    "paged_flash_attention_d256": "src/repro_torch/kernels/csrc/flash_tc.cuh",
    "ssd_chunks_jamba": "src/repro_torch/kernels/csrc/ssd_scan.cu",
    "flash_attention_cross": "src/repro_torch/kernels/csrc/flash_tc.cuh",
    "flash_attention_cross_seamless": "src/repro_torch/kernels/csrc/flash_tc.cuh",
    "flash_attention_encoder": "src/repro_torch/kernels/csrc/flash_tc.cuh",
    "flash_attention_tp2": "src/repro_torch/kernels/csrc/flash_tc.cuh",
    "paged_flash_attention_tp2": "src/repro_torch/kernels/csrc/flash_tc.cuh",
    "scatter_rows_tp2": "src/repro_torch/kernels/csrc/scatter_kv.cu",
    "scatter_rows_paged_tp2": "src/repro_torch/kernels/csrc/scatter_kv.cu",
    "ssd_chunks_tp2": "src/repro_torch/kernels/csrc/ssd_scan.cu",
    "flash_attention_cross_tp2": "src/repro_torch/kernels/csrc/flash_attention.cu",
}
# the serving path's shapes: 4 slots of prompt 128 + gen 64 tokens, blocks of
# 32, partial refreshes of ceil(0.25 * (192 - 32)) = 40 tokens
SLOTS, PROMPT, GEN, BLOCK = 4, 128, 64, 32
T_TOTAL = PROMPT + GEN


def sh(*cmd: str) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return out.stdout.strip()


_FLUSH: list = []


def flush_l2() -> None:
    """Rewrites a 256 MB buffer (five times the H100's 50 MB L2), so the next
    call reads its inputs from HBM, as on the paths, where the rest of a
    layer's work passes through the L2 between two launches of a kernel (the
    L2 is left dirty, as by the ``zero_`` of Triton's ``do_bench``).  The
    flush is ``bitwise_not_`` on bytes, a kernel nothing timed here uses."""
    if not _FLUSH:
        _FLUSH.append(torch.zeros(256 << 20, dtype=torch.uint8, device="cuda"))
    _FLUSH[0].bitwise_not_()


TIMER_FALLBACKS: list = []     # (flushes, other kernels) of each incomplete trace
EVENT_TIMED: list = []         # calls of device_ms timed by CUDA events instead


def _is_flush(ev) -> bool:
    return "bitwise_not" in ev.name


def _is_copy(ev) -> bool:
    """A host-device copy (the fork wrapper uploads its page list): not a
    kernel's time."""
    return "Memcpy" in ev.name


def device_ms(fn, n: int = 20) -> tuple[float, float]:
    """(device ms per call, wall ms per call).  Device: the profiler's kernel
    records over ``n`` calls, each after an L2 flush, the flushes left out.
    Wall: CUDA events over ``n`` back-to-back calls with no flush, host
    launches included.  The profiler now and then loses kernel records; a
    trace counts only if it holds all ``n`` flushes and a multiple of ``n``
    other kernels.  After three traces that do not, CUDA events around each
    call stand in, with a spin kernel ahead of the start event so that the
    host has queued the call before the card reaches it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / n
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                flush_l2()
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
        flushes = sum(map(_is_flush, evs))
        timed = [ev.time_range.elapsed_us() for ev in evs
                 if not _is_flush(ev) and not _is_copy(ev)]
        if flushes == n and timed and len(timed) % n == 0:
            return sum(timed) / n / 1e3, wall
        TIMER_FALLBACKS.append((flushes, len(timed)))
    EVENT_TIMED.append(len(TIMER_FALLBACKS))
    total = 0.0
    for _ in range(n):
        flush_l2()
        torch.cuda._sleep(2_000_000)            # about 1 ms of spinning
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / n, wall


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def admitted_kv_rows(mask) -> torch.Tensor:
    """[B, Lkv] the K/V rows that at least one query row's ``mask [B, 1,
    Lq, Lkv]`` admits: the rows an attention call must read."""
    return mask[:, 0].any(dim=1)


ATTENTION = ("flash_attention", "paged_flash_attention")
TWO_BODIES = ATTENTION + ("ssd_chunks",)     # kernels with a tensor-core and a CUDA-core body
BODIES = ("tensor_core", "cuda_core")
# phases 5-6, 11 and 12's depth (one model): LLaDA-8B's 32 layers cut to 16
# beside phase 18, so that the script's phases stay within 850 s on the
# slower hosts (PERF.md §4)
DEPTH_5 = 16
# attention launches of one offline generate (phase 5) and one serving trace
# (phase 6) with the CUDA-core body, one per attention call and layer (64
# and 246 a layer): the tensor-core body must keep one launch per call
LAUNCHES_OFFLINE_GENERATE = 64 * DEPTH_5
LAUNCHES_SERVING_TRACE = 246 * DEPTH_5
# phases 9 and 10's depth: LLaDA-8B's 32 layers cut to 16 after 13c's cut,
# to 8 beside phase 15, then to 4 beside phase 18, so that the script's
# phases stay within 850 s (PERF.md §4)
DEPTH_9_10 = 4
# phase 8's depth: mamba2-370m's 48 layers cut to 6, so that the whole run
# with phases 9 and 10 stays within about the time phases 1-8 took at full
# depth; then to 4 beside phase 18 (PERF.md §4)
MAMBA_LAYERS = 4
# SSD chunk launches of one offline es mamba2 generate (phase 8), as the
# CUDA-core body made them: one per decode pass and two per prefill in each
# layer (66 a layer); the tensor-core body must keep them
SSD_LAUNCHES_ES_GENERATE = 66 * MAMBA_LAYERS


def zero_counts(kernel_fns) -> None:
    for fn in kernel_fns.values():
        fn.launches = 0
    for name in ATTENTION:
        kernel_fns[name].option_launches = {}
        kernel_fns[name].int8_launches = 0
    kernel_fns["fork_pages"].scale_launches = 0
    for name in TWO_BODIES:
        for body in BODIES:
            setattr(kernel_fns[name], f"{body}_launches", 0)


def counts(kernel_fns) -> dict:
    """Each kernel's launches, and each body's of the kernels that have two."""
    out = {name: fn.launches for name, fn in kernel_fns.items()}
    for name in TWO_BODIES:
        for body in BODIES:
            out[f"{name} {body}"] = getattr(kernel_fns[name], f"{body}_launches")
    for name in ATTENTION:                      # launches on int8 codes
        out[f"{name} int8"] = kernel_fns[name].int8_launches
    out["fork_pages scales"] = kernel_fns["fork_pages"].scale_launches
    return out


def check_tensor_core_path(launches: dict, where: str) -> None:
    """Every attention launch of a bf16 full-width path went through the
    tensor-core body."""
    for name in ATTENTION:
        if launches[f"{name} tensor_core"] != launches[name]:
            raise AssertionError(f"{where}: {launches[name]} {name} launches, only "
                                 f"{launches[name + ' tensor_core']} on the tensor-core body")


def check_ssd_tensor_core_path(launches: dict, where: str) -> None:
    """Every SSD chunk launch of a bf16 full-width mamba2 path went through
    the tensor-core body, and there was one."""
    n, tc = launches["ssd_chunks"], launches["ssd_chunks tensor_core"]
    if n <= 0 or tc != n:
        raise AssertionError(f"{where}: {n} ssd_chunks launches, {tc} on the tensor-core body")


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions
# ---------------------------------------------------------------------------
def flash_cases():
    """(label, B, Hq, Hkv, Lq, Lkv, D, pad, dtype, mask kwargs, kv_pos edits).
    pad > 0 takes q/k/v as the first D columns of rows D + pad wide, so their
    strides are not 16-byte multiples; that, f32, or D not a multiple of 16
    take the CUDA-core body.  One batch entry and few blocks make the
    tensor-core body split a long KV cache: at Lkv 1580, two splits of 13
    tiles (832 rows), the last ragged (748), with the edits masking all of
    split 0.  The "bc" edit is phase 9's offline shape: the first generated
    block (rows 128-159 of 256) under block-causal options, with the
    one-block window's clamp of kv_pos past row 192."""
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for lq, what in ((192, "prefill"), (32, "block"), (16, "skip1"), (8, "skip2")):
            cases.append((f"llada {what} Lq={lq}", 2, 32, 32, lq, 192, 128, 0, dt, {}, False))
        # the paged kernel's serving shape (4 slots), read densely
        cases.append(("llada block Lq=32 B=4", 4, 32, 32, 32, 192, 128, 0, dt, {}, False))
        cases.append(("dream gqa masked", 2, 28, 4, 32, 192, 128, 0, dt, {"causal": True}, True))
        cases.append(("dream gqa window+anchor+bc", 2, 28, 4, 32, 192, 128, 0, dt,
                      {"window": 24, "anchor": 16, "bc_start": 128, "bc_block": 32}, True))
        cases.append(("llada block Lq=32 Lkv=256 bc+window", 2, 32, 32, 32, 256, 128, 0, dt,
                      {"bc_start": 128, "bc_block": 32}, "bc"))
        cases.append(("llada split masked+ragged", 1, 32, 32, 32, 1580, 128, 0, dt,
                      {"causal": True}, "split"))
        cases.append(("dream gqa split masked+ragged", 1, 28, 4, 32, 1580, 128, 0, dt,
                      {"causal": True}, "split"))
        cases.append(("D=80 block", 2, 32, 32, 32, 192, 80, 0, dt, {}, False))
        cases.append(("D=96 gqa masked", 2, 28, 4, 32, 192, 96, 0, dt, {"causal": True}, True))
        cases.append(("D=72 block", 2, 32, 32, 32, 192, 72, 0, dt, {}, False))
        cases.append(("llada block unaligned strides", 2, 32, 32, 32, 192, 128, 2, dt, {}, False))
    return cases


# the heads of LLaDA-8B's 32 that a rank holds at TP 2 (phase 17)
TP_HEADS = 32 // 2


def check_tp_local(ref, fns, gen):
    """Kernels 1-4 at the head count a TP-2 rank launches them with in phase
    17 (LLaDA-8B's 16 of 32 heads of 128, bf16): the block's dense attention
    and K/V scatter at phase 5's shape (Lq 32 over 192 rows), the paged ones
    at phase 6's serving layout (4 slots, pages of 16); each against its
    plain version and timed as the other rows, beside its bound and its
    library call."""
    from repro_torch.kernels.flash_attention import plan as attn_plan
    from repro_torch.kernels.scatter_kv import plan as scatter_plan

    dt, h, d, lq = torch.bfloat16, TP_HEADS, 128, BLOCK

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    def timed(kernel, row, case, run, plain, lib_call, moved, flops, err, tol, **extra):
        if not err <= tol:
            raise AssertionError(f"{kernel} {case} {dt}: max abs err {err} > {tol}")
        ms, wall = device_ms(run)
        plain_ms, _ = device_ms(plain)
        lib_ms, _ = device_ms(lib_call)
        bms, by = bound(moved, flops, dt)
        return dict(kernel=kernel, row=row, case=case, dtype=str(dt), max_abs_err=err,
                    tol=tol, ms=ms, wall_ms=wall, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=bms, bound_by=by, **extra)
    out = []
    # kernel 1: the block's queries over the dense cache
    q, k, v = (randn(2, n, h, d).transpose(1, 2) for n in (lq, T_TOTAL, T_TOTAL))
    q_pos = torch.arange(T_TOTAL - lq, T_TOTAL, dtype=torch.int32,
                         device="cuda")[None].repeat(2, 1)
    kv_pos = torch.arange(T_TOTAL, dtype=torch.int32, device="cuda")[None].repeat(2, 1)
    args = (q, k, v, q_pos, kv_pos)
    got = fns["flash_attention"](*args)
    err = (got.float() - ref.attention_reference(*args).float()).abs().max().item()
    mask = ref.attention_mask(q_pos, kv_pos)[:, None]
    pl = attn_plan(q, k, v, T_TOTAL, h)
    kv_bytes = 2 * admitted_kv_rows(mask).sum().item() * h * d * k.element_size()
    out.append(timed("flash_attention", "flash_attention_tp2", f"llada tp2 block Lq={lq} H={h}",
                     lambda: fns["flash_attention"](*args),
                     lambda: ref.attention_reference(*args),
                     lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                     nbytes(q, q_pos, kv_pos, got) + kv_bytes, 4.0 * h * d * mask.sum().item(),
                     err, 2e-2, body=pl.body, n_splits=pl.n_splits, options={}, bidi_ms=None,
                     empty_splits=0))
    # kernel 2: the same through phase 6's page layout
    ps = 16
    bt, kv_pos, n_pages = serving_layout(gen, ps)
    kp, vp = randn(n_pages, ps, h, d), randn(n_pages, ps, h, d)
    q = randn(SLOTS, lq, h, d).transpose(1, 2)
    q_pos = torch.arange(PROMPT, PROMPT + lq, dtype=torch.int32,
                         device="cuda")[None].repeat(SLOTS, 1)
    args = (q, kp, vp, q_pos, kv_pos, bt)
    got = fns["paged_flash_attention"](*args)
    err = (got.float() - ref.paged_attention_reference(*args).float()).abs().max().item()
    mask = ref.attention_mask(q_pos, ref.paged_kv_mask(bt, kv_pos, ps))[:, None]
    phys = (bt.repeat_interleave(ps, dim=1).long() * ps
            + torch.arange(T_TOTAL, device="cuda") % ps)
    n_rows = phys[admitted_kv_rows(mask)].unique().numel()
    pl = attn_plan(q, kp, vp, T_TOTAL, h, ps)

    def gathered():
        return F.scaled_dot_product_attention(q, ref.gather_pages(kp, bt).transpose(1, 2),
                                              ref.gather_pages(vp, bt).transpose(1, 2),
                                              attn_mask=mask)
    out.append(timed("paged_flash_attention", "paged_flash_attention_tp2",
                     f"llada tp2 block Lq={lq} ps={ps} H={h}",
                     lambda: fns["paged_flash_attention"](*args),
                     lambda: ref.paged_attention_reference(*args), gathered,
                     nbytes(q, q_pos, kv_pos, bt, got) + 2 * n_rows * h * d * kp.element_size(),
                     4.0 * h * d * mask.sum().item(), err, 2e-2, body=pl.body,
                     n_splits=pl.n_splits, options={}, bidi_ms=None, empty_splits=0,
                     library="gather_pages + scaled_dot_product_attention"))
    # kernel 3: the block's K/V rows into the dense cache
    row_bytes = h * d * 2
    kc, vc, kn, vn = randn(2, T_TOTAL, h, d), randn(2, T_TOTAL, h, d), randn(2, lq, h, d), \
        randn(2, lq, h, d)
    idx = torch.stack([torch.randperm(T_TOTAL, generator=gen, device="cuda")[:lq]
                       for _ in range(2)]).to(torch.int32)
    want = (ref.scatter_rows_reference(kc.clone(), kn, idx),
            ref.scatter_rows_reference(vc.clone(), vn, idx))
    fns["scatter_rows"](((kc, kn), (vc, vn)), idx)
    if not (torch.equal(kc, want[0]) and torch.equal(vc, want[1])):
        raise AssertionError("scatter_rows tp2: not bit-exact")
    flat = (idx.long() + torch.arange(2, device="cuda")[:, None] * T_TOTAL).reshape(-1)
    fk, fv = kc.view(-1, h, d), vc.view(-1, h, d)
    sk, sv = kn.reshape(-1, h, d), vn.reshape(-1, h, d)
    out.append(timed("scatter_rows", "scatter_rows_tp2", f"llada tp2 block K={lq} H={h}",
                     lambda: fns["scatter_rows"](((kc, kn), (vc, vn)), idx),
                     lambda: (ref.scatter_rows_reference(kc, kn, idx),
                              ref.scatter_rows_reference(vc, vn, idx)),
                     lambda: (fk.index_copy_(0, flat, sk), fv.index_copy_(0, flat, sv)),
                     2 * 2 * 2 * lq * row_bytes + nbytes(idx), 0.0, 0.0, 0.0,
                     library="index_copy_ (K and V)", rows_written=2 * lq, row_bytes=row_bytes,
                     plan=dataclasses.asdict(scatter_plan(2, lq, 2, row_bytes))))
    # kernel 4: the same through phase 6's page layout
    kc, vc = randn(n_pages, ps, h, d), randn(n_pages, ps, h, d)
    kn, vn = randn(SLOTS, lq, h, d), randn(SLOTS, lq, h, d)
    idx = torch.stack([torch.randperm(T_TOTAL, generator=gen, device="cuda")[:lq]
                       for _ in range(SLOTS)]).to(torch.int32)
    want = (ref.scatter_rows_paged_reference(kc.clone(), kn, idx, bt),
            ref.scatter_rows_paged_reference(vc.clone(), vn, idx, bt))
    fns["scatter_rows_paged"](((kc, kn), (vc, vn)), idx, bt)
    if not (torch.equal(kc[1:], want[0][1:]) and torch.equal(vc[1:], want[1][1:])):
        raise AssertionError("scatter_rows_paged tp2: not bit-exact")
    page = torch.gather(bt.long(), 1, idx.long() // ps).clamp(min=0)
    dest = (page * ps + idx.long() % ps).reshape(-1)
    fk, fv = kc.view(-1, h, d), vc.view(-1, h, d)
    sk, sv = kn.reshape(-1, h, d), vn.reshape(-1, h, d)
    out.append(timed("scatter_rows_paged", "scatter_rows_paged_tp2",
                     f"llada tp2 block K={lq} ps={ps} H={h}",
                     lambda: fns["scatter_rows_paged"](((kc, kn), (vc, vn)), idx, bt),
                     lambda: (ref.scatter_rows_paged_reference(kc, kn, idx, bt),
                              ref.scatter_rows_paged_reference(vc, vn, idx, bt)),
                     lambda: (fk.index_copy_(0, dest, sk), fv.index_copy_(0, dest, sv)),
                     2 * 2 * SLOTS * lq * row_bytes + nbytes(idx, bt), 0.0, 0.0, 0.0,
                     library="index_copy_ (K and V)", rows_written=SLOTS * lq,
                     row_bytes=row_bytes,
                     plan=dataclasses.asdict(scatter_plan(SLOTS, lq, 2, row_bytes))))
    return out


def check_flash(ref, flash_attention, gen):
    from repro_torch.kernels.flash_attention import plan

    out = []
    for label, b, hq, hkv, lq, lkv, d, pad, dt, kw, edit in flash_cases():
        # the main path's layouts: q and the cache as [B, L, H, D], viewed [B, H, L, D]
        def rows(n, h):
            x = torch.randn(b, n, h, d + pad, generator=gen, device="cuda").to(dt)
            return x[..., :d].transpose(1, 2)
        q, k, v = rows(lq, hq), rows(lkv, hkv), rows(lkv, hkv)
        q_pos = torch.arange(lkv - lq, lkv, dtype=torch.int32, device="cuda")[None].repeat(b, 1)
        kv_pos = torch.arange(lkv, dtype=torch.int32, device="cuda")[None].repeat(b, 1)
        if edit is True:
            kv_pos[:, 5:9] = -1          # evicted / unfilled rows
            kv_pos[1, 100:140] = -1
        if edit == "split":
            kv_pos[:, :832] = -1         # split 0 has no valid key
        if edit == "bc":
            q_pos = torch.arange(128, 128 + lq, dtype=torch.int32, device="cuda")[None].repeat(b, 1)
            kv_pos[:, 192:] = -1         # the window's horizon
        elif edit:
            q_pos[0, 3] = -1             # with causal: a query row with nothing valid
        pl = plan(q, k, v, lkv, hkv)
        got = flash_attention(q, k, v, q_pos, kv_pos, **kw)
        want = ref.attention_reference(q, k, v, q_pos, kv_pos, **kw)
        err = (got.float() - want.float()).abs().max().item()
        tol = 1e-4 if dt == torch.float32 else 2e-2
        if not err <= tol:
            raise AssertionError(f"flash_attention {label} {dt}: max abs err {err} > {tol}")
        if edit and kw.get("causal") and got[0, :, 3].abs().max().item() != 0.0:
            raise AssertionError(f"flash_attention {label}: a fully masked row must be 0")
        if (edit == "split" and pl.body == "tensor_core"
                and ref.split_bounds(lkv, pl.n_splits)[:1] != [(0, 832)]):
            raise AssertionError(f"flash_attention {label}: {pl}, not split at row 832")
        ms, wall = device_ms(lambda: flash_attention(q, k, v, q_pos, kv_pos, **kw))
        plain_ms, _ = device_ms(lambda: ref.attention_reference(q, k, v, q_pos, kv_pos, **kw))
        # the same call without options: no key tile is skipped for a mask
        bidi_ms = device_ms(lambda: flash_attention(q, k, v, q_pos, kv_pos))[0] if kw else None
        mask = ref.attention_mask(q_pos, kv_pos, **kw)[:, None]
        lib_ms = None                     # SDPA refuses strides that are not 16-byte multiples
        if not pad:
            lib_ms, _ = device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=hq != hkv))
        n_valid = mask.sum().item()       # scored (query, key) pairs of this input
        flops = 4.0 * hq * d * n_valid    # QK^T and PV, 2 flops per multiply-add
        # K and V: only the rows some query row's mask admits
        kv_bytes = 2 * admitted_kv_rows(mask).sum().item() * hkv * d * k.element_size()
        bms, by = bound(nbytes(q, q_pos, kv_pos, got) + kv_bytes, flops, dt)
        out.append(dict(kernel="flash_attention", case=label, dtype=str(dt), max_abs_err=err,
                        tol=tol, ms=ms, wall_ms=wall, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=bms, bound_by=by, body=pl.body, n_splits=pl.n_splits,
                        options=kw, bidi_ms=bidi_ms, empty_splits=0))
    return out


# (arch, KV heads): LLaDA's 32 KV heads (8 KB bf16 rows), Dream's 4 (1 KB)
SCATTER_ARCHS = (("llada", 32), ("dream", 4))


def check_scatter(ref, scatter_rows, gen):
    """The offline path's dense K/V scatter at LLaDA's and Dream's row
    widths: a prefill, the block and the two skip stages, and the block
    under both serving masks."""
    from repro_torch.kernels.scatter_kv import plan

    out = []
    b, s, d = 2, 192, 128
    for dt in (torch.float32, torch.bfloat16):
        for arch, h in SCATTER_ARCHS:
            for kk, what, masks in ((192, "prefill", "none"), (32, "block", "none"),
                                    (16, "skip1", "none"), (8, "skip2", "none"),
                                    (32, "block", "row+token")):
                label = f"{arch} {what} K={kk}" + ("" if masks == "none" else f" mask={masks}")
                kc = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dt)
                vc = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dt)
                kn = torch.randn(b, kk, h, d, generator=gen, device="cuda").to(dt)
                vn = torch.randn(b, kk, h, d, generator=gen, device="cuda").to(dt)
                idx = torch.stack([torch.randperm(s, generator=gen, device="cuda")[:kk]
                                   for _ in range(b)]).to(torch.int32)
                mk = {}
                if masks != "none":
                    mk = dict(row_mask=torch.tensor([True, False], device="cuda"),
                              token_mask=torch.rand(b, kk, generator=gen, device="cuda") < 0.5)
                want = (ref.scatter_rows_reference(kc.clone(), kn, idx, **mk),
                        ref.scatter_rows_reference(vc.clone(), vn, idx, **mk))

                def run(got):
                    scatter_rows(((got[0], kn), (got[1], vn)), idx, **mk)

                def same(got):
                    return all(torch.equal(g, w) for g, w in zip(got, want))
                got = (kc.clone(), vc.clone())
                run(got)
                if not same(got):
                    raise AssertionError(f"scatter_rows {label} {dt}: not bit-exact")
                ms, wall = device_ms(lambda: run(got))
                plain_ms, _ = device_ms(lambda: (
                    ref.scatter_rows_reference(got[0], kn, idx, **mk),
                    ref.scatter_rows_reference(got[1], vn, idx, **mk)))
                sel = ref.keep_mask(idx, mk.get("row_mask"), mk.get("token_mask"))
                sel = torch.ones_like(idx, dtype=torch.bool) if sel is None else sel
                flat = (idx.long() + torch.arange(b, device="cuda")[:, None] * s)[sel]
                fk, fv = got[0].view(b * s, h, d), got[1].view(b * s, h, d)
                sk, sv = kn[sel], vn[sel]
                lib_ms, _ = device_ms(lambda: (fk.index_copy_(0, flat, sk),
                                               fv.index_copy_(0, flat, sv)))
                row_bytes = h * d * kn.element_size()
                n_rows = int(sel.sum().item())
                # each written fresh row read once and written once (K and V),
                # plus the indices and the masks
                moved = 2 * 2 * n_rows * row_bytes + nbytes(idx, *mk.values())
                bms, by = bound(moved, 0.0, dt)
                rec = dict(kernel="scatter_rows", case=label, dtype=str(dt), max_abs_err=0.0,
                           tol=0.0, ms=ms, wall_ms=wall, plain_ms=plain_ms, library_ms=lib_ms,
                           library="index_copy_ (K and V)", bound_ms=bms, bound_by=by,
                           rows_written=n_rows, row_bytes=row_bytes,
                           plan=dataclasses.asdict(plan(b, kk, 2, row_bytes)))
                out.append(rec)
    return out


# (arch, d): the hidden widths that reach the score kernels
SCORE_ARCHS = (("llada", 4096), ("dream", 3584), ("mamba2", 1024))


def check_importance(ref, importance, gen):
    """Eq. 1 importance at the skip stages' shapes.  LLaDA's on contiguous
    planes (the kernel alone, the cases of earlier runs), and every path's
    stages as the engine now calls it, through ``idx`` into the block's 32
    cached rows and confidences: stage 1 reads them all in order, stage 2
    16 of them in the order a top-k left them; at LLaDA's, Dream's and
    mamba2-370m's widths."""
    from repro_torch.kernels.importance import plan

    out = []
    for dt in (torch.float32, torch.bfloat16):
        for arch, d in SCORE_ARCHS:
            for b, kk, what, indexed in ((2, 32, "stage1", False), (2, 16, "stage2", False),
                                         (SLOTS, 32, "stage1", False),
                                         (SLOTS, 16, "stage2", False),
                                         (2, 32, "stage1", True), (2, 16, "stage2", True),
                                         (SLOTS, 32, "stage1", True),
                                         (SLOTS, 16, "stage2", True)):
                if arch != "llada" and (b != SLOTS or not indexed):
                    continue     # Dream is served only; mamba2 runs 4 rows offline and served
                # the offline path's batch of 2, the serving path's slots
                label = (f"{arch} {what} K={kk}" + (f" B={b}" if b == SLOTS else "")
                         + (" idx" if indexed else ""))
                hn = torch.randn(b, kk, d, generator=gen, device="cuda").to(dt)
                s = BLOCK if indexed else kk
                ho = torch.randn(b, s, d, generator=gen, device="cuda").to(dt)
                conf = torch.rand(b, s, generator=gen, device="cuda")
                idx = None
                if indexed:
                    idx = torch.stack([torch.randperm(BLOCK, generator=gen, device="cuda")[:kk]
                                       if kk < BLOCK else torch.arange(BLOCK, device="cuda")
                                       for _ in range(b)]).to(torch.int32)
                got = importance(hn, ho, conf, alpha=0.5, idx=idx)
                want = ref.importance_reference(hn, ho, conf, 0.5, idx=idx)
                err = (got - want).abs().max().item()
                rel = ((got - want).abs() / want.abs()).max().item()
                if not rel <= 1e-5:
                    raise AssertionError(f"importance {label} {dt}: max rel err {rel} > 1e-5")
                ms, wall = device_ms(lambda: importance(hn, ho, conf, alpha=0.5, idx=idx))
                plain_ms, _ = device_ms(
                    lambda: ref.importance_reference(hn, ho, conf, 0.5, idx=idx))
                flops = 5.0 * hn.numel()      # sub, abs, add; square, add
                # the rows and confidences read (each distinct one once), idx, the scores
                moved = 2 * nbytes(hn) + nbytes(got) + b * kk * 4 + (0 if idx is None
                                                                     else nbytes(idx))
                bms, by = bound(moved, flops, torch.float32)
                out.append(dict(kernel="importance", case=label, dtype=str(dt),
                                max_abs_err=err, max_rel_err=rel, tol=1e-5, ms=ms, wall_ms=wall,
                                plain_ms=plain_ms, library_ms=None, library="none: no one "
                                "PyTorch call computes Eq. 1", bound_ms=bms, bound_by=by,
                                plan=dataclasses.asdict(plan(d, dt))))
    return out


def serving_layout(gen, ps, t_total=T_TOTAL):
    """Block tables and kv_pos of the serving path: 4 slots with prompts of
    128, 96, 64 and 32 tokens (pad-only pages unmapped), slot 2 asking for
    one block only (its last pages unmapped), physical pages shuffled;
    ``t_total`` positions a slot (phase 6's 192, phase 9's 256)."""
    n_vp = t_total // ps
    perm = torch.randperm(SLOTS * n_vp, generator=gen, device="cuda") + 1
    bt = perm.view(SLOTS, n_vp).to(torch.int32)
    pstart = torch.tensor([0, 32, 64, 96], dtype=torch.int32, device="cuda")
    vp = torch.arange(n_vp, device="cuda")[None]
    unmapped = vp < (pstart[:, None] // ps)
    unmapped[2] |= vp[0] >= -(-(PROMPT + BLOCK) // ps)
    bt = torch.where(unmapped, -1, bt).contiguous()
    pos = torch.arange(t_total, dtype=torch.int32, device="cuda")[None]
    kv_pos = torch.where(pos >= pstart[:, None], pos, -1).contiguous()
    return bt, kv_pos, SLOTS * n_vp + 1


def sparse_layout(gen, ps):
    """The serving layout after sparse eviction, every slot at its first
    generated block (the block at the prompt end): about half of each
    slot's past rows dead (``kv_pos`` -1, a quarter of its settled pages
    wholly), and the wholly dead pages behind the block unmapped, as the
    scheduler's reclaim leaves them.  Returns the holed ``(bt, kv_pos)``,
    the layout without holes and the pool size."""
    bt, kv_pos, n_pages = serving_layout(gen, ps)
    n_vp = bt.shape[1]
    pos = torch.arange(T_TOTAL, device="cuda")[None]
    settled = ((torch.arange(n_vp, device="cuda") + 1) * ps <= PROMPT)[None]
    dead = (torch.rand(SLOTS, T_TOTAL, generator=gen, device="cuda") < 0.4) & (pos < PROMPT)
    dead |= ((torch.rand(SLOTS, n_vp, generator=gen, device="cuda") < 0.25)
             & settled).repeat_interleave(ps, dim=1)
    holed = torch.where(dead, -1, kv_pos).contiguous()
    alive = (holed >= 0).view(SLOTS, n_vp, ps).any(dim=2)
    bt_holed = torch.where(~alive & settled, -1, bt).contiguous()
    return (bt_holed, holed), (bt, kv_pos), n_pages


def empty_splits(ref, pl, bt, ps: int) -> int:
    """KV splits of a tensor-core plan whose pages are all unmapped in every
    row of the block table ``bt``."""
    if pl.body != "tensor_core":
        return 0
    mapped = (bt >= 0).any(dim=0).tolist()
    return sum(not any(mapped[a // ps:-(-e // ps)])
               for a, e in ref.split_bounds(bt.shape[1] * ps, pl.n_splits))


def check_paged_flash(ref, paged_flash_attention, gen):
    """The serving layouts at page sizes 16 and 8, then one long Dream slot
    (1600 virtual rows) that the tensor-core body splits at row 832, split
    0 on unmapped pages only, split 1 ragged; then the mask options of the
    block-causal and windowed paths (``paged_option_cases``); then the
    sparse-served layout (``sparse_layout``) beside the same call without
    holes."""
    from repro_torch.kernels.flash_attention import plan

    def case(label, q, kp, vp, q_pos, kv_pos, bt, opts=None, full=None):
        """One case; with mask ``opts`` it also times the same call without
        them (``bidi_ms``: no tile is skipped for future blocks); with
        ``full = (kv_pos, bt)`` the same call on the layout without
        eviction's holes (``full_ms``)."""
        dt, (hq, hkv, ps) = q.dtype, (q.shape[1], kp.shape[2], kp.shape[1])
        opts = opts or {}
        args = (q, kp, vp, q_pos, kv_pos, bt)
        pl = plan(q, kp, vp, kv_pos.shape[1], hkv, ps)
        got = paged_flash_attention(*args, **opts)
        want = ref.paged_attention_reference(*args, **opts)
        err = (got.float() - want.float()).abs().max().item()
        tol = 1e-4 if dt == torch.float32 else 2e-2
        if opts and dt == torch.float32:
            tol = 1e-5
        if not err <= tol:
            raise AssertionError(f"paged_flash_attention {label} {dt}: max abs err {err} > {tol}")
        if not torch.isfinite(got).all():
            raise AssertionError(f"paged_flash_attention {label}: non-finite output")
        ms, wall = device_ms(lambda: paged_flash_attention(*args, **opts))
        plain_ms, _ = device_ms(lambda: ref.paged_attention_reference(*args, **opts))
        bidi_ms = device_ms(lambda: paged_flash_attention(*args))[0] if opts else None
        full_ms = None
        if full is not None:
            full_ms = device_ms(lambda: paged_flash_attention(q, kp, vp, q_pos, *full))[0]
        mask = ref.attention_mask(q_pos, ref.paged_kv_mask(bt, kv_pos, ps), **opts)[:, None]

        def library():            # two calls: gather the pages, then SDPA
            k = ref.gather_pages(kp, bt).transpose(1, 2)
            v = ref.gather_pages(vp, bt).transpose(1, 2)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=hq != hkv)
        lib_ms, _ = device_ms(library)
        n_mapped = int((bt >= 0).sum().item())
        # K and V: the physical rows that some query row's mask admits (the
        # mask leaves unmapped pages out), each read once
        lkv = kv_pos.shape[1]
        phys = (bt.repeat_interleave(ps, dim=1).long() * ps
                + torch.arange(lkv, device=bt.device) % ps)
        n_rows = phys[admitted_kv_rows(mask)].unique().numel()
        flops = 4.0 * hq * 128 * mask.sum().item()
        bms, by = bound(nbytes(q, q_pos, kv_pos, bt, got)
                        + 2 * n_rows * hkv * 128 * kp.element_size(), flops, dt)
        return pl, dict(kernel="paged_flash_attention", case=label, dtype=str(dt),
                        max_abs_err=err, tol=tol, ms=ms, wall_ms=wall, plain_ms=plain_ms,
                        library_ms=lib_ms, library="gather_pages + scaled_dot_product_attention",
                        bound_ms=bms, bound_by=by, mapped_pages=n_mapped, kv_rows_read=n_rows,
                        body=pl.body,
                        n_splits=pl.n_splits, empty_splits=empty_splits(ref, pl, bt, ps),
                        options=opts, bidi_ms=bidi_ms, full_ms=full_ms)

    out = []
    for dt in (torch.float32, torch.bfloat16):
        for arch, hq, hkv in (("llada", 32, 32), ("dream gqa", 28, 4)):
            for ps in (16, 8):
                for lq, what in ((32, "block"), (8, "skip2"), (40, "partial"), (192, "prefill")):
                    if arch != "llada" and what == "partial":
                        continue
                    bt, kv_pos, n_pages = serving_layout(gen, ps)
                    kp = torch.randn(n_pages, ps, hkv, 128, generator=gen, device="cuda").to(dt)
                    vp = torch.randn(n_pages, ps, hkv, 128, generator=gen, device="cuda").to(dt)
                    q = torch.randn(SLOTS, lq, hq, 128, generator=gen,
                                    device="cuda").to(dt).transpose(1, 2)
                    # the block's positions, or every position for a prefill
                    first = PROMPT if lq < T_TOTAL else 0
                    q_pos = torch.arange(first, first + lq, dtype=torch.int32, device="cuda")
                    out.append(case(f"{arch} {what} Lq={lq} ps={ps}", q, kp, vp,
                                    q_pos[None].repeat(SLOTS, 1), kv_pos, bt)[1])
        for ps in (16, 8):
            label, n_vp = f"dream gqa split Lq=32 ps={ps}", 1600 // ps
            bt = (torch.randperm(n_vp, generator=gen, device="cuda") + 1).int().view(1, n_vp)
            bt[0, : 832 // ps] = -1                    # split 0: nothing mapped
            kv_pos = torch.arange(1600, dtype=torch.int32, device="cuda")[None].contiguous()
            kv_pos[0, 1500:] = -1
            kp, vp = (torch.randn(n_vp + 1, ps, 4, 128, generator=gen, device="cuda").to(dt)
                      for _ in "kv")
            q = torch.randn(1, 32, 28, 128, generator=gen, device="cuda").to(dt).transpose(1, 2)
            q_pos = torch.arange(1568, 1600, dtype=torch.int32, device="cuda")[None].contiguous()
            pl, rec = case(label, q, kp, vp, q_pos, kv_pos, bt)
            if dt == torch.bfloat16 and ref.split_bounds(1600, pl.n_splits)[:1] != [(0, 832)]:
                raise AssertionError(f"paged_flash_attention {label}: {pl}, not split at 832")
            out.append(rec)
        out += paged_option_cases(ref, case, gen, dt)
        (bt, kv_pos), (bt_full, kv_full), n_pages = sparse_layout(gen, 16)
        kp, vp = (torch.randn(n_pages, 16, 32, 128, generator=gen, device="cuda").to(dt)
                  for _ in "kv")
        q = torch.randn(SLOTS, 32, 32, 128, generator=gen, device="cuda").to(dt).transpose(1, 2)
        q_pos = torch.arange(PROMPT, PROMPT + BLOCK, dtype=torch.int32,
                             device="cuda")[None].repeat(SLOTS, 1)
        out.append(case("llada block Lq=32 ps=16 sparse", q, kp, vp, q_pos, kv_pos, bt,
                        full=(kv_full, bt_full))[1])
    return out


def paged_option_cases(ref, case, gen, dt):
    """The paged kernel's mask options at the block-causal and windowed
    paths' shapes: the serving layout (prompt 128, gen 64, blocks of 32) at
    the block Lq 32 with block-causal, with window + anchor + block-causal,
    and with Dream's GQA rows (whose packed rows take their key block from
    their own query position); then phase 9's served layout (T 256) under
    block-causal with the window's clamp and read table; then one long
    Dream slot read through the sliding window's table, whose last split
    holds no mapped page."""
    from repro_torch.kernels import ops

    out = []
    bc = dict(bc_start=PROMPT, bc_block=BLOCK)
    for arch, hq, hkv, opts, what in (
            ("llada", 32, 32, bc, "bc"),
            ("llada", 32, 32, dict(window=24, anchor=16, **bc), "window+anchor+bc"),
            ("dream gqa", 28, 4, bc, "bc")):
        bt, kv_pos, n_pages = serving_layout(gen, 16)
        kp, vp = (torch.randn(n_pages, 16, hkv, 128, generator=gen, device="cuda").to(dt)
                  for _ in "kv")
        q = torch.randn(SLOTS, 32, hq, 128, generator=gen, device="cuda").to(dt).transpose(1, 2)
        # the first generated block: it reads the prompt and itself, not block 1
        q_pos = torch.arange(PROMPT, PROMPT + BLOCK, dtype=torch.int32,
                             device="cuda")[None].repeat(SLOTS, 1)
        out.append(case(f"{arch} block Lq=32 ps=16 {what}", q, kp, vp, q_pos, kv_pos, bt,
                        opts)[1])
    # phase 9's served layout (prompt 128, gen 128, ps 16, the one-block
    # window): each slot at its own block start, slot 2 (one block asked
    # for) at the first; kv_pos clamped and the table read through the window
    bt, kv_pos, n_pages = serving_layout(gen, 16, PROMPT + BC_GEN)
    bs = torch.tensor([160, 192, 128, 224], dtype=torch.int32, device="cuda")
    limit = bs + BLOCK * 2
    kv_pos = ops.window_kv_clamp(kv_pos, limit)
    read_bt = ops.window_block_tables(bt, limit, 16)
    kp, vp = (torch.randn(n_pages, 16, 32, 128, generator=gen, device="cuda").to(dt)
              for _ in "kv")
    q = torch.randn(SLOTS, 32, 32, 128, generator=gen, device="cuda").to(dt).transpose(1, 2)
    q_pos = (bs[:, None] + torch.arange(BLOCK, dtype=torch.int32, device="cuda")).contiguous()
    out.append(case("llada block Lq=32 ps=16 T=256 bc+window", q, kp, vp, q_pos, kv_pos,
                    read_bt, bc)[1])
    for ps in (16, 8):
        n_vp = 1600 // ps
        bt = (torch.randperm(n_vp, generator=gen, device="cuda") + 1).int().view(1, n_vp)
        limit = torch.tensor([800], dtype=torch.int32, device="cuda")
        kv_pos = ops.window_kv_clamp(
            torch.arange(1600, dtype=torch.int32, device="cuda")[None].contiguous(), limit)
        read_bt = ops.window_block_tables(bt, limit, ps)
        kp, vp = (torch.randn(n_vp + 1, ps, 4, 128, generator=gen, device="cuda").to(dt)
                  for _ in "kv")
        q = torch.randn(1, 32, 28, 128, generator=gen, device="cuda").to(dt).transpose(1, 2)
        q_pos = torch.arange(768, 800, dtype=torch.int32, device="cuda")[None].contiguous()
        pl, rec = case(f"dream gqa window Lq=32 ps={ps} bc", q, kp, vp, q_pos, kv_pos, read_bt,
                       dict(bc_start=768, bc_block=32))
        if dt == torch.bfloat16 and rec["empty_splits"] < 1:
            raise AssertionError(f"paged_flash_attention windowed ps={ps}: {pl}, no split "
                                 f"without a mapped page")
        out.append(rec)
    return out


def check_paged_scatter(ref, scatter_rows_paged, gen):
    """The serving path's paged K/V scatter at LLaDA's and Dream's row
    widths over the serving layout: the block with no mask, the mixed-mode
    row mask and a partial refresh's token mask; the partial refresh's 40
    tokens; a prefill.  Masks go in as the serving path passes them."""
    from repro_torch.kernels.scatter_kv import plan

    out = []
    d = 128
    for dt in (torch.float32, torch.bfloat16):
        for ps in (16, 8):
            for arch, h in SCATTER_ARCHS:
                if arch == "dream" and ps != 16:
                    continue
                for kk, what, masks in ((32, "block", "none"), (32, "block", "row"),
                                        (32, "block", "token"), (40, "partial", "none"),
                                        (40, "partial", "row+token"), (192, "prefill", "none")):
                    label = f"{arch} {what} K={kk} ps={ps} mask={masks}"
                    bt, _, n_pages = serving_layout(gen, ps)
                    kc = torch.randn(n_pages, ps, h, d, generator=gen, device="cuda").to(dt)
                    vc = torch.randn(n_pages, ps, h, d, generator=gen, device="cuda").to(dt)
                    kn = torch.randn(SLOTS, kk, h, d, generator=gen, device="cuda").to(dt)
                    vn = torch.randn(SLOTS, kk, h, d, generator=gen, device="cuda").to(dt)
                    if kk == T_TOTAL:
                        idx = torch.arange(T_TOTAL, dtype=torch.int32, device="cuda")
                        idx = idx[None].repeat(SLOTS, 1)
                    else:
                        idx = torch.stack([torch.randperm(T_TOTAL, generator=gen,
                                                          device="cuda")[:kk]
                                           for _ in range(SLOTS)]).to(torch.int32)
                    mk = {}
                    if "row" in masks:
                        mk["row_mask"] = torch.tensor([True, False, True, False], device="cuda")
                    if "token" in masks:
                        mk["token_mask"] = torch.rand(SLOTS, kk, generator=gen,
                                                      device="cuda") < 0.5
                    want = (ref.scatter_rows_paged_reference(kc.clone(), kn, idx, bt, **mk),
                            ref.scatter_rows_paged_reference(vc.clone(), vn, idx, bt, **mk))

                    def run(got):
                        scatter_rows_paged(((got[0], kn), (got[1], vn)), idx, bt, **mk)

                    # page 0 takes every row of an unmapped page: garbage, never read
                    def same(got):
                        return all(torch.equal(g[1:], w[1:]) for g, w in zip(got, want))
                    got = (kc.clone(), vc.clone())
                    run(got)
                    if not same(got):
                        raise AssertionError(f"scatter_rows_paged {label} {dt}: not bit-exact")
                    ms, wall = device_ms(lambda: run(got))
                    plain_ms, _ = device_ms(lambda: (
                        ref.scatter_rows_paged_reference(got[0], kn, idx, bt, **mk),
                        ref.scatter_rows_paged_reference(got[1], vn, idx, bt, **mk)))
                    sel = ref.keep_mask(idx, mk.get("row_mask"), mk.get("token_mask"))
                    sel = torch.ones_like(idx, dtype=torch.bool) if sel is None else sel
                    page = torch.gather(bt.long(), 1, idx.long() // ps).clamp(min=0)
                    dest = (page * ps + idx.long() % ps)[sel]
                    fk, fv = got[0].view(-1, h, d), got[1].view(-1, h, d)
                    sk, sv = kn[sel], vn[sel]
                    lib_ms, _ = device_ms(lambda: (fk.index_copy_(0, dest, sk),
                                                   fv.index_copy_(0, dest, sv)))
                    n_rows = int(sel.sum().item())
                    row_bytes = h * d * kn.element_size()
                    # each kept fresh row read once and written once (K and V),
                    # plus the indices, the table and the masks
                    moved = 2 * 2 * n_rows * row_bytes + nbytes(idx, bt, *mk.values())
                    bms, by = bound(moved, 0.0, dt)
                    rec = dict(kernel="scatter_rows_paged", case=label, dtype=str(dt),
                               max_abs_err=0.0, tol=0.0, ms=ms, wall_ms=wall,
                               plain_ms=plain_ms, library_ms=lib_ms,
                               library="index_copy_ (K and V)", bound_ms=bms, bound_by=by,
                               rows_written=n_rows, row_bytes=row_bytes,
                               plan=dataclasses.asdict(plan(SLOTS, kk, 2, row_bytes)))
                    out.append(rec)
        out.append(sparse_scatter_case(ref, scatter_rows_paged, gen, dt))
    return out


def sparse_scatter_case(ref, scatter_rows_paged, gen, dt) -> dict:
    """A refresh's LLaDA K/V scatter (all 192 rows of every slot, pages of
    16) through the sparse-served table: rows of reclaimed pages land on the
    garbage page.  Timed beside the same call through the table without
    holes (``full_ms``); the bound counts the rows that land on mapped
    pages."""
    (bt, _), (bt_full, _), n_pages = sparse_layout(gen, 16)
    h, d, ps = 32, 128, 16
    kc, vc = (torch.randn(n_pages, ps, h, d, generator=gen, device="cuda").to(dt)
              for _ in "kv")
    kn, vn = (torch.randn(SLOTS, T_TOTAL, h, d, generator=gen, device="cuda").to(dt)
              for _ in "kv")
    idx = torch.arange(T_TOTAL, dtype=torch.int32, device="cuda")[None].repeat(SLOTS, 1)
    want = (ref.scatter_rows_paged_reference(kc.clone(), kn, idx, bt),
            ref.scatter_rows_paged_reference(vc.clone(), vn, idx, bt))
    got = (kc.clone(), vc.clone())
    scatter_rows_paged(((got[0], kn), (got[1], vn)), idx, bt)
    if not all(torch.equal(g[1:], w[1:]) for g, w in zip(got, want)):
        raise AssertionError(f"scatter_rows_paged sparse layout {dt}: not bit-exact")
    ms, wall = device_ms(lambda: scatter_rows_paged(((got[0], kn), (got[1], vn)), idx, bt))
    full_ms, _ = device_ms(lambda: scatter_rows_paged(((got[0], kn), (got[1], vn)), idx,
                                                      bt_full))
    plain_ms, _ = device_ms(lambda: (ref.scatter_rows_paged_reference(got[0], kn, idx, bt),
                                     ref.scatter_rows_paged_reference(got[1], vn, idx, bt)))
    page = torch.gather(bt.long(), 1, idx.long() // ps)
    dest = (page.clamp(min=0) * ps + idx.long() % ps).view(-1)
    fk, fv = got[0].view(-1, h, d), got[1].view(-1, h, d)
    sk, sv = kn.reshape(-1, h, d), vn.reshape(-1, h, d)
    lib_ms, _ = device_ms(lambda: (fk.index_copy_(0, dest, sk), fv.index_copy_(0, dest, sv)))
    n_rows = int((page >= 0).sum().item())
    row_bytes = h * d * kn.element_size()
    bms, by = bound(2 * 2 * n_rows * row_bytes + nbytes(idx, bt), 0.0, dt)
    return dict(kernel="scatter_rows_paged", case="llada prefill K=192 ps=16 sparse",
                dtype=str(dt), max_abs_err=0.0, tol=0.0, ms=ms, wall_ms=wall,
                plain_ms=plain_ms, full_ms=full_ms, library_ms=lib_ms,
                library="index_copy_ (K and V)", bound_ms=bms, bound_by=by,
                rows_written=n_rows, rows_to_garbage=SLOTS * T_TOTAL - n_rows,
                row_bytes=row_bytes, unmapped_pages=int((bt < 0).sum().item()),
                unmapped_pages_full=int((bt_full < 0).sum().item()))


def scatter_host_cost(ops, gen) -> dict:
    """The host side of one ``ops.scatter_rows_paged`` call as the serving
    path makes it, at LLaDA's served block shape (4 slots, 32 tokens, bf16,
    pages of 16), with a row mask and with row and token masks: host µs per
    call, the mean over 1,000 calls with one synchronize at the end, in
    three rounds that alternate the two (host time drifts within a
    process), and the device records one call makes (kernels, copies and
    sets alike), the most of three profiler windows of the call between 32
    L2 flushes before and 32 after.  The profiler loses or shifts records
    at the edges of a window (phase 3's incomplete traces): the flushes
    take that.  A flush is told apart by its size, not its name alone: it
    rewrites 256 MB, over 0.1 ms, where a kernel on a mask or an index
    takes a few µs, so a ``bitwise_not`` the call itself launched still
    counts."""
    bt, _, n_pages = serving_layout(gen, 16)
    kc, vc = (torch.randn(n_pages, 16, 32, 128, generator=gen, device="cuda").to(torch.bfloat16)
              for _ in "kv")
    kn, vn = (torch.randn(SLOTS, BLOCK, 32, 128, generator=gen, device="cuda").to(torch.bfloat16)
              for _ in "kv")
    idx = torch.stack([torch.randperm(T_TOTAL, generator=gen, device="cuda")[:BLOCK]
                       for _ in range(SLOTS)]).to(torch.int32)
    row = torch.tensor([True, False, True, False], device="cuda")
    tok = torch.rand(SLOTS, BLOCK, generator=gen, device="cuda") < 0.5
    masks = {"row": dict(row_mask=row), "row+token": dict(row_mask=row, token_mask=tok)}
    rounds: dict = {name: [] for name in masks}
    for _ in range(3):
        for name, mk in masks.items():
            for _ in range(50):
                ops.scatter_rows_paged(((kc, kn), (vc, vn)), idx, bt, **mk)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(1000):
                ops.scatter_rows_paged(((kc, kn), (vc, vn)), idx, bt, **mk)
            torch.cuda.synchronize()
            rounds[name].append((time.perf_counter() - t0) / 1000 * 1e6)
    out = {}
    for name, mk in masks.items():
        windows = kernel_windows(lambda: ops.scatter_rows_paged(((kc, kn), (vc, vn)), idx, bt,
                                                                **mk))
        out[name] = dict(host_us_per_call=sorted(rounds[name])[1], host_us_rounds=rounds[name],
                         kernels_per_call=max(windows), windows=windows)
    return out


def kernel_windows(fn) -> list:
    """The device records (kernels, copies and sets alike) of one call of
    ``fn`` in each of three profiler windows, the call between 32 L2 flushes
    before and 32 after (see ``scatter_host_cost``)."""
    cuda = torch.autograd.DeviceType.CUDA
    acts = [torch.profiler.ProfilerActivity.CUDA]
    windows = []
    for _ in range(3):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(32):
                flush_l2()
            fn()
            for _ in range(32):
                flush_l2()
            torch.cuda.synchronize()
        windows.append(sum(1 for e in prof.profiler.kineto_results.events()
                           if e.device_type() == cuda and not (
                               "bitwise_not" in e.name() and e.duration_ns() > 20_000)))
    return windows


def importance_host_cost(ops, gen) -> dict:
    """The host side of one ``ops.importance_score`` call as the skip stage
    makes it, through ``idx`` into the block's cached rows, at LLaDA's
    served stage 1 and stage 2 (4 slots, f32): host µs per call (the mean
    over 1,000 calls, one synchronize at the end; the median of three
    rounds) and the device records one call makes (``kernel_windows``)."""
    out = {}
    for kk in (BLOCK, BLOCK // 2):
        hn = torch.randn(SLOTS, kk, 4096, generator=gen, device="cuda")
        cache = torch.randn(SLOTS, BLOCK, 4096, generator=gen, device="cuda")
        conf = torch.rand(SLOTS, BLOCK, generator=gen, device="cuda")
        idx = torch.stack([torch.randperm(BLOCK, generator=gen, device="cuda")[:kk]
                           for _ in range(SLOTS)]).to(torch.int32)

        def call():
            return ops.importance_score(hn, cache, conf, alpha=0.5, idx=idx)
        rounds = []
        for _ in range(3):
            for _ in range(50):
                call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(1000):
                call()
            torch.cuda.synchronize()
            rounds.append((time.perf_counter() - t0) / 1000 * 1e6)
        windows = kernel_windows(call)
        out[f"K={kk}"] = dict(host_us_per_call=sorted(rounds)[1], host_us_rounds=rounds,
                              kernels_per_call=max(windows), windows=windows)
    return out


def check_variation(ref, variation, gen):
    """The partial refresh's variation score over the whole served sequence
    at LLaDA's and Dream's widths, a zero cached row in each."""
    from repro_torch.kernels.importance import plan

    out = []
    for dt in (torch.float32, torch.bfloat16):
        for arch, d in SCORE_ARCHS[:2]:
            label = f"{arch} partial [{SLOTS}, {T_TOTAL}, {d}]"
            hn = torch.randn(SLOTS, T_TOTAL, d, generator=gen, device="cuda").to(dt)
            ho = torch.randn(SLOTS, T_TOTAL, d, generator=gen, device="cuda").to(dt)
            ho[1, 7] = 0.0                       # a cold cached row scores a*c + (1-a)
            conf = torch.rand(SLOTS, T_TOTAL, generator=gen, device="cuda")
            got = variation(hn, ho, conf, alpha=0.5)
            want = ref.variation_reference(hn, ho, conf, 0.5)
            err = (got - want).abs().max().item()
            rel = ((got - want).abs() / want.abs()).max().item()
            if not rel <= 1e-5:
                raise AssertionError(f"variation {label} {dt}: max rel err {rel} > 1e-5")
            if abs(got[1, 7].item() - (0.5 * conf[1, 7].item() + 0.5)) > 1e-6:
                raise AssertionError("variation: a zero cached row must score a*c + (1-a)")
            ms, wall = device_ms(lambda: variation(hn, ho, conf, alpha=0.5))
            plain_ms, _ = device_ms(lambda: ref.variation_reference(hn, ho, conf, 0.5))
            flops = 6.0 * hn.numel()              # three multiply-adds per element pair
            bms, by = bound(nbytes(hn, ho, conf, got), flops, torch.float32)
            out.append(dict(kernel="variation", case=label, dtype=str(dt), max_abs_err=err,
                            max_rel_err=rel, tol=1e-5, ms=ms, wall_ms=wall, plain_ms=plain_ms,
                            library_ms=None, library="none: F.cosine_similarity clamps each "
                            "norm and does not blend", bound_ms=bms, bound_by=by,
                            plan=dataclasses.asdict(plan(d, dt))))
    return out


# (arch, layer groups, KV heads) of the pools the fork copies
FORK_ARCHS = (("llada", 32, 32), ("dream", 28, 4))


def fork_lists(gen, n_pages: int, f: int):
    """``f`` real (src, dst) pairs over distinct pages 1..n_pages-1 in
    shuffled order, padded to a multiple of 8 with (0, 0) pairs placed at
    shuffled positions, as the scheduler's fork list."""
    perm = (torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1).tolist()
    real = list(zip(perm[:f], perm[f:2 * f]))
    pairs = real + [(0, 0)] * (-(-f // 8) * 8 - f)
    order = torch.randperm(len(pairs), generator=gen, device="cuda").tolist()
    pairs = [pairs[i] for i in order]
    return [a for a, _ in pairs], [b for _, b in pairs], real


def check_fork(ref, fork_pages, gen):
    """The copy-on-write fork on the serving pool's shapes: every destination
    page equals its source bit for bit, every other page is unchanged, the
    pools stay where they are, the call allocates less than a page, and
    aliased or out-of-range lists are refused."""
    out = []
    for dt in (torch.float32, torch.bfloat16):
        for arch, g, hkv in FORK_ARCHS:
            for ps in (16, 8):
                n_pages = SLOTS * (T_TOTAL // ps) + 1
                kp = torch.randn(g, n_pages, ps, hkv, 128, generator=gen, device="cuda").to(dt)
                vp = torch.randn(g, n_pages, ps, hkv, 128, generator=gen, device="cuda").to(dt)
                page_bytes = ps * hkv * 128 * kp.element_size()
                for f in (1, 8, 14, 24):
                    label = f"{arch} F={f} ps={ps}"
                    src, dst, real = fork_lists(gen, n_pages, f)
                    k0, v0, ptrs = kp.clone(), vp.clone(), (kp.data_ptr(), vp.data_ptr())
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    mem0 = torch.cuda.memory_allocated()
                    fork_pages(kp, vp, src, dst)
                    torch.cuda.synchronize()
                    grew = torch.cuda.max_memory_allocated() - mem0
                    if grew >= page_bytes:
                        raise AssertionError(f"fork_pages {label} {dt}: allocated {grew} bytes, "
                                             f"a page is {page_bytes}")
                    if (kp.data_ptr(), vp.data_ptr()) != ptrs:
                        raise AssertionError(f"fork_pages {label}: the pools moved")
                    s_t = torch.tensor([a for a, _ in real], device="cuda")
                    d_t = torch.tensor([b for _, b in real], device="cuda")
                    others = torch.ones(n_pages, dtype=torch.bool, device="cuda")
                    others[d_t] = False
                    for got, before in ((kp, k0), (vp, v0)):
                        if not torch.equal(got[:, d_t], before[:, s_t]):
                            raise AssertionError(f"fork_pages {label} {dt}: a destination "
                                                 "differs from its source")
                        if not torch.equal(got[:, others], before[:, others]):
                            raise AssertionError(f"fork_pages {label} {dt}: a page that is "
                                                 "not a destination changed")
                    src_t = torch.tensor(src, device="cuda")
                    dst_t = torch.tensor(dst, device="cuda")
                    want = ref.fork_pages_reference(k0.clone(), src_t, dst_t)
                    if not torch.equal(kp, want):
                        raise AssertionError(f"fork_pages {label} {dt}: differs from the plain "
                                             "version")
                    for bad in ((src + [real[0][1]], dst + [real[0][0]]),   # aliased pages
                                ([1], [n_pages])):                          # out of range
                        try:
                            fork_pages(kp, vp, *bad)
                        except ValueError:
                            continue
                        raise AssertionError(f"fork_pages {label}: {bad} was not refused")
                    ms, wall = device_ms(lambda: fork_pages(kp, vp, src, dst))
                    plain_ms, _ = device_ms(lambda: (ref.fork_pages_reference(kp, src_t, dst_t),
                                                     ref.fork_pages_reference(vp, src_t, dst_t)))
                    lib_ms, _ = device_ms(lambda: (kp.index_copy_(1, d_t, kp.index_select(1, s_t)),
                                                   vp.index_copy_(1, d_t, vp.index_select(1, s_t))))
                    # each real page read once and written once, in every
                    # layer group of both pools
                    bms, by = bound(2 * f * g * 2 * page_bytes, 0.0, dt)
                    out.append(dict(kernel="fork_pages", case=label, dtype=str(dt),
                                    max_abs_err=0.0, tol=0.0, ms=ms, wall_ms=wall,
                                    plain_ms=plain_ms, library_ms=lib_ms,
                                    library="index_select + index_copy_ (K and V)",
                                    bound_ms=bms, bound_by=by, pairs=f,
                                    padded_pairs=len(src), peak_growth_bytes=grew))
    return out


# ---------------------------------------------------------------------------
# phase 3, the int8 KV cache: attention on int8 codes, the quantizing
# scatter and the fork of the scale pools
# ---------------------------------------------------------------------------
def quantized_rows(ref, gen, *shape, dt=torch.bfloat16):
    """Random K/V rows of ``dt`` and their int8 codes and f32 scales."""
    x = torch.randn(*shape, generator=gen, device="cuda").to(dt)
    codes, scales = ref.quantize_rows(x)
    return x, codes, scales


def int8_bytes(n_rows: int, hkv: int, d: int) -> int:
    """Codes and scales of ``n_rows`` K and V rows of ``hkv`` heads."""
    return 2 * n_rows * hkv * (d + 4)


def check_flash_int8(ref, flash_attention, gen):
    """1q: dense attention on int8 codes at phase 5's layouts (the decode
    block Lq 32 against Lkv 192, the prefill, Dream's GQA with every mask
    option and an evicted row, a split long cache, the reduced models' head
    dim 32): bf16 q on the tensor-core body, f32 q on the CUDA-core body,
    each within its tolerance of the plain version (which dequantizes in
    f32).  The bf16 cases are timed beside the bf16 kernel on the
    dequantized cache (``bf16_ms``), with "dequant + SDPA" as the library
    call; the f32 ones (the CPU-parity type) are checked, not timed."""
    from repro_torch.kernels.flash_attention import plan

    out = []
    for dt in (torch.float32, torch.bfloat16):
        for label, b, hq, hkv, lq, lkv, d, kw, edit in (
                ("llada block Lq=32 int8", 2, 32, 32, 32, 192, 128, {}, False),
                ("llada prefill Lq=192 int8", 2, 32, 32, 192, 192, 128, {}, False),
                ("dream gqa window+anchor+bc int8", 2, 28, 4, 32, 192, 128,
                 {"window": 24, "anchor": 16, "bc_start": 128, "bc_block": 32}, True),
                ("llada split causal+ragged int8", 1, 32, 32, 32, 1580, 128, {"causal": True},
                 "split"),
                ("reduced dream D=32 int8", 2, 4, 1, 8, 32, 32, {}, False)):
            q = torch.randn(b, lq, hq, d, generator=gen, device="cuda").to(dt).transpose(1, 2)
            _, k8, ks = quantized_rows(ref, gen, b, lkv, hkv, d)
            _, v8, vs = quantized_rows(ref, gen, b, lkv, hkv, d)
            k, v = k8.transpose(1, 2), v8.transpose(1, 2)        # the cache's [B, S, H, D] views
            sc = dict(k_scale=ks.transpose(1, 2), v_scale=vs.transpose(1, 2))
            q_pos = torch.arange(lkv - lq, lkv, dtype=torch.int32, device="cuda")[None].repeat(b, 1)
            kv_pos = torch.arange(lkv, dtype=torch.int32, device="cuda")[None].repeat(b, 1)
            if edit is True:
                kv_pos[:, 5:9] = -1
            if edit == "split":
                kv_pos[:, :832] = -1
            pl = plan(q, k, v, lkv, hkv)
            want_body = "tensor_core" if dt == torch.bfloat16 else "cuda_core"
            if pl.body != want_body:
                raise AssertionError(f"flash_attention {label} {dt}: {pl.body}, not {want_body}")
            n8 = flash_attention.int8_launches
            got = flash_attention(q, k, v, q_pos, kv_pos, **sc, **kw)
            if flash_attention.int8_launches != n8 + 1:
                raise AssertionError(f"flash_attention {label}: not counted as an int8 launch")
            want = ref.attention_reference(q, k, v, q_pos, kv_pos, **sc, **kw)
            err = (got.float() - want.float()).abs().max().item()
            tol = 1e-4 if dt == torch.float32 else 2e-2
            if not err <= tol:
                raise AssertionError(f"flash_attention {label} {dt}: max abs err {err} > {tol}")
            if dt == torch.float32:        # the CPU-parity type: checked, not timed
                continue
            ms, wall = device_ms(lambda: flash_attention(q, k, v, q_pos, kv_pos, **sc, **kw))
            plain_ms, _ = device_ms(lambda: ref.attention_reference(q, k, v, q_pos, kv_pos,
                                                                     **sc, **kw))
            kd = ref.dequantize(k, sc["k_scale"]).to(dt)
            vd = ref.dequantize(v, sc["v_scale"]).to(dt)
            bf16_ms = device_ms(lambda: flash_attention(q, kd, vd, q_pos, kv_pos, **kw))[0]
            bidi_ms = (device_ms(lambda: flash_attention(q, k, v, q_pos, kv_pos, **sc))[0]
                       if kw else None)
            mask = ref.attention_mask(q_pos, kv_pos, **kw)[:, None]

            def library():            # two calls: dequantize the cache, then SDPA
                return F.scaled_dot_product_attention(
                    q, ref.dequantize(k, sc["k_scale"]).to(dt),
                    ref.dequantize(v, sc["v_scale"]).to(dt), attn_mask=mask,
                    enable_gqa=hq != hkv)
            lib_ms, _ = device_ms(library)
            n_valid = mask.sum().item()
            n_rows = int(admitted_kv_rows(mask).sum().item())
            bms, by = bound(nbytes(q, q_pos, kv_pos, got) + int8_bytes(n_rows, hkv, d),
                            4.0 * hq * d * n_valid, dt)
            out.append(dict(kernel="flash_attention_int8", case=label, dtype=str(dt),
                            max_abs_err=err, tol=tol, ms=ms, wall_ms=wall, plain_ms=plain_ms,
                            library_ms=lib_ms, library="dequantize + scaled_dot_product_attention",
                            bound_ms=bms, bound_by=by, body=pl.body, n_splits=pl.n_splits,
                            options=kw, bidi_ms=bidi_ms, empty_splits=0, bf16_ms=bf16_ms,
                            kv_bytes=int8_bytes(lkv, hkv, d) * b,
                            kv_bytes_bf16=2 * b * lkv * hkv * d * 2))
    return out


def check_paged_flash_int8(ref, paged_flash_attention, gen):
    """2q: paged attention on int8 code pools with their scale pools at
    phase 6's served layout (ps 16): LLaDA's block, prefill and partial
    refresh, the block under block-causal options, and Dream's GQA block;
    bf16 on the tensor-core body, f32 on the CUDA-core body (checked, not
    timed).  Library: "gather + dequant + SDPA"."""
    from repro_torch.kernels.flash_attention import plan

    out = []
    ps = 16
    for dt in (torch.float32, torch.bfloat16):
        for label, hq, hkv, lq, opts in (
                ("llada block Lq=32 ps=16 int8", 32, 32, 32, {}),
                ("llada partial Lq=40 ps=16 int8", 32, 32, 40, {}),
                ("llada prefill Lq=192 ps=16 int8", 32, 32, 192, {}),
                ("llada block Lq=32 ps=16 bc int8", 32, 32, 32,
                 dict(bc_start=PROMPT, bc_block=BLOCK)),
                ("dream gqa block Lq=32 ps=16 int8", 28, 4, 32, {})):
            bt, kv_pos, n_pages = serving_layout(gen, ps)
            _, k8, ks = quantized_rows(ref, gen, n_pages, ps, hkv, 128)
            _, v8, vs = quantized_rows(ref, gen, n_pages, ps, hkv, 128)
            sc = dict(k_scale=ks, v_scale=vs)
            q = torch.randn(SLOTS, lq, hq, 128, generator=gen, device="cuda").to(dt).transpose(1, 2)
            first = PROMPT if lq < T_TOTAL else 0
            q_pos = torch.arange(first, first + lq, dtype=torch.int32,
                                 device="cuda")[None].repeat(SLOTS, 1)
            args = (q, k8, v8, q_pos, kv_pos, bt)
            pl = plan(q, k8, v8, kv_pos.shape[1], hkv, ps)
            want_body = "tensor_core" if dt == torch.bfloat16 else "cuda_core"
            if pl.body != want_body:
                raise AssertionError(f"paged_flash_attention {label} {dt}: {pl.body}")
            got = paged_flash_attention(*args, **sc, **opts)
            want = ref.paged_attention_reference(*args, **sc, **opts)
            err = (got.float() - want.float()).abs().max().item()
            tol = 1e-4 if dt == torch.float32 else 2e-2
            if not err <= tol:
                raise AssertionError(f"paged_flash_attention {label} {dt}: max abs err {err} "
                                     f"> {tol}")
            if dt == torch.float32:        # the CPU-parity type: checked, not timed
                continue
            ms, wall = device_ms(lambda: paged_flash_attention(*args, **sc, **opts))
            plain_ms, _ = device_ms(lambda: ref.paged_attention_reference(*args, **sc, **opts))
            kd = ref.dequantize(k8, ks).to(dt)
            vd = ref.dequantize(v8, vs).to(dt)
            bf16_ms = device_ms(lambda: paged_flash_attention(q, kd, vd, q_pos, kv_pos, bt,
                                                              **opts))[0]
            bidi_ms = (device_ms(lambda: paged_flash_attention(*args, **sc))[0]
                       if opts else None)
            mask = ref.attention_mask(q_pos, ref.paged_kv_mask(bt, kv_pos, ps), **opts)[:, None]

            def library():            # gather the pages and their scales, dequantize, SDPA
                k = ref.dequantize(ref.gather_pages(k8, bt), ref.gather_pages(ks, bt))
                v = ref.dequantize(ref.gather_pages(v8, bt), ref.gather_pages(vs, bt))
                return F.scaled_dot_product_attention(
                    q, k.to(dt).transpose(1, 2), v.to(dt).transpose(1, 2), attn_mask=mask,
                    enable_gqa=hq != hkv)
            lib_ms, _ = device_ms(library)
            lkv = kv_pos.shape[1]
            phys = (bt.repeat_interleave(ps, dim=1).long() * ps
                    + torch.arange(lkv, device=bt.device) % ps)
            n_rows = phys[admitted_kv_rows(mask)].unique().numel()
            bms, by = bound(nbytes(q, q_pos, kv_pos, bt, got) + int8_bytes(n_rows, hkv, 128),
                            4.0 * hq * 128 * mask.sum().item(), dt)
            out.append(dict(kernel="paged_flash_attention_int8", case=label, dtype=str(dt),
                            max_abs_err=err, tol=tol, ms=ms, wall_ms=wall, plain_ms=plain_ms,
                            library_ms=lib_ms,
                            library="gather_pages + dequantize + scaled_dot_product_attention",
                            bound_ms=bms, bound_by=by, kv_rows_read=n_rows, body=pl.body,
                            n_splits=pl.n_splits, options=opts, bidi_ms=bidi_ms,
                            empty_splits=empty_splits(ref, pl, bt, ps), bf16_ms=bf16_ms))
    return out


def check_quant_scatter(ref, ops, gen):
    """3q and 4q: the int8 cache's write through ``ops.scatter_rows`` and
    ``ops.scatter_rows_paged`` (one quantizing launch for K and V codes and
    scales), dense at phase 5's shapes and paged over the serving layout
    (ps 16), LLaDA's 128-byte and Dream's 16-byte scale rows, bf16 and f32
    new rows, with and without the serving masks.  Codes and scales must
    equal the plain version bit for bit (page 0, the garbage page, aside);
    each bf16 call must be one kernel.  The bf16 cases are timed (library:
    ``_quantize_rows`` in torch and four ``index_copy_``); the f32 ones are
    checked, not timed."""
    from repro_torch.kernels.scatter_kv import (
        quant_plan,
        quantize_scatter_rows,
        quantize_scatter_rows_paged,
    )

    out = []
    d, s, ps = 128, T_TOTAL, 16
    flush_l2()           # the flush buffer's allocation is not one of the call's records
    for dt in (torch.float32, torch.bfloat16):
        for paged in (False, True):
            fn = quantize_scatter_rows_paged if paged else quantize_scatter_rows
            for arch, h in SCATTER_ARCHS:
                for kk, what, masks in ((32, "block", "none"), (32, "block", "row+token"),
                                        (192, "prefill", "none")):
                    b = SLOTS if paged else 2
                    label = (f"{arch} {what} K={kk}" + (f" ps={ps}" if paged else "")
                             + (f" mask={masks}" if paged or masks != "none" else "") + " int8")
                    if paged:
                        bt, _, n_pages = serving_layout(gen, ps)
                        lead = (n_pages, ps)
                    else:
                        bt, lead = None, (b, s)
                    planes = [torch.randint(-127, 128, (*lead, h, d), generator=gen,
                                            device="cuda").to(torch.int8) for _ in "kv"]
                    scales = [torch.rand(*lead, h, generator=gen, device="cuda") for _ in "kv"]
                    kn, vn = (torch.randn(b, kk, h, d, generator=gen, device="cuda").to(dt)
                              for _ in "kv")
                    kn[0, 0, 0] = 0.0                       # a zero row: scale 1e-8
                    idx = torch.stack([torch.randperm(s, generator=gen, device="cuda")[:kk]
                                       for _ in range(b)]).to(torch.int32)
                    mk = {}
                    if masks != "none":
                        mk = dict(row_mask=torch.arange(b, device="cuda") % 2 == 0,
                                  token_mask=torch.rand(b, kk, generator=gen, device="cuda") < 0.5)
                    extra = (bt,) if paged else ()
                    plain = (ref.quantize_scatter_rows_paged_reference if paged
                             else ref.quantize_scatter_rows_reference)
                    want = [t.clone() for t in planes + scales]
                    plain(want[0], want[2], kn, idx, *extra, **mk)
                    plain(want[1], want[3], vn, idx, *extra, **mk)
                    got = [t.clone() for t in planes + scales]
                    pairs = (((got[0], got[2]), kn), ((got[1], got[3]), vn))
                    op = ops.scatter_rows_paged if paged else ops.scatter_rows
                    if dt == torch.float32:    # the CPU-parity type: checked, not timed
                        op(pairs, idx, *extra, **mk)
                    else:
                        # one call, three times (an idempotent write), each in
                        # a profiler window between L2 flushes (``kernel_windows``)
                        n0 = fn.launches
                        windows = kernel_windows(lambda: op(pairs, idx, *extra, **mk))
                        if fn.launches != n0 + len(windows) or max(windows) != 1:
                            raise AssertionError(f"{fn.__name__} {label}: {fn.launches - n0} "
                                                 f"launches and {windows} device records "
                                                 f"for {len(windows)} calls")
                    cut = 1 if paged else 0                 # page 0 takes unmapped rows
                    if not all(torch.equal(g[cut:], w[cut:]) for g, w in zip(got, want)):
                        raise AssertionError(f"{fn.__name__} {label} {dt}: codes or scales not "
                                             "bit-equal to the plain version")
                    if dt == torch.float32:
                        continue
                    ms, wall = device_ms(lambda: op(pairs, idx, *extra, **mk))
                    plain_ms, _ = device_ms(lambda: (plain(got[0], got[2], kn, idx, *extra, **mk),
                                                     plain(got[1], got[3], vn, idx, *extra, **mk)))
                    sel = ref.keep_mask(idx, mk.get("row_mask"), mk.get("token_mask"))
                    sel = torch.ones_like(idx, dtype=torch.bool) if sel is None else sel
                    if paged:
                        page = torch.gather(bt.long(), 1, idx.long() // ps).clamp(min=0)
                        dest = (page * ps + idx.long() % ps)[sel]
                    else:
                        dest = (idx.long() + torch.arange(b, device="cuda")[:, None] * s)[sel]
                    flat = [t.view(-1, h, d) for t in got[:2]] + [t.view(-1, h) for t in got[2:]]
                    kn_s, vn_s = kn[sel], vn[sel]

                    def library():
                        (kc, ksc), (vc, vsc) = ref.quantize_rows(kn_s), ref.quantize_rows(vn_s)
                        for t, x in zip(flat, (kc, vc, ksc, vsc)):
                            t.index_copy_(0, dest, x)
                    lib_ms, _ = device_ms(library)
                    n_rows = int(sel.sum().item())
                    # each kept new row read once, its codes and scales written
                    # once (K and V); the indices, the table and the masks; two
                    # f32 operations an element (the amax compare, the divide)
                    moved = (2 * n_rows * h * d * kn.element_size() + int8_bytes(n_rows, h, d)
                             + nbytes(idx, *extra, *mk.values()))
                    bms, by = bound(moved, 2.0 * 2 * n_rows * h * d, torch.float32)
                    out.append(dict(kernel=fn.__name__, case=label, dtype=str(dt),
                                    max_abs_err=0.0, tol=0.0, ms=ms, wall_ms=wall,
                                    plain_ms=plain_ms, library_ms=lib_ms,
                                    library="quantize_rows + index_copy_ (x4)", bound_ms=bms,
                                    bound_by=by, rows_written=n_rows, scale_row_bytes=h * 4,
                                    kernels_per_call=max(windows),
                                    plan=dataclasses.asdict(quant_plan(b, kk, h, d))))
    return out


def check_fork_scales(ref, fork_pages, gen):
    """5q: the copy-on-write fork of the int8 cache's scale pools ``[G, P,
    ps, Hkv]`` f32 (the fork kernel's second launch): destinations equal
    their sources, every other page unchanged, counted in
    ``fork_pages.scale_launches``."""
    out = []
    for arch, g, hkv in FORK_ARCHS:
        for ps in (16, 8):
            n_pages = SLOTS * (T_TOTAL // ps) + 1
            ks, vs = (torch.rand(g, n_pages, ps, hkv, generator=gen, device="cuda") for _ in "kv")
            page_bytes = ps * hkv * 4
            for f in (1, 14):
                label = f"{arch} F={f} ps={ps} scales"
                src, dst, real = fork_lists(gen, n_pages, f)
                k0, v0 = ks.clone(), vs.clone()
                n0 = fork_pages.scale_launches
                fork_pages(ks, vs, src, dst)
                if fork_pages.scale_launches != n0 + 1:
                    raise AssertionError(f"fork_pages {label}: not counted as a scale launch")
                src_t, dst_t = torch.tensor(src, device="cuda"), torch.tensor(dst, device="cuda")
                for got, before in ((ks, k0), (vs, v0)):
                    if not torch.equal(got, ref.fork_pages_reference(before.clone(), src_t, dst_t)):
                        raise AssertionError(f"fork_pages {label}: differs from the plain version")
                s_t = torch.tensor([a for a, _ in real], device="cuda")
                d_t = torch.tensor([b for _, b in real], device="cuda")
                ms, wall = device_ms(lambda: fork_pages(ks, vs, src, dst))
                plain_ms, _ = device_ms(lambda: (ref.fork_pages_reference(ks, src_t, dst_t),
                                                 ref.fork_pages_reference(vs, src_t, dst_t)))
                lib_ms, _ = device_ms(lambda: (ks.index_copy_(1, d_t, ks.index_select(1, s_t)),
                                               vs.index_copy_(1, d_t, vs.index_select(1, s_t))))
                bms, by = bound(2 * f * g * 2 * page_bytes, 0.0, torch.float32)
                out.append(dict(kernel="fork_pages_scales", case=label, dtype=str(torch.float32),
                                max_abs_err=0.0, tol=0.0, ms=ms, wall_ms=wall,
                                plain_ms=plain_ms, library_ms=lib_ms,
                                library="index_select + index_copy_ (K and V scales)",
                                bound_ms=bms, bound_by=by, pairs=f, page_bytes=page_bytes))
    return out


# gemma3-1b's attention: 4 query heads on 1 KV head of 256, local window 512;
# phase 13b's offline cache (prompt 640 + gen 64) and its served slots
GEMMA_HQ, GEMMA_HKV, GEMMA_D, GEMMA_WINDOW = 4, 1, 256, 512
GEMMA_PROMPT, GEMMA_T = 640, 704


def check_head_dim_256(ref, flash_attention, paged_flash_attention, gen):
    """Kernels 1, 2, 1q and 2q at gemma3's decode shape (Lq 32, Hq 4, Hkv 1,
    D 256): a dense cache of 704 rows (phase 13b offline), 4 paged slots of
    704 rows through a shuffled block table (ps 16, 13b served), and one
    split long cache of 4096 rows; each with the local window 512 and with
    the window off, bf16 on the tensor-core body and f32 on the CUDA-core
    body, each held against its plain version.  Library: SDPA with a bool
    mask (paged: gather + SDPA; int8: dequantize first).  The f32 int8 cases
    are checked, not timed.  Then the K/V scatters (3, 4, 3q, 4q) at
    gemma3's 512-byte rows, against their plain versions."""
    from repro_torch.kernels.flash_attention import plan
    from repro_torch.kernels.scatter_kv import (
        quantize_scatter_rows,
        quantize_scatter_rows_paged,
        scatter_rows,
        scatter_rows_paged,
    )

    hq, hkv, d, lq, ps = GEMMA_HQ, GEMMA_HKV, GEMMA_D, 32, 16
    out = []
    for dt in (torch.float32, torch.bfloat16):
        body = "tensor_core" if dt == torch.bfloat16 else "cuda_core"
        tol = 1e-4 if dt == torch.float32 else 2e-2
        for layout, b, lkv in (("dense", 2, GEMMA_T), ("paged", SLOTS, GEMMA_T),
                               ("dense split", 1, 4096)):
            paged = layout == "paged"
            q = torch.randn(b, lq, hq, d, generator=gen, device="cuda").to(dt).transpose(1, 2)
            q_pos = torch.arange(lkv - 64, lkv - 32, dtype=torch.int32,
                                 device="cuda")[None].repeat(b, 1)
            kv_pos = torch.arange(lkv, dtype=torch.int32, device="cuda")[None].repeat(b, 1)
            if paged:
                n_vp = lkv // ps
                bt = (torch.randperm(b * n_vp, generator=gen, device="cuda") + 1).int()
                bt = bt.view(b, n_vp).contiguous()
                raw = [torch.randn(b * n_vp + 1, ps, hkv, d, generator=gen, device="cuda")
                       for _ in "kv"]
            else:
                bt = None
                raw = [torch.randn(b, lkv, hkv, d, generator=gen, device="cuda") for _ in "kv"]
            (k8, ks), (v8, vs) = (ref.quantize_rows(t) for t in raw)
            forms = [("", raw[0].to(dt), raw[1].to(dt), {})]
            if paged:
                forms.append((" int8", k8, v8, dict(k_scale=ks, v_scale=vs)))
            else:
                forms = [(f, k.transpose(1, 2), v.transpose(1, 2), sc) for f, k, v, sc in forms]
                forms.append((" int8", k8.transpose(1, 2), v8.transpose(1, 2),
                              dict(k_scale=ks.transpose(1, 2), v_scale=vs.transpose(1, 2))))
            windows = (0,) if layout == "dense split" else (GEMMA_WINDOW, 0)
            for form, k, v, sc in forms:
                for window in windows:
                    kernel = ("paged_flash_attention" if paged else "flash_attention") + (
                        "_int8" if sc else "")
                    label = (f"gemma3 {layout} Lq=32 Lkv={lkv}" + (f" ps={ps}" if paged else "")
                             + (f" window={window}" if window else "") + form)
                    fn = paged_flash_attention if paged else flash_attention
                    args = (q, k, v, q_pos, kv_pos) + ((bt,) if paged else ())
                    pl = plan(q, k, v, lkv, hkv, ps if paged else 0)
                    if pl.body != body or (layout == "dense split" and body == "tensor_core"
                                           and pl.n_splits < 2):
                        raise AssertionError(f"{kernel} {label} {dt}: {pl}")
                    n_tc = fn.tensor_core_launches
                    got = fn(*args, window=window, **sc)
                    if (fn.tensor_core_launches - n_tc) != (body == "tensor_core"):
                        raise AssertionError(f"{kernel} {label} {dt}: not on the {body} body")
                    want = (ref.paged_attention_reference if paged
                            else ref.attention_reference)(*args, window=window, **sc)
                    err = (got.float() - want.float()).abs().max().item()
                    if not err <= tol:
                        raise AssertionError(f"{kernel} {label} {dt}: max abs err {err} > {tol}")
                    if sc and dt == torch.float32:      # the CPU-parity type: checked only
                        continue
                    ms, wall = device_ms(lambda: fn(*args, window=window, **sc))
                    plain_ms, _ = device_ms(lambda: (
                        ref.paged_attention_reference if paged
                        else ref.attention_reference)(*args, window=window, **sc))
                    kv_mask = ref.paged_kv_mask(bt, kv_pos, ps) if paged else kv_pos
                    mask = ref.attention_mask(q_pos, kv_mask, window=window)[:, None]

                    def library():
                        kk, vv = k, v
                        if paged:
                            kk = ref.gather_pages(k, bt)
                            vv = ref.gather_pages(v, bt)
                            if sc:
                                kk = ref.dequantize(kk, ref.gather_pages(ks, bt))
                                vv = ref.dequantize(vv, ref.gather_pages(vs, bt))
                            kk, vv = kk.to(dt).transpose(1, 2), vv.to(dt).transpose(1, 2)
                        elif sc:
                            kk = ref.dequantize(k, sc["k_scale"]).to(dt)
                            vv = ref.dequantize(v, sc["v_scale"]).to(dt)
                        return F.scaled_dot_product_attention(q, kk, vv, attn_mask=mask,
                                                              enable_gqa=True)
                    lib_ms, _ = device_ms(library)
                    rows = admitted_kv_rows(mask)
                    n_rows = int(rows.sum().item())
                    kv_bytes = (int8_bytes(n_rows, hkv, d) if sc
                                else 2 * n_rows * hkv * d * k.element_size())
                    bms, by = bound(nbytes(q, q_pos, kv_pos, got) + kv_bytes
                                    + (nbytes(bt) if paged else 0),
                                    4.0 * hq * d * mask.sum().item(), dt)
                    lib = ("gather_pages + " if paged else "") + ("dequantize + " if sc else "")
                    out.append(dict(kernel=kernel, case=label, dtype=str(dt), max_abs_err=err,
                                    tol=tol, ms=ms, wall_ms=wall, plain_ms=plain_ms,
                                    library_ms=lib_ms, library=lib + "scaled_dot_product_attention",
                                    bound_ms=bms, bound_by=by, kv_rows_read=n_rows,
                                    body=pl.body, n_splits=pl.n_splits, window=window,
                                    head_dim=d))
    # the scatters at gemma3's rows (Hkv 1 x 256: 512 bytes bf16, 256-byte
    # codes, a 4-byte scale), a decode block of 32 under the row mask, dense
    # and paged: bit-equal to the plain versions (paged: page 0 aside)
    checked = []
    for dt in (torch.float32, torch.bfloat16):
        idx = torch.stack([torch.randperm(GEMMA_T, generator=gen, device="cuda")[:32]
                           for _ in range(SLOTS)]).to(torch.int32)
        mk = dict(row_mask=torch.tensor([True, False, True, True], device="cuda"))
        n_vp = GEMMA_T // ps
        bt = (torch.randperm(SLOTS * n_vp, generator=gen, device="cuda") + 1).int()
        bt = bt.view(SLOTS, n_vp).contiguous()
        new = [torch.randn(SLOTS, 32, hkv, d, generator=gen, device="cuda").to(dt) for _ in "kv"]
        for paged in (False, True):
            lead = (SLOTS * n_vp + 1, ps) if paged else (SLOTS, GEMMA_T)
            cut = 1 if paged else 0
            planes = [torch.randn(*lead, hkv, d, generator=gen, device="cuda").to(dt)
                      for _ in "kv"]
            got = [t.clone() for t in planes]
            if paged:
                scatter_rows_paged(((got[0], new[0]), (got[1], new[1])), idx, bt, **mk)
                want = [ref.scatter_rows_paged_reference(t.clone(), n, idx, bt, **mk)
                        for t, n in zip(planes, new)]
            else:
                scatter_rows(((got[0], new[0]), (got[1], new[1])), idx, **mk)
                want = [ref.scatter_rows_reference(t.clone(), n, idx, **mk)
                        for t, n in zip(planes, new)]
            if not all(torch.equal(a[cut:], w[cut:]) for a, w in zip(got, want)):
                raise AssertionError(f"scatter at D=256 paged={paged} {dt}: not bit-exact")
            codes = [torch.randint(-127, 128, (*lead, hkv, d), generator=gen,
                                   device="cuda").to(torch.int8) for _ in "kv"]
            scales = [torch.rand(*lead, hkv, generator=gen, device="cuda") for _ in "kv"]
            got = [t.clone() for t in codes + scales]
            want = [t.clone() for t in codes + scales]
            pairs = (((got[0], got[2]), new[0]), ((got[1], got[3]), new[1]))
            for i in range(2):
                if paged:
                    ref.quantize_scatter_rows_paged_reference(want[i], want[i + 2], new[i], idx,
                                                              bt, **mk)
                else:
                    ref.quantize_scatter_rows_reference(want[i], want[i + 2], new[i], idx, **mk)
            if paged:
                quantize_scatter_rows_paged(pairs, idx, bt, **mk)
            else:
                quantize_scatter_rows(pairs, idx, **mk)
            if not all(torch.equal(a[cut:], w[cut:]) for a, w in zip(got, want)):
                raise AssertionError(f"quantizing scatter at D=256 paged={paged} {dt}: "
                                     "not bit-exact")
            checked.append(f"{'paged' if paged else 'dense'} {dt}")
    return out, checked


# ---------------------------------------------------------------------------
# phase 3, the encoder-conditioned archs: kernel 1 as cross-attention and as
# SeamlessM4T's encoder attention
# ---------------------------------------------------------------------------
# (row, label, B, Hq, Hkv, Lq, Lkv, D, cross): the vision model's cross
# layers (32 query heads on 8 KV heads of 128, the 1,601 image tokens: no
# multiple of a tile), SeamlessM4T's (16 heads of 64 on its 256 frame
# tokens) at a decode block of 32, and its encoder's self-attention over the
# 256 tokens at batch 2 (phase 15's offline shape); SeamlessM4T's cross
# layers at a TP-2 rank's 8 of 16 heads (phase 18a)
CROSS_CASES = (("flash_attention_cross", "vlm cross Lq=32 Lkv=1601", 2, 32, 8, 32, 1601, 128,
                True),
               ("flash_attention_cross_seamless", "seamless cross Lq=32 Lkv=256", 2, 16, 16, 32,
                256, 64, True),
               ("flash_attention_encoder", "seamless encoder Lq=Lkv=256", 2, 16, 16, 256, 256,
                64, False),
               ("flash_attention_cross_tp2", "seamless tp2 cross Lq=32 Lkv=256 H=8", 2, 8, 8, 32,
                256, 64, True))


def check_cross(ref, flash_attention, gen):
    """Kernel 1 at the cross-attention and encoder shapes of phase 15, in the
    path's layouts (q ``[B, L, H, D]`` viewed ``[B, H, L, D]``, K/V the
    cross plane's ``[B, E, Hkv, D]`` views) and positions (cross: every
    query at 0, keys at ``0..E-1``; encoder: both ``0..E-1``, no mask):
    bf16 on the tensor-core body and f32 on the CUDA-core body, each held
    against its plain version, with the library time of SDPA with a bool
    mask.  Every key is admitted, so the bound reads all K/V rows."""
    from repro_torch.kernels.flash_attention import plan

    out = []
    for dt in (torch.float32, torch.bfloat16):
        body = "tensor_core" if dt == torch.bfloat16 else "cuda_core"
        tol = 1e-4 if dt == torch.float32 else 2e-2
        for row, label, b, hq, hkv, lq, lkv, d, cross in CROSS_CASES:
            q = torch.randn(b, lq, hq, d, generator=gen, device="cuda").to(dt).transpose(1, 2)
            k, v = (torch.randn(b, lkv, hkv, d, generator=gen, device="cuda").to(dt)
                    .transpose(1, 2) for _ in "kv")
            kv_pos = torch.arange(lkv, dtype=torch.int32, device="cuda")[None].repeat(b, 1)
            q_pos = (torch.zeros((b, lq), dtype=torch.int32, device="cuda") if cross
                     else kv_pos[:, :lq].contiguous())
            pl = plan(q, k, v, lkv, hkv)
            if pl.body != body:
                raise AssertionError(f"{row} {dt}: {pl}, not the {body} body")
            n_tc = flash_attention.tensor_core_launches
            got = flash_attention(q, k, v, q_pos, kv_pos)
            if (flash_attention.tensor_core_launches - n_tc) != (body == "tensor_core"):
                raise AssertionError(f"{row} {dt}: not launched on the {body} body")
            want = ref.attention_reference(q, k, v, q_pos, kv_pos)
            err = (got.float() - want.float()).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"{row} {label} {dt}: max abs err {err} > {tol}")
            ms, wall = device_ms(lambda: flash_attention(q, k, v, q_pos, kv_pos))
            plain_ms, _ = device_ms(lambda: ref.attention_reference(q, k, v, q_pos, kv_pos))
            mask = ref.attention_mask(q_pos, kv_pos)[:, None]
            lib_ms, _ = device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=hq != hkv))
            kv_bytes = 2 * admitted_kv_rows(mask).sum().item() * hkv * d * k.element_size()
            bms, by = bound(nbytes(q, q_pos, kv_pos, got) + kv_bytes,
                            4.0 * hq * d * mask.sum().item(), dt)
            out.append(dict(kernel="flash_attention", row=row, case=label, dtype=str(dt),
                            max_abs_err=err, tol=tol, ms=ms, wall_ms=wall, plain_ms=plain_ms,
                            library_ms=lib_ms, library="scaled_dot_product_attention",
                            bound_ms=bms, bound_by=by, body=pl.body, n_splits=pl.n_splits,
                            ks=pl.ks, head_dim=d))
    return out

# mamba2-370m's mixer: 32 heads of 64, d_state 128, one B/C group, chunk 64
SSD_H, SSD_P, SSD_N, SSD_CHUNK = 32, 64, 128, 64


def ssd_inputs(gen, b, l, g, dt_type, h=SSD_H, p=SSD_P, n=SSD_N):
    """The chunk step's inputs as the mixer makes them: x [B, L, H, P],
    softplus dt f32, a_log f32, and B, C as strided views of one [B, L, 2GN]
    activation."""
    x = (torch.randn(b, l, h, p, generator=gen, device="cuda") * 0.5).to(dt_type)
    dt = F.softplus(torch.randn(b, l, h, generator=gen, device="cuda") - 1.0)
    a_log = torch.randn(h, generator=gen, device="cuda") * 0.3
    bc = (torch.randn(b, l, 2 * g * n, generator=gen, device="cuda") * 0.5).to(dt_type)
    bm = bc[..., :g * n].reshape(b, l, g, n)
    cm = bc[..., g * n:].reshape(b, l, g, n)
    return x, dt, a_log, bm, cm


def ssd_bound(x, dt, a_log, bm, cm, outs, chunk) -> tuple[float, str]:
    """Least time of the chunk step: each input read once and each output
    written once, against the products the unmasked half needs per (b, h,
    chunk): C B^T over the Q(Q+1)/2 pairs i >= j (on B/C's type, so bf16
    tensor-core peak for bf16 inputs), the scores times x*dt over the same
    pairs and the Q x N x P contribution (f32 operands: x*dt is f32)."""
    b, l, h, p = x.shape
    n = bm.shape[3]
    blocks = b * h * (l // chunk)
    pairs = chunk * (chunk + 1) / 2
    t_cb = blocks * 2.0 * pairs * n / PEAK_FLOPS[bm.dtype] * 1e3
    t_f32 = blocks * (2.0 * pairs * p + 2.0 * chunk * n * p) / PEAK_FLOPS[torch.float32] * 1e3
    t_bytes = ssd_bytes_bound(x, dt, a_log, bm, cm, outs)
    return (t_bytes, "bytes") if t_bytes >= t_cb + t_f32 else (t_cb + t_f32, "operations")


def ssd_bytes_bound(x, dt, a_log, bm, cm, outs) -> float:
    """ms to read each input of the chunk step once and write each output
    once at the HBM rate: the bound when every product runs on the bf16
    tensor cores, as in the tensor-core body."""
    moved = nbytes(x, dt, a_log, *outs) + 2 * bm.numel() * bm.element_size()
    return moved / PEAK_BYTES_PER_S * 1e3


def check_ssd(ref, ops, ssd_chunks, gen):
    """The SSD chunk kernel against ``ref.ssd_chunks`` on all four outputs,
    f32 and bf16: at the decode shape (a 32-row block, one chunk of 32), the
    prefill shape (192 positions, three chunks of 64), two B/C groups, and a
    ragged L of 150 (padded to 192 by ``ops.ssd``, whose output on the card
    is also held against the sequential oracle).  bf16 must take the
    tensor-core body, f32 the CUDA-core body.  At the bf16 decode and G=1
    prefill shapes every heads-per-block choice is timed, and each must give
    the planner's bits."""
    from repro_torch.kernels.ssd_scan import HEADS_PER_BLOCK, plan

    out = []
    for dt_type in (torch.float32, torch.bfloat16):
        for label, b, l, g, chunk in ((f"decode [{SLOTS}, {BLOCK}] G=1", SLOTS, BLOCK, 1, BLOCK),
                                      (f"prefill [{SLOTS}, {T_TOTAL}] G=1", SLOTS, T_TOTAL, 1,
                                       SSD_CHUNK),
                                      (f"prefill [{SLOTS}, {T_TOTAL}] G=2", SLOTS, T_TOTAL, 2,
                                       SSD_CHUNK),
                                      (f"ragged [{SLOTS}, 150] G=1", SLOTS, 150, 1, SSD_CHUNK)):
            args = ssd_inputs(gen, b, l, g, dt_type)
            if l % chunk:                    # what ops.ssd does: zero-dt rows to a multiple
                y_ops, s_ops = ops.ssd(*args, chunk=chunk)
                y_seq, s_seq = ref.ssd_reference(*args)
                for name, got, want in (("y", y_ops, y_seq), ("state", s_ops, s_seq)):
                    tol = 2e-2 if (name == "y" and dt_type == torch.bfloat16) else 1e-3
                    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
                        raise AssertionError(f"ops.ssd {label} {dt_type}: {name} differs from "
                                             f"the sequential oracle by "
                                             f"{(got.float() - want.float()).abs().max().item()}")
                pad = -l % chunk
                x, dt, a_log, bm, cm = args
                x, dt, bm, cm = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                                 for t in (x, dt, bm, cm))
                args = (x, dt, a_log, bm, cm)
            pl = plan(args[0], args[3], chunk, args[4])
            body = "tensor_core" if dt_type == torch.bfloat16 else "cuda_core"
            before = getattr(ssd_chunks, f"{body}_launches")
            got = ssd_chunks(*args, chunk=chunk)
            if pl.body != body or getattr(ssd_chunks, f"{body}_launches") != before + 1:
                raise AssertionError(f"ssd_chunks {label} {dt_type}: planned {pl}, not the "
                                     f"{body} body")
            want = ref.ssd_chunks(*args, chunk)
            errs = []
            for name, gt, wt in zip(("y_intra", "contrib", "decay", "cs"), got, want):
                tol = 1e-2 if (name == "y_intra" and dt_type == torch.bfloat16) else 1e-4
                diff = (gt.float() - wt.float()).abs()
                if not (torch.isfinite(gt).all() and (diff <= tol + tol * wt.float().abs()).all()):
                    raise AssertionError(f"ssd_chunks {label} {dt_type}: {name} max abs err "
                                         f"{diff.max().item()} (tolerance {tol} abs + {tol} rel)")
                errs.append(diff.max().item())
            hb_ms = None
            if body == "tensor_core" and g == 1 and not label.startswith("ragged"):
                hb_ms = {}
                for hb in HEADS_PER_BLOCK:
                    again = ssd_chunks(*args, chunk=chunk, heads_per_block=hb)
                    if not all(torch.equal(a, b) for a, b in zip(again, got)):
                        raise AssertionError(f"ssd_chunks {label}: {hb} heads a block gave "
                                             f"other bits than {pl.heads_per_block}")
                    hb_ms[hb], _ = device_ms(
                        lambda: ssd_chunks(*args, chunk=chunk, heads_per_block=hb))
            ms, wall = device_ms(lambda: ssd_chunks(*args, chunk=chunk))
            plain_ms, _ = device_ms(lambda: ref.ssd_chunks(*args, chunk))
            bms, by = ssd_bound(*args, got, chunk)
            out.append(dict(kernel="ssd_chunks", case=label, dtype=str(dt_type),
                            max_abs_err=max(errs), errs=dict(zip(("y_intra", "contrib", "decay",
                                                                  "cs"), errs)),
                            tol="1e-4 abs + 1e-4 rel (y_intra bf16: 1e-2)", ms=ms, wall_ms=wall,
                            plain_ms=plain_ms, library_ms=None, bound_ms=bms, bound_by=by,
                            bytes_bound_ms=ssd_bytes_bound(*args, got), body=pl.body,
                            heads_per_block=pl.heads_per_block, hb_ms=hb_ms))
    return out


# Jamba's mixer: 128 heads of 64, d_state 64, one B/C group; (label, B, L,
# chunk, the planner's heads per block) at phase 14's served decode and
# offline prefill; the same at a TP-2 rank's 64 heads (phase 18b)
JAMBA_SSD = (128, 64, 64)
JAMBA_SSD_CASES = ((f"jamba decode [{SLOTS}, {BLOCK}] G=1", SLOTS, BLOCK, BLOCK, 2),
                   (f"jamba prefill [2, {T_TOTAL}] G=1", 2, T_TOTAL, SSD_CHUNK, 4))
JAMBA_SSD_TP2_CASES = ((f"jamba tp2 decode [{SLOTS}, {BLOCK}] H=64", SLOTS, BLOCK, BLOCK, 1),
                       (f"jamba tp2 prefill [2, {T_TOTAL}] H=64", 2, T_TOTAL, SSD_CHUNK, 2))


def check_ssd_jamba(ref, ssd_chunks, gen):
    """The SSD chunk kernel at Jamba's widths against ``ref.ssd_chunks`` on
    all four outputs: bf16 on the tensor-core body with the planner's heads
    per block (2 at the decode's 512 one-head blocks, 4 at the prefill's
    768; at a TP-2 rank's 64 heads 1 and 2), f32 on the CUDA-core body;
    every heads-per-block choice timed on the bf16 cases, each giving the
    planner's bits."""
    from repro_torch.kernels.ssd_scan import HEADS_PER_BLOCK, plan

    _, p, n = JAMBA_SSD
    out = []
    for dt_type, (row, h, cases) in ((dt, rc) for dt in (torch.float32, torch.bfloat16)
                                     for rc in (("ssd_chunks_jamba", JAMBA_SSD[0],
                                                 JAMBA_SSD_CASES),
                                                ("ssd_chunks_tp2", JAMBA_SSD[0] // TP,
                                                 JAMBA_SSD_TP2_CASES))):
        for label, b, l, chunk, want_hb in cases:
            args = ssd_inputs(gen, b, l, 1, dt_type, h, p, n)
            pl = plan(args[0], args[3], chunk, args[4])
            body = "tensor_core" if dt_type == torch.bfloat16 else "cuda_core"
            if pl.body != body or (body == "tensor_core" and pl.heads_per_block != want_hb):
                raise AssertionError(f"ssd_chunks {label} {dt_type}: planned {pl}, not the "
                                     f"{body} body at {want_hb} heads a block")
            before = getattr(ssd_chunks, f"{body}_launches")
            got = ssd_chunks(*args, chunk=chunk)
            if getattr(ssd_chunks, f"{body}_launches") != before + 1:
                raise AssertionError(f"ssd_chunks {label} {dt_type}: not launched on {body}")
            want = ref.ssd_chunks(*args, chunk)
            errs = []
            for name, gt, wt in zip(("y_intra", "contrib", "decay", "cs"), got, want):
                tol = 1e-2 if (name == "y_intra" and dt_type == torch.bfloat16) else 1e-4
                diff = (gt.float() - wt.float()).abs()
                if not (torch.isfinite(gt).all() and (diff <= tol + tol * wt.float().abs()).all()):
                    raise AssertionError(f"ssd_chunks {label} {dt_type}: {name} max abs err "
                                         f"{diff.max().item()} (tolerance {tol} abs + {tol} rel)")
                errs.append(diff.max().item())
            hb_ms = None
            if body == "tensor_core":
                hb_ms = {}
                for hb in HEADS_PER_BLOCK:
                    again = ssd_chunks(*args, chunk=chunk, heads_per_block=hb)
                    if not all(torch.equal(a, c) for a, c in zip(again, got)):
                        raise AssertionError(f"ssd_chunks {label}: {hb} heads a block gave "
                                             f"other bits than {pl.heads_per_block}")
                    hb_ms[hb], _ = device_ms(
                        lambda: ssd_chunks(*args, chunk=chunk, heads_per_block=hb))
            ms, wall = device_ms(lambda: ssd_chunks(*args, chunk=chunk))
            plain_ms, _ = device_ms(lambda: ref.ssd_chunks(*args, chunk))
            bms, by = ssd_bound(*args, got, chunk)
            out.append(dict(kernel="ssd_chunks", row=row, case=label,
                            dtype=str(dt_type), max_abs_err=max(errs),
                            errs=dict(zip(("y_intra", "contrib", "decay", "cs"), errs)),
                            tol="1e-4 abs + 1e-4 rel (y_intra bf16: 1e-2)", ms=ms, wall_ms=wall,
                            plain_ms=plain_ms, library_ms=None, bound_ms=bms, bound_by=by,
                            bytes_bound_ms=ssd_bytes_bound(*args, got), body=pl.body,
                            heads_per_block=pl.heads_per_block, hb_ms=hb_ms))
    return out


# the sampled path's draw: 4 slots, a 32-row block, Dream-7B's padded vocab
DRAW_SHAPE = (SLOTS, BLOCK, 152_320)
THREEFRY_VECTOR = ((0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0))
# computed with jax 0.9.0 (jax_threefry_partitionable on): fold_in(fold_in(
# PRNGKey(7), 3), 5) and jax.random.bits of that key at shape (2, 4)
FOLD_IN_7_3_5 = [2377693112, 978177622]
BITS_2X4 = [[285167447, 3080411661, 4150754849, 720547295],
            [2102982906, 2372589642, 1213476380, 3361849757]]


def check_threefry(gen):
    """The threefry key chain on the card: Random123's known answer, the
    reference's fold_in and bits on one key, and a draw of the sampled
    path's shape with bits equal to the CPU's.  Then the draw's time:
    Gumbel noise + argmax alone, and the whole sampled confidence (with
    top-p) beside the greedy one, at that shape."""
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.core import sampler as smp

    words = [torch.tensor(w, dtype=torch.int64, device="cuda") for w in THREEFRY_VECTOR[0]]
    got = tuple(int(x) for x in prng.threefry2x32(*words))
    if got != THREEFRY_VECTOR[1]:
        raise AssertionError(f"threefry2x32 known answer: {got}")
    key = prng.fold_in(prng.fold_in(prng.prng_key(7, device="cuda"), 3), 5)
    if key.tolist() != FOLD_IN_7_3_5:
        raise AssertionError(f"fold_in(fold_in(key(7), 3), 5) = {key.tolist()}")
    if prng.random_bits(key, (2, 4)).tolist() != BITS_2X4:
        raise AssertionError("random_bits at (2, 4) differs from the reference's")
    keys = prng.row_keys(prng.prng_key(0, device="cuda"),
                         torch.arange(SLOTS, dtype=torch.int32, device="cuda"),
                         torch.tensor([0, 5, 64, 1000], dtype=torch.int32, device="cuda"))
    card = prng.random_bits(keys, DRAW_SHAPE[1:]).cpu()
    cpu = prng.random_bits(keys.cpu(), DRAW_SHAPE[1:])
    if not torch.equal(card, cpu):
        raise AssertionError(f"random_bits {DRAW_SHAPE}: card and CPU differ in "
                             f"{int((card != cpu).sum())} elements")
    gumbel_err = (prng.gumbel(keys, DRAW_SHAPE[1:]).cpu()
                  - prng.gumbel(keys.cpu(), DRAW_SHAPE[1:])).abs().max().item()
    logits = torch.randn(DRAW_SHAPE, generator=gen, device="cuda") * 4
    sampled = configs.GenerationConfig(temperature=0.2, top_p=0.95)
    greedy = configs.GenerationConfig()
    vocab = 152_064
    draw_ms, draw_wall = device_ms(lambda: prng.categorical(keys, logits), n=5)
    sampler_ms, sampler_wall = device_ms(
        lambda: smp.confidence_and_pred(keys, logits, sampled, vocab, vocab), n=5)
    greedy_ms, greedy_wall = device_ms(
        lambda: smp.confidence_and_pred(None, logits, greedy, vocab, vocab), n=5)
    return dict(known_answers=True, bits_card_equal_cpu=True, draw_shape=list(DRAW_SHAPE),
                gumbel_card_vs_cpu_max_abs=gumbel_err, draw_ms=draw_ms, draw_wall_ms=draw_wall,
                sampler_top_p_ms=sampler_ms, sampler_top_p_wall_ms=sampler_wall,
                greedy_ms=greedy_ms, greedy_wall_ms=greedy_wall)


# ---------------------------------------------------------------------------
# phases 4-7: the engine and the scheduler
# ---------------------------------------------------------------------------
def cross_device_check():
    from repro_torch import configs
    from repro_torch.core import make_engine
    from repro_torch.models import Model

    cfg = dataclasses.replace(configs.reduced(configs.get_config("llada-8b")), n_layers=4)
    gen_cfg = configs.GenerationConfig(
        mode="es", gen_length=16, block_length=8,
        skip_stages=(configs.SkipStage(1, 0.5), configs.SkipStage(2, 0.5)))
    cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        for p in cpu.parameters():
            if p.dim() >= 2:
                p.mul_(10.0)        # non-degenerate outputs (random init repeats one id)
    card = Model(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    prompt = torch.randint(3, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(SEED + 1))
    eng_cpu = make_engine(cpu, gen_cfg, device="cpu")
    eng_card = make_engine(card, gen_cfg, device="cuda")
    tok_cpu = eng_cpu.generate(prompt)
    tok_card = eng_card.generate(prompt).cpu()
    if not torch.equal(tok_cpu, tok_card):
        raise AssertionError(f"cross-device tokens differ:\n{tok_cpu}\n{tok_card}")
    conf_err = (eng_cpu.last_state.conf - eng_card.last_state.conf.cpu()).abs().max().item()
    if not conf_err <= 1e-4:
        raise AssertionError(f"cross-device final-block conf differs by {conf_err}")
    n_distinct = len(torch.unique(tok_cpu[:, 16:]))
    return dict(tokens_equal=True, conf_max_abs_err=conf_err, distinct_ids=n_distinct)


def serve_trace(sched, prompts, max_new, every: int):
    """Submits request i at scheduler step i * every, drains, and returns the
    requests in submission order."""
    from repro_torch.runtime import Request

    reqs = [Request(prompt=p.copy(), max_new_tokens=m) for p, m in zip(prompts, max_new)]
    step = 0
    while step <= every * (len(reqs) - 1) or sched.has_work():
        if step % every == 0 and step // every < len(reqs):
            sched.submit(reqs[step // every])
        sched.step()
        step += 1
    return reqs


def cross_device_serving():
    """The same staggered trace through the paged scheduler with early
    advance, parallel decoding and the adaptive cache, on the card and on the
    CPU.  Parallel decoding lets a block fill before its last step, so rows
    advance early (a block advance before the phase wrap, with its jump of
    the iteration counter)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.models import Model
    from repro_torch.runtime import StreamScheduler

    cfg = dataclasses.replace(configs.reduced(configs.get_config("llada-8b")), n_layers=4)
    gen_cfg = configs.GenerationConfig(
        mode="es", gen_length=16, block_length=8,
        skip_stages=(configs.SkipStage(1, 0.5), configs.SkipStage(2, 0.5)),
        prompt_refresh_period=4, block_refresh_period=3, cache_prompt_interval=2,
        parallel_decoding=True, pd_threshold=0.5)
    cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        for p in cpu.parameters():
            if p.dim() >= 2:
                p.mul_(10.0)
    card = Model(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(SEED)
    lens, max_new = (16, 5, 12, 9, 16, 3), (None, 8, None, None, 8, None)
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32) for n in lens]
    outs = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        sched = StreamScheduler(model, gen_cfg, device=dev, max_slots=3, prompt_len=16,
                                paged=True, page_size=8, early_advance=True)
        outs[dev] = (serve_trace(sched, prompts, max_new, every=2), sched)
    for a, b in zip(outs["cpu"][0], outs["cuda"][0]):
        if a.output is None or not np.array_equal(a.output, b.output):
            raise AssertionError(f"cross-device serving tokens differ:\n{a.output}\n{b.output}")
    card_sched = outs["cuda"][1]
    if card_sched.engine.pass_counts["partial"] == 0:
        raise AssertionError("cross-device serving ran no partial refresh")
    if card_sched.stats.early_advances == 0:
        raise AssertionError("cross-device serving made no early advance")
    return dict(requests=len(prompts), tokens_equal=True,
                early_advances=card_sched.stats.early_advances,
                early_advances_cpu=outs["cpu"][1].stats.early_advances,
                passes=card_sched.engine.pass_counts,
                distinct_ids=len({int(t) for r in outs["cpu"][0] for t in r.output}))


def reduced_models(arch: str, scale: float = 10.0, capacity_factor=None,
                   n_layers=4) -> dict:
    """A reduced model of ``n_layers`` layers (the reduced config's own
    depth for None) on the CPU, weight matrices x``scale`` (random init
    repeats one id), and its copy on the card; an MoE arch at
    ``capacity_factor`` where given."""
    from repro_torch import configs
    from repro_torch.models import Model

    cfg = configs.reduced(configs.get_config(arch))
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        for p in cpu.parameters():
            if p.dim() >= 2:
                p.mul_(scale)
    card = Model(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    return {"cpu": cpu, "cuda": card}


# phase 4's reduced forms of the archs of phase 13: (arch, capacity factor,
# weight scale).  OLMoE at capacity factor 0.5 runs at x2: at x10 the hidden
# states grow until the card's and the CPU's router probabilities differ by
# more than the closest gaps between a row's experts, and a flipped pick
# moves every later row's capacity slot (tools/torch_moe_drift.py measures
# both; PERF.md §6)
ARCH_CROSS = (("olmoe-1b-7b", 0.5, 2.0), ("granite-moe-1b-a400m", None, 10.0),
              ("gemma3-1b", None, 10.0), ("chatglm3-6b", None, 10.0))


def cross_device_archs(kernel_fns) -> dict:
    """The MoE and remaining dense archs at their reduced sizes in f32 (Gemma-3:
    window 16, every second layer global), the card's kernels against the
    CPU's plain versions: offline es tokens
    equal (prompt 40, so that Gemma-3's window 16 masks), and a paged served
    trace with early advance and the adaptive cache for Gemma-3 and OLMoE
    (tokens equal).  On the card, Gemma-3's attention launches carry the
    window 16 on its local layers and no option on its global ones; the
    MoE archs report the share of routing picks dropped in the card's run."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.core import make_engine
    from repro_torch.models import moe
    from repro_torch.runtime import StreamScheduler

    stages = (configs.SkipStage(1, 0.5), configs.SkipStage(2, 0.5))
    offline = configs.GenerationConfig(mode="es", gen_length=16, block_length=8,
                                       skip_stages=stages)
    served = configs.GenerationConfig(mode="es", gen_length=16, block_length=8,
                                      skip_stages=stages, prompt_refresh_period=4,
                                      block_refresh_period=3, cache_prompt_interval=2)
    out = {}
    routing = moe.routing
    for arch, cf, scale in ARCH_CROSS:
        models = reduced_models(arch, scale, cf)
        vocab = models["cpu"].cfg.vocab_size
        prompt = torch.randint(3, vocab, (2, 40), generator=torch.Generator().manual_seed(SEED))
        toks, kept = {}, []

        def recording(probs, m, cap):
            r = routing(probs, m, cap)
            kept.append(r.kept)
            return r
        for dev in ("cpu", "cuda"):
            zero_counts(kernel_fns)
            moe.routing = recording if dev == "cuda" else routing
            try:
                toks[dev] = make_engine(models[dev], offline, device=dev).generate(prompt).cpu()
            finally:
                moe.routing = routing
        if not torch.equal(toks["cpu"], toks["cuda"]):
            raise AssertionError(f"{arch}: cross-device es tokens differ:\n{toks['cpu']}\n"
                                 f"{toks['cuda']}")
        rec = dict(weight_scale=scale, capacity_factor=cf, es_tokens_equal=True,
                   distinct_ids=len(torch.unique(toks["cpu"][:, 40:])),
                   flash_attention=kernel_fns["flash_attention"].launches)
        if kept:
            rec["dropped_share"] = (sum((~k).sum().item() for k in kept)
                                    / sum(k.numel() for k in kept))
            if cf is not None and cf < 1 and not rec["dropped_share"] > 0:
                raise AssertionError(f"{arch}: no routing pick dropped at capacity factor {cf}")
        if models["cpu"].cfg.sliding_window:
            opts = {str(k): n for k, n in kernel_fns["flash_attention"].option_launches.items()}
            # layers 0 and 2 local (window 16), 1 and 3 global (no option)
            if set(opts) != {str((16, 0, 0, 0, 0)), str((0, 0, 0, 0, 0))} or len(
                    {n for n in opts.values()}) != 1:
                raise AssertionError(f"{arch}: attention option launches {opts}")
            rec["option_launches"] = opts
        if arch in ("gemma3-1b", "olmoe-1b-7b"):
            rng = np.random.default_rng(SEED)
            lens, max_new = (40, 20, 33, 12), (None, 8, None, None)
            prompts = [rng.integers(3, vocab, n).astype(np.int32) for n in lens]
            reqs = {}
            for dev in ("cpu", "cuda"):
                sched = StreamScheduler(models[dev], served, device=dev, max_slots=2,
                                        prompt_len=40, paged=True, page_size=8,
                                        early_advance=True)
                reqs[dev] = serve_trace(sched, prompts, max_new, every=2)
                check_drained(sched, reqs[dev])
            for a, b in zip(reqs["cpu"], reqs["cuda"]):
                if not np.array_equal(a.output, b.output):
                    raise AssertionError(f"{arch}: cross-device served tokens differ:\n"
                                         f"{a.output}\n{b.output}")
            rec.update(served_tokens_equal=True, served_requests=len(prompts),
                       partial_refreshes=sched.engine.pass_counts["partial"])
        out[arch] = rec
    return out


# phase 4's and 14's hybrid
JAMBA = "jamba-v0.1-52b"


def cross_device_jamba() -> dict:
    """Reduced Jamba (16 layers, two periods) in f32, the card's kernels
    against the CPU's plain versions, at capacity factor 0.5 (picks drop)
    and weights x2, as OLMoE's check: offline es tokens equal (the default
    skip stages, on the group-1 boundary); a sampled paged trace of two
    duplicate cohorts with prefix sharing (tokens equal, forks on both); and
    preemption on one slot and a one-request pool (tokens equal, a spill on
    both).  The share of routing picks dropped in the card's offline run is
    reported."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.core import make_engine
    from repro_torch.models import moe
    from repro_torch.runtime import Request, StreamScheduler

    models = reduced_models(JAMBA, 2.0, 0.5, n_layers=None)
    cfg = models["cpu"].cfg
    stages = configs.default_skip_stages(cfg.n_layers)
    offline = configs.GenerationConfig(mode="es", gen_length=16, block_length=8,
                                       skip_stages=stages)
    prompt = torch.randint(3, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(SEED))
    toks, kept = {}, []
    routing = moe.routing

    def recording(probs, m, cap):
        r = routing(probs, m, cap)
        kept.append(r.kept)
        return r
    for dev in ("cpu", "cuda"):
        moe.routing = recording if dev == "cuda" else routing
        try:
            toks[dev] = make_engine(models[dev], offline, device=dev).generate(prompt).cpu()
        finally:
            moe.routing = routing
    if not torch.equal(toks["cpu"], toks["cuda"]):
        raise AssertionError(f"jamba: cross-device es tokens differ:\n{toks['cpu']}\n"
                             f"{toks['cuda']}")
    out = dict(layers=cfg.n_layers, weight_scale=2.0, capacity_factor=0.5,
               es_tokens_equal=True, distinct_ids=len(torch.unique(toks["cpu"][:, 16:])),
               dropped_share=(sum((~k).sum().item() for k in kept)
                              / sum(k.numel() for k in kept)))
    if not out["dropped_share"] > 0:
        raise AssertionError("jamba: no routing pick dropped at capacity factor 0.5")
    served = configs.GenerationConfig(skip_stages=stages, temperature=0.8, **SAMPLED_SERVE)
    rng = np.random.default_rng(SEED)
    a, b = (rng.integers(3, cfg.vocab_size, n).astype(np.int32) for n in (16, 12))
    runs = {"sharing": (dict(max_slots=4, prefix_sharing=True), (a, a, b, b), (0, 0, 0, 0),
                        (0, 0, 0, 0)),
            "preemption": (dict(max_slots=1, kv_pages=5, preemption=True), (a, b), (0, 3),
                           (0, 1))}
    for name, (kw, prompts, arrivals, prios) in runs.items():
        outs = {}
        for dev in ("cpu", "cuda"):
            sched = StreamScheduler(models[dev], served, device=dev, prompt_len=16, paged=True,
                                    page_size=8, early_advance=True, **kw)
            reqs = [Request(prompt=p.copy(), priority=c, sample_seed=100 + i)
                    for i, (p, c) in enumerate(zip(prompts, prios))]
            step = 0
            while step <= max(arrivals) or sched.has_work():
                for at, r in zip(arrivals, reqs):
                    if at == step:
                        sched.submit(r)
                sched.step()
                step += 1
            check_drained(sched, reqs, served.gen_length)
            outs[dev] = ([r.output for r in reqs], sched.stats)
            if (sched.stats.cow_forks if name == "sharing" else sched.stats.preemptions) < 1:
                raise AssertionError(f"jamba {name} on {dev}: {sched.stats.gauges()}")
        for i, (x, y) in enumerate(zip(outs["cpu"][0], outs["cuda"][0])):
            if not np.array_equal(x, y):
                raise AssertionError(f"jamba {name}, request {i}: card {y}, CPU {x}")
        st = outs["cuda"][1]
        out[name] = dict(requests=len(prompts), tokens_equal=True, cow_forks=st.cow_forks,
                         preemptions=st.preemptions, pages_spilled=st.pages_spilled,
                         distinct_ids=len({int(t) for o in outs["cuda"][0] for t in o}))
    return out


# phase 4's and 15's encoder-conditioned archs
VLM = "llama-3.2-vision-11b"
AUDIO = "seamless-m4t-large-v2"


def cross_device_encoders(kernel_fns) -> dict:
    """Reduced Llama-3.2-Vision (10 layers, cross layers 3 and 8, patch
    embeddings of 128 projected by ``enc_proj`` to 256) and reduced
    SeamlessM4T (2 encoder and 2 decoder layers) in f32, weights x10, the
    card's kernels against the CPU's plain versions: offline es tokens equal
    with one ``enc_embeds`` a row, greedy, and sampled on SeamlessM4T, whose
    greedy blocks unmask in their prefill (its decoder has no
    self-attention, so a block's [mask] rows tie).  On the card, kernel 1
    must run as cross-attention (and as SeamlessM4T's encoder)."""
    from repro_torch import configs
    from repro_torch.core import make_engine

    out = {}
    for arch, temps in ((VLM, (0.0,)), (AUDIO, (0.0, 0.8))):
        models = reduced_models(arch, 10.0, n_layers=None)
        cfg = models["cpu"].cfg
        g = torch.Generator().manual_seed(SEED)
        prompt = torch.randint(3, cfg.vocab_size, (2, 16), generator=g)
        enc = torch.randn(2, cfg.n_enc_tokens, cfg.d_enc, generator=g)
        rec = dict(layers=cfg.n_layers, cross_layers=models["cpu"].cross_layers,
                   enc_proj=models["cpu"].enc_proj is not None, weight_scale=10.0)
        for temp in temps:
            gen_cfg = configs.GenerationConfig(
                mode="es", gen_length=16, block_length=8, temperature=temp,
                skip_stages=configs.default_skip_stages(cfg.n_layers))
            toks = {}
            for dev in ("cpu", "cuda"):
                zero_counts(kernel_fns)
                with CrossLaunches(models[dev]) as cl:
                    toks[dev] = make_engine(models[dev], gen_cfg, device=dev).generate(
                        prompt, enc_embeds=enc).cpu()
            if not torch.equal(toks["cpu"], toks["cuda"]):
                raise AssertionError(f"{arch} t={temp}: cross-device es tokens differ:\n"
                                     f"{toks['cpu']}\n{toks['cuda']}")
            if cl.cross <= 0 or (models["cuda"].encoder is not None and cl.encoder <= 0):
                raise AssertionError(f"{arch}: kernel 1 launches as cross-attention "
                                     f"{cl.cross}, in the encoder {cl.encoder}")
            rec[f"t{temp}"] = dict(es_tokens_equal=True,
                                   distinct_ids=len(torch.unique(toks["cpu"][:, 16:])),
                                   cross_launches=cl.cross, encoder_launches=cl.encoder,
                                   flash_attention=kernel_fns["flash_attention"].launches)
        out[arch] = rec
    return out


class CrossLaunches:
    """Counts kernel 1's launches (``flash_attention.launches``) made inside
    the cross-attention layers (``cross``) and inside ``model.encode``
    (``encoder``), and the ``model.encode`` calls (``encodes``), while the
    context is open; on the CPU the launches stay 0."""

    def __init__(self, model):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.models import model as model_mod

        self.fa, self.mod, self.model = fa.flash_attention, model_mod, model
        self.cross = self.encoder = self.encodes = 0

    def __enter__(self):
        orig_cross, orig_encode = self.mod.cross_attention, self.model.encode

        def counted(count, fn):
            def wrapper(*args, **kw):
                n0 = self.fa.launches
                self.encodes += count == "encoder"
                try:
                    return fn(*args, **kw)
                finally:
                    setattr(self, count, getattr(self, count) + self.fa.launches - n0)
            return wrapper
        self.restore = (orig_cross, orig_encode)
        self.mod.cross_attention = counted("cross", orig_cross)
        self.model.encode = counted("encoder", orig_encode)
        return self

    def __exit__(self, *exc):
        self.mod.cross_attention = self.restore[0]
        del self.model.encode                  # the class's method again

def check_drained(sched, reqs, n_tokens=None) -> None:
    """Every request finished cleanly and every page came back."""
    for r in reqs:
        if r.error is not None or r.output is None:
            raise AssertionError(f"request {r.request_id}: error {r.error!r}")
        if n_tokens is not None and r.output.shape != (n_tokens,):
            raise AssertionError(f"request {r.request_id}: output shape {r.output.shape}")
        if (r.output == sched.engine.mask_id).any():
            raise AssertionError(f"request {r.request_id}: a [mask] id is left in the output")
    al = sched.allocator
    if al.free_pages != al.num_pages - 1 or sched.stats.pages_in_use or sched.cohorts:
        raise AssertionError("the pool did not get every page back after the drain")


# reduced sampled serving: 16-token prompts, two blocks of 8, a prompt
# refresh every 4 iterations (so cohorts fork after their first draws)
SAMPLED_SERVE = dict(mode="es", gen_length=16, block_length=8, prompt_refresh_period=4,
                     block_refresh_period=3)


def cross_device_sampled_serving(**engine_kw) -> dict:
    """Sampled serving with prefix sharing on reduced LLaDA and Dream (top-p):
    two duplicate-prompt cohorts and one other request, all admitted in one
    cycle.  Every request's tokens on the card equal the CPU's and the card's
    unshared run; the cohorts forked and every page came back.  ``engine_kw``
    goes to the engine (the int8 cache: its scale pools fork too)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.runtime import Request, StreamScheduler

    out = {}
    for arch, sampling in (("llada-8b", dict(temperature=0.8)),
                           ("dream-7b", dict(temperature=0.7, top_p=0.9))):
        models = reduced_models(arch)
        gen_cfg = configs.GenerationConfig(
            skip_stages=(configs.SkipStage(1, 0.5), configs.SkipStage(2, 0.5)),
            **SAMPLED_SERVE, **sampling)
        rng = np.random.default_rng(SEED)
        a, b, c = (rng.integers(3, models["cpu"].cfg.vocab_size, n).astype(np.int32)
                   for n in (16, 12, 9))
        prompts = (a, a, b, b, c)

        def run(dev, sharing):
            sched = StreamScheduler(models[dev], gen_cfg, device=dev, max_slots=5,
                                    prompt_len=16, paged=True, page_size=8,
                                    prefix_sharing=sharing, **engine_kw)
            reqs = [Request(prompt=p.copy(), sample_seed=100 + i) for i, p in enumerate(prompts)]
            for r in reqs:
                sched.submit(r)
            sched.drain()
            check_drained(sched, reqs, gen_cfg.gen_length)
            return [r.output for r in reqs], sched
        cpu_out, cpu_sched = run("cpu", True)
        card_out, card_sched = run("cuda", True)
        solo_out, _ = run("cuda", False)
        for i, (x, y, z) in enumerate(zip(cpu_out, card_out, solo_out)):
            if not (np.array_equal(x, y) and np.array_equal(y, z)):
                raise AssertionError(f"{arch} sampled serving, request {i}: card {y}, CPU {x}, "
                                     f"card unshared {z}")
        if not (card_sched.stats.cow_forks > 0 and cpu_sched.stats.cow_forks > 0):
            raise AssertionError(f"{arch} sampled serving: no copy-on-write fork")
        if np.array_equal(card_out[0], card_out[1]):
            raise AssertionError(f"{arch}: two seeds of one prompt sampled the same tokens")
        out[arch] = dict(requests=len(prompts), tokens_equal=True,
                         cow_forks=card_sched.stats.cow_forks,
                         cow_forks_cpu=cpu_sched.stats.cow_forks,
                         distinct_ids=len({int(t) for o in card_out for t in o}))
    return out


def cross_device_preemption(arch: str = "dream-7b", **engine_kw) -> dict:
    """Sampled reduced Dream (or ``arch``) on a pool that holds one request:
    the higher-class arrival spills the resident, which resumes later; both
    requests' tokens equal their uninterrupted offline runs, on the card and
    on the CPU.  ``engine_kw`` goes to the engines (the int8 cache: every
    plane spills and restores)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.core import make_engine
    from repro_torch.runtime import Request, StreamScheduler

    models = reduced_models(arch)
    gen_cfg = configs.GenerationConfig(
        mode="es", gen_length=16, block_length=8, skip_stages=(configs.SkipStage(1, 0.5),),
        prompt_refresh_period=8, block_refresh_period=4, temperature=0.8)
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(3, models["cpu"].cfg.vocab_size, 16).astype(np.int32)
               for _ in range(2)]
    outs = {}
    for dev in ("cpu", "cuda"):
        sched = StreamScheduler(models[dev], gen_cfg, device=dev, max_slots=2, prompt_len=16,
                                paged=True, page_size=8, kv_pages=5, preemption=True,
                                **engine_kw)
        low = Request(prompt=prompts[0].copy(), priority=0, sample_seed=11)
        high = Request(prompt=prompts[1].copy(), priority=1, sample_seed=22)
        sched.submit(low)
        sched.step()
        sched.submit(high)
        sched.drain()
        check_drained(sched, (low, high), gen_cfg.gen_length)
        if sched.stats.preemptions < 1 or len(sched.stats.resume_waits) != sched.stats.preemptions:
            raise AssertionError(f"preemption on {dev}: {sched.stats.gauges()}")
        outs[dev] = ([low.output, high.output], sched.stats.gauges())
    offline = make_engine(models["cuda"], gen_cfg, device="cuda", paged=True, page_size=8,
                          **engine_kw)
    ref = offline.generate(torch.from_numpy(np.stack(prompts)),
                           sample_seeds=torch.tensor([11, 22])).cpu().numpy()[:, 16:]
    for i in range(2):
        if not (np.array_equal(outs["cuda"][0][i], ref[i])
                and np.array_equal(outs["cpu"][0][i], ref[i])):
            raise AssertionError(f"preempted serving, request {i}: card {outs['cuda'][0][i]}, "
                                 f"CPU {outs['cpu'][0][i]}, uninterrupted {ref[i]}")
    g = outs["cuda"][1]
    return dict(tokens_equal_uninterrupted=True, preemptions=g["preemptions"],
                pages_spilled=g["pages_spilled"], resume_p50_s=g["resume_p50"])


def cross_device_quarantine() -> dict:
    """NaN written into one slot's private page on the card: that request is
    quarantined with ``PoisonedRequest``, the bystander's sampled tokens
    equal its solo offline run, and no non-finite value is left in the pool."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.core import make_engine
    from repro_torch.runtime import PoisonedRequest, Request, StreamScheduler

    model = reduced_models("llada-8b")["cuda"]
    gen_cfg = configs.GenerationConfig(
        mode="es", gen_length=16, block_length=8, skip_stages=(configs.SkipStage(1, 0.5),),
        prompt_refresh_period=8, block_refresh_period=4, temperature=0.8)
    rng = np.random.default_rng(SEED + 3)
    victim, bystander = (Request(prompt=rng.integers(3, model.cfg.vocab_size, 16)
                                 .astype(np.int32), sample_seed=s) for s in (1, 2))
    sched = StreamScheduler(model, gen_cfg, device="cuda", max_slots=2, prompt_len=16,
                            paged=True, page_size=8)
    sched.submit(victim)
    sched.submit(bystander)
    sched.step()
    for _ in range(60):                  # re-inject until a decode reads it
        if sched.stats.poisoned_requests:
            break
        page = int(sched.state.block_tables[0, int(sched.state.bs[0]) // 8])
        if sched.allocator.refcount(page) != 1:
            raise AssertionError("the poisoned page is not the victim's own")
        sched.state.cache.k[:, page] = float("nan")
        sched.step()
    sched.drain()
    if not isinstance(victim.error, PoisonedRequest) or victim.output is not None:
        raise AssertionError(f"the poisoned request was not quarantined: {victim.error!r}")
    check_drained(sched, (bystander,), gen_cfg.gen_length)
    ref = make_engine(model, gen_cfg, device="cuda", paged=True, page_size=8).generate(
        torch.from_numpy(bystander.prompt[None]), sample_seeds=torch.tensor([2]))
    if not np.array_equal(bystander.output, ref.cpu().numpy()[0, 16:]):
        raise AssertionError("the bystander's tokens changed next to the poisoned row")
    for pool in (sched.state.cache.k, sched.state.cache.v):
        if not torch.isfinite(pool).all():
            raise AssertionError("a non-finite value survived the quarantine in the pool")
    return dict(poisoned_requests=sched.stats.poisoned_requests, bystander_equal=True,
                pool_finite=True)


# (arrival step, prompt id, max_new_tokens) of the reduced block-causal trace:
# prompt 0 returns after its first request retired (a store hit in a later
# cycle), prompt 1 twice in one cycle, and the pool is one request short of
# two full ones, so admissions evict store entries
BC_TRACE = ((0, 0, None), (0, 1, None), (1, 1, 16), (4, 2, None), (9, 0, None),
            (10, 3, 16), (14, 0, 16))


def store_pages_unchanged():
    """A per-step check for a scheduler with the persistent store: each
    store entry's prompt-page bytes stay what they were at the end of the
    step that registered the entry (no refresh writes a shared prompt
    page).  Returns (check, counter of pages compared)."""
    snap: dict = {}
    compared = [0]

    def check(sched):
        st, live = sched.state, {}
        for key, (_, page_map) in sched.allocator._prefix.items():
            for _, pg in page_map:
                live[(key, pg)] = (st.cache.k[:, pg].clone(), st.cache.v[:, pg].clone())
        for k, (kb, vb) in live.items():
            if k in snap:
                if not (torch.equal(kb, snap[k][0]) and torch.equal(vb, snap[k][1])):
                    raise AssertionError(f"a refresh wrote store-shared page {k[1]}")
                compared[0] += 1
        snap.clear()
        snap.update(live)
    return check, compared


def cross_device_block_causal() -> dict:
    """Reduced LLaDA in float32, the card against the CPU: offline es with
    block-causal attention (4 blocks, so the refresh exemption runs), with
    the sliding window (one block of look-ahead), and with the engine's
    window override and anchor beside block-causal, dense and paged (every
    attention launch keyed with all four options), then a served trace
    with block-causal attention, the window and the persistent prefix store
    (hits in later cycles, evictions under a tight pool).  Tokens equal, the
    store gauges equal, and no refresh changed a store-shared prompt page."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.core import make_engine
    from repro_torch.kernels.flash_attention import flash_attention, paged_flash_attention
    from repro_torch.runtime import Request, StreamScheduler

    models = reduced_models("llada-8b")
    stages = (configs.SkipStage(1, 0.5), configs.SkipStage(2, 0.5))
    base = dict(mode="es", gen_length=32, block_length=8, skip_stages=stages,
                prompt_refresh_period=2, block_refresh_period=4)
    prompt = torch.randint(3, models["cpu"].cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(SEED + 2))
    out: dict = {}
    # the engine's window override and anchor, with block-causal attention,
    # dense and paged: the one path that passes window and anchor to the kernels
    wa = dict(window_override=6, anchor=5)
    for name, extra, ekw in (
            ("offline_bc", dict(block_causal=True), {}),
            ("offline_window", dict(window_blocks=1), {}),
            ("offline_window_override_anchor", dict(block_causal=True), wa),
            ("offline_window_override_anchor_paged", dict(block_causal=True),
             dict(wa, paged=True, page_size=8))):
        gen_cfg = configs.GenerationConfig(**base, **extra)
        toks, confs = {}, {}
        for fn in (flash_attention, paged_flash_attention):
            fn.option_launches = {}
        for dev in ("cpu", "cuda"):
            eng = make_engine(models[dev], gen_cfg, device=dev, **ekw)
            toks[dev] = eng.generate(prompt).cpu()
            confs[dev] = eng.last_state.conf.cpu()
        if not torch.equal(toks["cpu"], toks["cuda"]):
            raise AssertionError(f"{name}: card tokens differ from the CPU's:\n"
                                 f"{toks['cpu']}\n{toks['cuda']}")
        out[name] = dict(tokens_equal=True,
                         conf_max_abs_err=(confs["cpu"] - confs["cuda"]).abs().max().item(),
                         distinct_ids=len(torch.unique(toks["cpu"][:, 16:])))
        if "anchor" in ekw:
            fn = paged_flash_attention if ekw.get("paged") else flash_attention
            key = (6, 5, 0, 16, gen_cfg.block_length)
            if set(fn.option_launches) != {key}:
                raise AssertionError(f"{name}: attention launches keyed "
                                     f"{fn.option_launches}, not only {key}")
            out[name]["option_launches"] = {str(k): n for k, n in fn.option_launches.items()}
    gen_cfg = configs.GenerationConfig(**base, block_causal=True, window_blocks=1)
    rng = np.random.default_rng(SEED + 5)
    prompts = [rng.integers(3, models["cpu"].cfg.vocab_size, n).astype(np.int32)
               for n in (16, 14, 16, 11)]
    runs = {}
    for dev in ("cpu", "cuda"):
        sched = StreamScheduler(models[dev], gen_cfg, device=dev, max_slots=2, prompt_len=16,
                                paged=True, page_size=8, kv_pages=2 * 6 + 1,
                                prefix_sharing=True, early_advance=True)
        check, compared = store_pages_unchanged()
        reqs = [Request(prompt=prompts[i].copy(), max_new_tokens=m) for _, i, m in BC_TRACE]
        step = 0
        while step <= BC_TRACE[-1][0] or sched.has_work():
            for (at, _, _), r in zip(BC_TRACE, reqs):
                if at == step:
                    sched.submit(r)
            sched.step()
            check(sched)
            step += 1
        for r in reqs:
            if r.error is not None or r.output is None:
                raise AssertionError(f"bc serving on {dev}: request {r.request_id} {r.error!r}")
        runs[dev] = (reqs, sched.stats, compared[0])
    for a, b in zip(runs["cpu"][0], runs["cuda"][0]):
        if not np.array_equal(a.output, b.output):
            raise AssertionError(f"bc serving tokens differ:\n{a.output}\n{b.output}")
    gauges = ("prefix_hits", "prefix_evictions", "invariant_tokens_skipped")
    card = {g: getattr(runs["cuda"][1], g) for g in gauges}
    cpu = {g: getattr(runs["cpu"][1], g) for g in gauges}
    if card != cpu:
        raise AssertionError(f"bc serving gauges differ: card {card}, CPU {cpu}")
    if not (card["prefix_hits"] > 0 and card["prefix_evictions"] > 0
            and card["invariant_tokens_skipped"] > 0 and runs["cuda"][2] > 0):
        raise AssertionError(f"bc serving: store or exemption not exercised: {card}")
    out["served_bc_store_window"] = dict(requests=len(BC_TRACE), tokens_equal=True, **card,
                                         store_pages_compared=runs["cuda"][2])
    return out


# (prompt length, request options) of the reduced lazy trace on a pool of 10
# pages: the first grows past its one-block hint, and of the two full
# requests after it the younger stalls
LAZY_TRACE = ((12, dict(max_new_tokens=8, max_blocks=3)), (16, {}), (16, {}))
LAZY_GAUGES = ("pages_deferred", "blocks_grown", "window_stalls", "peak_pages_in_use")


def cross_device_sparse() -> dict:
    """Reduced LLaDA in float32, weights x2 (at x10 the eviction probe's
    softmax saturates and its threshold falls between values an ulp apart,
    which the kernels and the plain versions round differently), the card
    against the CPU: offline es with sparse eviction, dense and paged (greedy
    tokens and the last retained set equal); paged serving at retention 0.3
    (tokens equal, ``pages_reclaimed`` equal and > 0); lazy reservation with
    the one-block window on a 10-page pool (tokens and the lazy gauges equal,
    a stall and a growth)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.core import make_engine
    from repro_torch.runtime import Request, StreamScheduler

    models = reduced_models("llada-8b", scale=2.0)
    vocab = models["cpu"].cfg.vocab_size
    sparse = dict(mode="es", gen_length=16, block_length=4, prompt_refresh_period=2,
                  block_refresh_period=3, sparse_attention=True, sparse_retention=0.5,
                  skip_stages=(configs.SkipStage(1, 0.5), configs.SkipStage(2, 0.5)))
    prompt = torch.randint(3, vocab, (2, 16), generator=torch.Generator().manual_seed(SEED + 2))
    out: dict = {}
    for name, ekw in (("offline_sparse", {}), ("offline_sparse_paged", dict(paged=True,
                                                                             page_size=8))):
        toks, kv = {}, {}
        for dev, model in models.items():
            eng = make_engine(model, configs.GenerationConfig(**sparse), device=model.device,
                              **ekw)
            toks[dev] = eng.generate(prompt).cpu()
            kv[dev] = eng.last_state.kv_valid.cpu()
        if not (torch.equal(toks["cpu"], toks["cuda"]) and torch.equal(kv["cpu"], kv["cuda"])):
            raise AssertionError(f"{name}: card tokens or retained set differ from the CPU's:"
                                 f"\n{toks['cpu']}\n{toks['cuda']}")
        out[name] = dict(tokens_equal=True, retained_equal=True,
                         retained_share=kv["cpu"].float().mean().item(),
                         distinct_ids=len(torch.unique(toks["cpu"][:, 16:])))

    def serve(gen_cfg, plan, **skw):
        runs = {}
        for dev, model in models.items():
            sched = StreamScheduler(model, gen_cfg, device=model.device, max_slots=2,
                                    prompt_len=16, paged=True, page_size=8, **skw)
            reqs = [Request(prompt=p.copy(), **kw) for p, kw in plan]
            for r in reqs:
                sched.submit(r)
            sched.drain()
            check_drained(sched, reqs)
            runs[dev] = ([r.output for r in reqs], sched.stats)
        for a, b in zip(runs["cpu"][0], runs["cuda"][0]):
            if not np.array_equal(a, b):
                raise AssertionError(f"served tokens differ:\n{a}\n{b}")
        return runs["cpu"][1], runs["cuda"][1]

    rng = np.random.default_rng(SEED + 3)
    plan = [(rng.integers(3, vocab, 16).astype(np.int32), {}) for _ in range(4)]
    cpu, card_st = serve(configs.GenerationConfig(
        **{**sparse, "sparse_retention": 0.3, "block_length": 8}), plan)
    if not cpu.pages_reclaimed == card_st.pages_reclaimed > 0:
        raise AssertionError(f"sparse serving: pages_reclaimed {card_st.pages_reclaimed} on "
                             f"the card, {cpu.pages_reclaimed} on the CPU")
    out["served_sparse_reclaim"] = dict(requests=len(plan), tokens_equal=True,
                                        pages_reclaimed=card_st.pages_reclaimed)
    lazy = dict(mode="es", gen_length=32, block_length=8, prompt_refresh_period=2,
                block_refresh_period=4, window_blocks=1,
                skip_stages=(configs.SkipStage(1, 0.5),))
    plan = [(rng.integers(3, vocab, n).astype(np.int32), kw) for n, kw in LAZY_TRACE]
    cpu, card_st = serve(configs.GenerationConfig(**lazy), plan, kv_pages=11,
                         early_advance=True, lazy_reserve=True)
    gauges = {g: getattr(card_st, g) for g in LAZY_GAUGES}
    if gauges != {g: getattr(cpu, g) for g in LAZY_GAUGES}:
        raise AssertionError(f"lazy serving gauges differ: card {gauges}, CPU "
                             f"{ {g: getattr(cpu, g) for g in LAZY_GAUGES} }")
    if not (gauges["window_stalls"] > 0 and gauges["blocks_grown"] > 0):
        raise AssertionError(f"lazy serving: no stall or no growth: {gauges}")
    out["served_lazy_tight_pool"] = dict(requests=len(plan), tokens_equal=True, **gauges)
    return out


def cross_device_int8_gather() -> dict:
    """The int8 KV cache and the gathered-subset refresh on reduced LLaDA and
    Dream in float32 (int8 attention on the CUDA-core body, f32 rows into
    the quantizing scatter): int8 offline es, dense and paged, greedy tokens
    equal on the card and the CPU; served with ``gather_refresh`` on two
    slots (a refresh of one row runs compacted), adaptive cache off and on,
    the card's tokens equal the CPU's and the card's without it, and the
    compact branch ran on the card."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.core import make_engine
    from repro_torch.runtime import Request, StreamScheduler

    out = {}
    for arch in ("llada-8b", "dream-7b"):
        models = reduced_models(arch)
        vocab = models["cpu"].cfg.vocab_size
        rec = {}
        gen_cfg = configs.GenerationConfig(
            mode="es", gen_length=16, block_length=8,
            skip_stages=(configs.SkipStage(1, 0.5), configs.SkipStage(2, 0.5)))
        prompt = torch.randint(3, vocab, (2, 16), generator=torch.Generator().manual_seed(SEED + 1))
        for name, kw in (("int8 dense", {}), ("int8 paged", dict(paged=True, page_size=8))):
            toks = {dev: make_engine(models[dev], gen_cfg, device=dev, kv_cache_dtype="int8",
                                     **kw).generate(prompt).cpu() for dev in ("cpu", "cuda")}
            if not torch.equal(toks["cpu"], toks["cuda"]):
                raise AssertionError(f"{arch} {name}: card tokens differ from the CPU's:\n"
                                     f"{toks['cpu']}\n{toks['cuda']}")
            rec[name] = dict(tokens_equal=True, distinct_ids=len(torch.unique(toks["cpu"][:, 16:])))
        rng = np.random.default_rng(SEED + 5)
        prompts = [rng.integers(3, vocab, int(rng.integers(4, 17))).astype(np.int32)
                   for _ in range(5)]
        for interval in (0, 2):
            served = configs.GenerationConfig(
                mode="es", gen_length=16, block_length=8, skip_stages=(configs.SkipStage(1, 0.5),),
                prompt_refresh_period=2, block_refresh_period=4, cache_prompt_interval=interval)

            def run(dev, gather):
                sched = StreamScheduler(models[dev], served, device=dev, max_slots=2,
                                        prompt_len=16, paged=True, page_size=8,
                                        early_advance=True, gather_refresh=gather)
                reqs = [Request(prompt=p.copy(), sample_seed=i) for i, p in enumerate(prompts)]
                for r in reqs:
                    sched.submit(r)
                sched.drain()
                check_drained(sched, reqs)
                return [r.output for r in reqs], sched.engine.compact_prefill
            (cpu_out, _), (card_out, n_compact), (plain_out, _) = (
                run("cpu", True), run("cuda", True), run("cuda", False))
            for i, (x, y, z) in enumerate(zip(cpu_out, card_out, plain_out)):
                if not (np.array_equal(x, y) and np.array_equal(y, z)):
                    raise AssertionError(f"{arch} gather_refresh cache {interval}, request {i}: "
                                         f"card {y}, CPU {x}, card without it {z}")
            if n_compact <= 0:
                raise AssertionError(f"{arch} gather_refresh: the compact branch did not run")
            rec[f"gather_refresh cache_prompt_interval={interval}"] = dict(
                tokens_equal=True, compact_prefill=n_compact)
        out[arch] = rec
    return out


def cross_device_mamba() -> dict:
    """Reduced 4-layer mamba2-370m (skip stages at layers 1 and 2): offline
    es generation greedy and sampled, and a staggered trace through the
    dense-slot scheduler with early advance; every token on the card equals
    the CPU's."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.core import make_engine
    from repro_torch.runtime import StreamScheduler

    models = reduced_models("mamba2-370m")
    stages = (configs.SkipStage(1, 0.5), configs.SkipStage(2, 0.5))
    prompt = torch.randint(3, models["cpu"].cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(SEED + 4))
    out = {}
    for name, kw in (("greedy", {}), ("sampled", dict(temperature=0.8))):
        gen_cfg = configs.GenerationConfig(mode="es", gen_length=16, block_length=8,
                                           skip_stages=stages, **kw)
        toks = {dev: make_engine(models[dev], gen_cfg, device=dev).generate(prompt).cpu()
                for dev in ("cpu", "cuda")}
        if not torch.equal(toks["cpu"], toks["cuda"]):
            raise AssertionError(f"mamba2 {name}: card tokens {toks['cuda']} differ from the "
                                 f"CPU's {toks['cpu']}")
        out[name] = dict(tokens_equal=True, distinct_ids=len(torch.unique(toks["cpu"][:, 16:])))
    gen_cfg = configs.GenerationConfig(
        mode="es", gen_length=16, block_length=8, skip_stages=stages, prompt_refresh_period=4,
        block_refresh_period=3, parallel_decoding=True, pd_threshold=0.5)
    rng = np.random.default_rng(SEED)
    lens, max_new = (16, 5, 12, 9, 16, 3), (None, 8, None, None, 8, None)
    prompts = [rng.integers(3, models["cpu"].cfg.vocab_size, n).astype(np.int32) for n in lens]
    served = {}
    for dev in ("cpu", "cuda"):
        sched = StreamScheduler(models[dev], gen_cfg, device=dev, max_slots=3, prompt_len=16,
                                early_advance=True)
        served[dev] = (serve_trace(sched, prompts, max_new, every=2), sched)
    for a, b in zip(served["cpu"][0], served["cuda"][0]):
        if a.output is None or not np.array_equal(a.output, b.output):
            raise AssertionError(f"mamba2 serving: card tokens {b.output} differ from the "
                                 f"CPU's {a.output}")
    card = served["cuda"][1]
    if card.stats.early_advances == 0:
        raise AssertionError("mamba2 serving made no early advance")
    out["serving"] = dict(requests=len(prompts), tokens_equal=True,
                          early_advances=card.stats.early_advances,
                          passes=dict(card.engine.pass_counts))
    return out


def llada_8b(n_layers=None):
    """LLaDA-8B at full width in bf16 (depth ``n_layers`` if given), random
    weights from a seeded generator on the card."""
    from repro_torch import configs
    from repro_torch.models import Model

    cfg = dataclasses.replace(configs.get_config("llada-8b"),
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def main_path(model, init_s, kernel_fns):
    from repro_torch import configs
    from repro_torch.core import make_engine

    cfg = model.cfg
    batch, prompt_len = 2, 128
    gen_cfg = configs.GenerationConfig(
        mode="es", gen_length=64, block_length=32,
        skip_stages=configs.default_skip_stages(cfg.n_layers),
        prompt_refresh_period=32, block_refresh_period=4)
    weights_gb = sum(nbytes(p) for p in model.parameters()) / 1e9
    prompt = torch.randint(3, cfg.vocab_size, (batch, prompt_len), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(SEED + 1))
    engine = make_engine(model, gen_cfg, device="cuda")
    engine.generate(prompt)                       # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    zero_counts(kernel_fns)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = engine.generate(prompt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(kernel_fns)
    repeats = [wall]                    # host time varies: the spread of a few runs
    for _ in range(2):
        t0 = time.perf_counter()
        again = engine.generate(prompt)
        torch.cuda.synchronize()
        repeats.append(time.perf_counter() - t0)
        if not torch.equal(again, out):
            raise AssertionError("a repeated greedy generate gave other tokens")
    profile = profile_run(lambda: engine.generate(prompt))
    gen_tok = out[:, prompt_len:]
    if out.shape != (batch, prompt_len + gen_cfg.gen_length):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if (gen_tok == engine.mask_id).any().item():
        raise AssertionError("a [mask] id is left in the output")
    if not ((gen_tok >= 0) & (gen_tok < cfg.vocab_size)).all().item():
        raise AssertionError("generated ids outside the vocabulary")
    for name in ("flash_attention", "scatter_rows", "importance"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the offline path")
    return dict(arch=cfg.name, dtype="bfloat16", layers=cfg.n_layers, d_model=cfg.d_model,
                weights_gb=weights_gb, init_s=init_s, batch=batch, prompt_len=prompt_len,
                gen_length=gen_cfg.gen_length, block_length=gen_cfg.block_length,
                segments=[dataclasses.asdict(s) for s in engine.segments],
                iterations=engine.iterations, wall_s=wall, wall_s_repeats=repeats,
                tokens_per_s=batch * gen_cfg.gen_length / wall,
                tokens_per_s_best=batch * gen_cfg.gen_length / min(repeats),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                distinct_ids=len(torch.unique(gen_tok)), launches=launches, profile=profile)


def serving_path(model, kernel_fns):
    """The paged scheduler at full width: 8 requests (prompts of 32, 64, 96
    and 128 tokens, two each; 32 or 64 new tokens), one submitted every 5
    steps, so rows sit at different phases and one step runs several
    passes.  Phases 8 and 24 of each 32-step block are partial refreshes."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.runtime import StreamScheduler

    cfg = model.cfg
    gen_cfg = configs.GenerationConfig(
        mode="es", gen_length=GEN, block_length=BLOCK,
        skip_stages=configs.default_skip_stages(cfg.n_layers),
        prompt_refresh_period=8, block_refresh_period=4, cache_prompt_interval=2)
    rng = np.random.default_rng(SEED)
    lens = (32, 64, 96, 128, 32, 64, 96, 128)
    max_new = (64, 32, 64, 32, 32, 64, 32, 64)
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32) for n in lens]

    def make():
        return StreamScheduler(model, gen_cfg, device="cuda", max_slots=SLOTS,
                               prompt_len=PROMPT, paged=True, page_size=16,
                               early_advance=True)
    serve_trace(make(), prompts[:1], max_new[:1], every=5)     # warm-up
    torch.cuda.synchronize()
    sched = make()
    zero_counts(kernel_fns)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reqs = serve_trace(sched, prompts, max_new, every=5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(kernel_fns)
    peak_mem = torch.cuda.max_memory_allocated() / 1e9
    for r, n in zip(reqs, max_new):
        if r.output is None or r.output.shape != (n,):
            raise AssertionError(f"request {r.request_id}: output {r.output}")
        if (r.output == sched.engine.mask_id).any():
            raise AssertionError(f"request {r.request_id}: a [mask] id is left in the output")
    if sched.allocator.free_pages != sched.allocator.num_pages - 1 or sched.stats.pages_in_use:
        raise AssertionError("the pool did not get every page back after the drain")
    for name in ("paged_flash_attention", "scatter_rows_paged", "variation", "importance"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the serving path")
    again: list = []
    profile = profile_run(lambda: again.extend(serve_trace(make(), prompts, max_new, every=5)))
    for a, b in zip(reqs, again):
        if not np.array_equal(a.output, b.output):
            raise AssertionError("a repeated greedy serving run gave other tokens")
    st = sched.stats
    tokens = sum(max_new)
    return dict(arch=cfg.name, dtype="bfloat16", slots=SLOTS, prompt_len=PROMPT,
                page_size=16, gen_length=GEN, block_length=BLOCK, requests=len(reqs),
                prompt_lens=list(lens), max_new_tokens=list(max_new), submit_every=5,
                steps=st.steps, wall_s=wall, serve_wall_s=st.wall_s,
                tokens_per_s=tokens / wall, ms_per_step=wall / st.steps * 1e3,
                latency_p50_s=st.latency_pct(50), latency_p95_s=st.latency_pct(95),
                pages_total=st.pages_total, peak_pages_in_use=st.peak_pages_in_use,
                resident_peak=st.resident_peak, early_advances=st.early_advances,
                cache_hit_fraction=st.cache_hit_fraction, peak_mem_gb=peak_mem,
                passes=dict(sched.engine.pass_counts), launches=launches, profile=profile,
                kernels_per_step=profile["kernels_launched"] / st.steps)


# ---------------------------------------------------------------------------
# phase 9: block-causal ES-dLLM with the sliding window, LLaDA-8B at full width
# ---------------------------------------------------------------------------
BC_GEN = 128            # 4 blocks of 32: the window (one block ahead) cuts
# (submit step, prompt, max_new_tokens): A's and B's later requests arrive in
# later admission cycles and map the store's prompt pages
BC_PLAN = ((0, "A", 128), (0, "B", 64), (5, "C", 128), (10, "D", 64), (15, "A", 64),
           (20, "B", 128), (25, "C", 64), (30, "A", 128))
BC_PROMPTS = dict(A=128, B=96, C=64, D=32)


def bc_gen_config(cfg, **kw):
    from repro_torch import configs

    return configs.GenerationConfig(
        mode="es", gen_length=BC_GEN, block_length=BLOCK,
        skip_stages=configs.default_skip_stages(cfg.n_layers), block_causal=True,
        window_blocks=1, **kw)


def bc_trace(sched, prompts: dict):
    """Submits ``BC_PLAN``'s requests at their steps and drains; returns the
    requests in plan order."""
    from repro_torch.runtime import Request

    reqs = [Request(prompt=prompts[name].copy(), max_new_tokens=m) for _, name, m in BC_PLAN]
    step = 0
    while step <= BC_PLAN[-1][0] or sched.has_work():
        for (at, _, _), r in zip(BC_PLAN, reqs):
            if at == step:
                sched.submit(r)
        sched.step()
        step += 1
    return reqs


def check_bc_options(options: dict, where: str, bc_start: int) -> None:
    """Every attention launch of a block-causal path got its block-causal
    options, blocks of ``BLOCK`` from ``bc_start``."""
    bad = {k: n for k, n in options.items() if k[3:] != (bc_start, BLOCK)}
    if not options or bad:
        raise AssertionError(f"{where}: attention launches without bc_start={bc_start}, "
                             f"bc_block={BLOCK}: {bad or 'none launched'}")


def bc_window_paths(model, kernel_fns) -> dict:
    """Offline es generation with block-causal attention and a one-block
    window (batch 2, prompt 128, gen 128), then ``BC_PLAN`` through the
    paged scheduler with early advance, the adaptive cache, block-causal
    attention, the window and the persistent prefix store.  Every attention
    launch must take the tensor-core body and the block-causal options; the
    served trace must hit the store and skip final positions in refreshes."""
    import numpy as np

    from repro_torch.core import make_engine
    from repro_torch.runtime import StreamScheduler

    cfg = model.cfg
    out: dict = {}
    gen_cfg = bc_gen_config(cfg, prompt_refresh_period=32, block_refresh_period=4)
    prompt = torch.randint(3, cfg.vocab_size, (2, PROMPT), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(SEED + 1))
    engine = make_engine(model, gen_cfg, device="cuda")
    engine.generate(prompt)                                 # warm-up
    torch.cuda.synchronize()
    zero_counts(kernel_fns)
    t0 = time.perf_counter()
    tokens = engine.generate(prompt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(kernel_fns)
    check_bc_options(kernel_fns["flash_attention"].option_launches, "phase 9 offline", PROMPT)
    gen_tok = tokens[:, PROMPT:]
    if tokens.shape != (2, PROMPT + BC_GEN) or (gen_tok == engine.mask_id).any().item():
        raise AssertionError(f"phase 9 offline: output {tuple(tokens.shape)} with [mask] ids")
    for name in ("flash_attention", "scatter_rows", "importance"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 9 offline: kernel {name} was not launched")
    profile = profile_run(lambda: engine.generate(prompt))
    out["offline"] = dict(batch=2, prompt_len=PROMPT, gen_length=BC_GEN, block_length=BLOCK,
                          window_blocks=1, iterations=engine.iterations, wall_s=wall,
                          tokens_per_s=2 * BC_GEN / wall, launches=launches,
                          distinct_ids=len(torch.unique(gen_tok)), profile=profile)

    gen_cfg = bc_gen_config(cfg, prompt_refresh_period=8, block_refresh_period=4,
                            cache_prompt_interval=2)
    rng = np.random.default_rng(SEED)
    prompts = {k: rng.integers(3, cfg.vocab_size, n).astype(np.int32)
               for k, n in BC_PROMPTS.items()}

    def make():
        return StreamScheduler(model, gen_cfg, device="cuda", max_slots=SLOTS,
                               prompt_len=PROMPT, paged=True, page_size=16,
                               prefix_sharing=True, early_advance=True)
    bc_trace(make(), prompts)                               # warm-up
    torch.cuda.synchronize()
    sched = make()
    zero_counts(kernel_fns)
    t0 = time.perf_counter()
    reqs = bc_trace(sched, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(kernel_fns)
    options = dict(kernel_fns["paged_flash_attention"].option_launches)
    check_bc_options(options, "phase 9 served", PROMPT)
    for r, (_, _, m) in zip(reqs, BC_PLAN):
        if r.error is not None or r.output is None or r.output.shape != (m,):
            raise AssertionError(f"phase 9 served: request {r.request_id}: {r.error!r}")
        if (r.output == sched.engine.mask_id).any():
            raise AssertionError(f"phase 9 served: a [mask] id in request {r.request_id}")
    st = sched.stats
    if not (st.prefix_hits > 0 and st.invariant_tokens_skipped > 0):
        raise AssertionError(f"phase 9 served: prefix_hits {st.prefix_hits}, "
                             f"invariant_tokens_skipped {st.invariant_tokens_skipped}")
    for name in ("paged_flash_attention", "scatter_rows_paged", "importance", "variation"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 9 served: kernel {name} was not launched")
    if sched.allocator.used_pages != sched.allocator.reclaimable_pages:
        raise AssertionError("phase 9 served: pages other than the store's left after the drain")
    again: list = []
    profile = profile_run(lambda: again.extend(bc_trace(make(), prompts)))
    if not all(np.array_equal(a.output, b.output) for a, b in zip(reqs, again)):
        raise AssertionError("phase 9 served: a repeated greedy run gave other tokens")
    tokens_out = sum(m for _, _, m in BC_PLAN)
    out["served"] = dict(
        slots=SLOTS, prompt_len=PROMPT, page_size=16, gen_length=BC_GEN, block_length=BLOCK,
        window_blocks=1, plan=[list(p) for p in BC_PLAN], prompt_lens=BC_PROMPTS,
        steps=st.steps, wall_s=wall, tokens_per_s=tokens_out / wall,
        ms_per_step=wall / st.steps * 1e3, latency_p50_s=st.latency_pct(50),
        latency_p95_s=st.latency_pct(95), prefix_hits=st.prefix_hits,
        prefix_evictions=st.prefix_evictions,
        invariant_tokens_skipped=st.invariant_tokens_skipped,
        peak_pages_in_use=st.peak_pages_in_use, pages_total=st.pages_total,
        cache_hit_fraction=st.cache_hit_fraction, passes=dict(sched.engine.pass_counts),
        launches=launches, attention_options={str(k): n for k, n in options.items()},
        profile=profile, kernels_per_step=profile["kernels_launched"] / st.steps)
    return out


# ---------------------------------------------------------------------------
# phase 10: Sparse-dLLM eviction and lazy page reservation, LLaDA-8B
# ---------------------------------------------------------------------------
SPARSE = dict(sparse_attention=True, sparse_retention=0.5, sparse_kernel_size=3)
# the served trace: prompts of 32-128 tokens, one every 5 steps.  The
# requests with max_blocks 4 ask for 64 new tokens (their first window) and
# may grow their extent to 128; the others ask for 128, two blocks past the
# first window, which admission defers
LAZY_LENS = (32, 64, 96, 128, 32, 64, 96, 128)
LAZY_MAX_BLOCKS = (4, None, 4, None, 4, None, 4, None)
LAZY_MAX_NEW = (64, 128, 64, 128, 64, 128, 64, 128)
LAZY_GEN = 128
# the steps of 10b's repeat that run under the profiler: a steady stretch
# with every slot resident, past the warm-up of the first arrivals
LAZY_PROFILE = (100, 200)
# pool: 40 pages hold the first four requests' prompts and first windows
# (6 + 8 + 10 + 12), not their full extents (10 + 12 + 14 + 16 = 52)
LAZY_KV_PAGES = 41


def offline_cfgs(cfg) -> dict:
    """Phase 5's es config, the same with Sparse-dLLM eviction (Table 13's
    es+sparse), and sparse eviction alone behind one zero-ratio probe stage
    at layer n_groups // 4 (Table 13's sparse-only)."""
    from repro_torch import configs

    base = dict(mode="es", gen_length=64, block_length=32, prompt_refresh_period=32,
                block_refresh_period=4)
    stages = configs.default_skip_stages(cfg.n_layers)
    return {"es": configs.GenerationConfig(skip_stages=stages, **base),
            "es+sparse": configs.GenerationConfig(skip_stages=stages, **base, **SPARSE),
            "sparse_only": configs.GenerationConfig(
                skip_stages=(configs.SkipStage(cfg.n_layers // 4, 0.0),), **base, **SPARSE)}


def record_retained(engine) -> list:
    """Wraps ``engine``'s full refresh: after each, the share of the
    attendable out-of-block rows that the eviction retained (one host read
    per refresh: only for an untimed run)."""
    shares, prefill = [], engine._prefill_step

    def wrapped(st, bs, iters, prompt_start, *args, **kwargs):
        out = prefill(st, bs, iters, prompt_start, *args, **kwargs)
        col = torch.arange(st.tokens.shape[1], device=bs.device)[None]
        past = (col >= prompt_start[:, None]) & ~engine._in_block(bs, st.tokens.shape[1])
        shares.append(round((out[4] & past).sum().item() / past.sum().item(), 4))
        return out
    engine._prefill_step = wrapped
    return shares


def sparse_offline(model, kernel_fns) -> dict:
    """10a: Table 13's es+sparse and sparse-only rows offline (batch 2,
    prompt 128, gen 64, block 32), each ``generate`` timed in turns with
    phase 5's es config on the same model.  Every attention launch must take
    the tensor-core body."""
    from repro_torch.core import make_engine

    cfg = model.cfg
    prompt = torch.randint(3, cfg.vocab_size, (2, PROMPT), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(SEED + 1))
    engines = {name: make_engine(model, g, device="cuda")
               for name, g in offline_cfgs(cfg).items()}
    runs = {name: dict(wall_s=[]) for name in engines}
    tokens = {}
    for name, eng in engines.items():                    # warm-up, retained shares
        shares = record_retained(eng) if name != "es" else None
        tokens[name] = eng.generate(prompt)
        if shares is not None:
            runs[name]["retained_share_per_refresh"] = shares
            del eng._prefill_step
    torch.cuda.synchronize()
    for name in ("es", "es+sparse", "sparse_only", "sparse_only", "es+sparse", "es"):
        zero_counts(kernel_fns)
        t0 = time.perf_counter()
        again = engines[name].generate(prompt)
        torch.cuda.synchronize()
        runs[name]["wall_s"].append(time.perf_counter() - t0)
        runs[name]["launches"] = counts(kernel_fns)
        if not torch.equal(again, tokens[name]):
            raise AssertionError(f"phase 10 {name}: a repeated greedy generate gave other tokens")
    for name, r in runs.items():
        check_tensor_core_path(r["launches"], f"phase 10 {name}")
        gen_tok = tokens[name][:, PROMPT:]
        if (gen_tok == engines[name].mask_id).any().item():
            raise AssertionError(f"phase 10 {name}: a [mask] id is left in the output")
        for kname in ("flash_attention", "scatter_rows", "importance"):
            if r["launches"][kname] <= 0:
                raise AssertionError(f"phase 10 {name}: kernel {kname} was not launched")
        r.update(iterations=engines[name].iterations,
                 equal_to_es=(gen_tok == tokens["es"][:, PROMPT:]).float().mean().item(),
                 distinct_ids=len(torch.unique(gen_tok)))
        if name == "es+sparse":         # one sparse row's device profile (phase 5 has es's)
            r["profile"] = profile_run(lambda: engines[name].generate(prompt))
    return dict(batch=2, prompt_len=PROMPT, gen_length=64, block_length=BLOCK,
                sparse_only_stage=cfg.n_layers // 4, runs=runs)


def lazy_served(model, kernel_fns) -> dict:
    """10b: the paged scheduler with early advance, phase 6's cadence and
    adaptive cache, the one-block window, lazy reservation and sparse
    retention 0.5 over ``LAZY_LENS`` (one request every 5 steps) on a pool
    of ``LAZY_KV_PAGES``.  Every attention launch must take the tensor-core
    body; every request must complete; admission must defer pages, and
    the trace must grow an extent, stall a row and reclaim a page."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.runtime import StreamScheduler

    cfg = model.cfg
    gen_cfg = configs.GenerationConfig(
        mode="es", gen_length=LAZY_GEN, block_length=BLOCK,
        skip_stages=configs.default_skip_stages(cfg.n_layers), prompt_refresh_period=8,
        block_refresh_period=4, cache_prompt_interval=2, window_blocks=1, **SPARSE)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32) for n in LAZY_LENS]

    def make():
        return StreamScheduler(model, gen_cfg, device="cuda", max_slots=SLOTS,
                               prompt_len=PROMPT, paged=True, page_size=16,
                               kv_pages=LAZY_KV_PAGES, early_advance=True, lazy_reserve=True)

    def trace(sched, n=len(prompts), window=None):
        """The trace; with a ``Profiled`` window, steps ``[LAZY_PROFILE[0],
        LAZY_PROFILE[1])`` run under it."""
        from repro_torch.runtime import Request

        reqs = [Request(prompt=p.copy(), max_new_tokens=m, max_blocks=mb)
                for p, m, mb in zip(prompts[:n], LAZY_MAX_NEW, LAZY_MAX_BLOCKS)]
        step = 0
        while step <= 5 * (n - 1) or sched.has_work():
            if window is not None and step == LAZY_PROFILE[0]:
                window.__enter__()
            if step % 5 == 0 and step // 5 < n:
                sched.submit(reqs[step // 5])
            sched.step()
            step += 1
            if window is not None and step == LAZY_PROFILE[1]:
                window.__exit__(None, None, None)
        return reqs
    trace(make(), 1)                                        # warm-up
    torch.cuda.synchronize()
    sched = make()
    zero_counts(kernel_fns)
    t0 = time.perf_counter()
    reqs = trace(sched)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(kernel_fns)
    check_tensor_core_path(launches, "phase 10 served")
    for r in reqs:
        if r.error is not None or r.output is None:
            raise AssertionError(f"phase 10 served: request {r.request_id}: {r.error!r}")
        if (r.output == sched.engine.mask_id).any():
            raise AssertionError(f"phase 10 served: a [mask] id in request {r.request_id}")
    st = sched.stats
    # each granted extent block adds its pages to the gauge; the rest were
    # deferred at admission
    admission_deferred = st.pages_deferred - st.blocks_grown * (BLOCK // 16)
    if st.completed != len(reqs):
        raise AssertionError(f"phase 10 served: {st.completed} of {len(reqs)} completed")
    # each of the page manager's mechanisms runs at full width: a deficit
    # at admission, extent growth, a stall that resumes, a reclaimed page
    if not (admission_deferred > 0 and st.blocks_grown > 0 and st.window_stalls > 0
            and st.pages_reclaimed > 0):
        raise AssertionError(f"phase 10 served: pages_deferred {st.pages_deferred} "
                             f"(at admission {admission_deferred}), blocks_grown "
                             f"{st.blocks_grown}, window_stalls {st.window_stalls}, "
                             f"pages_reclaimed {st.pages_reclaimed}")
    for kname in ("paged_flash_attention", "scatter_rows_paged", "importance", "variation"):
        if launches[kname] <= 0:
            raise AssertionError(f"phase 10 served: kernel {kname} was not launched")
    if sched.allocator.free_pages != sched.allocator.num_pages - 1:
        raise AssertionError("phase 10 served: the pool did not get every page back")
    # the repeat runs whole (its tokens must equal the first run's) with
    # one window of its steps profiled: profiling all 352 steps took 62-66 s
    window = Profiled()
    again = trace(make(), window=window)
    profile = window.result
    if not all(np.array_equal(a.output, b.output) for a, b in zip(reqs, again)):
        raise AssertionError("phase 10 served: a repeated greedy run gave other tokens")
    # the pages each request would map up front without lazy reservation,
    # at its full extent (max_blocks where set, else its new tokens)
    full = [-(-(PROMPT + BLOCK * (mb or m // BLOCK)) // 16) - (PROMPT - n) // 16
            for n, m, mb in zip(LAZY_LENS, LAZY_MAX_NEW, LAZY_MAX_BLOCKS)]
    fit = sum(sum(full[:k + 1]) <= LAZY_KV_PAGES - 1 for k in range(len(full)))
    return dict(
        slots=SLOTS, prompt_len=PROMPT, page_size=16, gen_length=LAZY_GEN,
        block_length=BLOCK, window_blocks=1, prompt_lens=list(LAZY_LENS),
        max_blocks=list(LAZY_MAX_BLOCKS), max_new_tokens=list(LAZY_MAX_NEW), submit_every=5,
        pool_pages=LAZY_KV_PAGES - 1,
        full_reservation_pages=full, full_reservation_residents=min(fit, SLOTS),
        steps=st.steps, wall_s=wall, ms_per_step=wall / st.steps * 1e3,
        tokens_per_s=sum(len(r.output) for r in reqs) / wall,
        output_tokens=[len(r.output) for r in reqs],
        latency_p50_s=st.latency_pct(50), latency_p95_s=st.latency_pct(95),
        pages_deferred=st.pages_deferred, admission_deferred=admission_deferred,
        blocks_grown=st.blocks_grown, window_stalls=st.window_stalls,
        pages_reclaimed=st.pages_reclaimed,
        peak_pages_in_use=st.peak_pages_in_use, resident_peak=st.resident_peak,
        cache_hit_fraction=st.cache_hit_fraction, passes=dict(sched.engine.pass_counts),
        launches=launches, profile=profile, profiled_steps=list(LAZY_PROFILE),
        kernels_per_step=profile["kernels_launched"] / (LAZY_PROFILE[1] - LAZY_PROFILE[0]))


# ---------------------------------------------------------------------------
# phase 11: the int8 KV cache and gather_refresh, LLaDA-8B at full width
# ---------------------------------------------------------------------------
def port_kernel_ms(profile: dict, *prefixes: str) -> float:
    """Device ms of the port's kernels whose symbol starts with a prefix."""
    return sum(r["ms"] for n, r in profile["port_kernels"].items() if n.startswith(prefixes))


def check_int8_path(launches: dict, where: str, paged: bool) -> None:
    """Every attention launch of an int8 path read int8 codes on the
    tensor-core body, and every K/V write was the quantizing scatter."""
    att = "paged_flash_attention" if paged else "flash_attention"
    quant = "quantize_scatter_rows_paged" if paged else "quantize_scatter_rows"
    plain = "scatter_rows_paged" if paged else "scatter_rows"
    n = launches[att]
    if not (n > 0 and launches[f"{att} tensor_core"] == n and launches[f"{att} int8"] == n):
        raise AssertionError(f"{where}: {n} {att} launches, {launches[att + ' tensor_core']} on "
                             f"the tensor-core body, {launches[att + ' int8']} on int8 codes")
    if launches[quant] <= 0 or launches[plain] != 0:
        raise AssertionError(f"{where}: {launches[quant]} quantizing and {launches[plain]} "
                             "plain K/V scatters")


def int8_offline(model, kernel_fns) -> dict:
    """11a: phase 5's offline es (batch 2, prompt 128, gen 64 in blocks of
    32) with the int8 cache, each ``generate`` timed in turns with the bf16
    cache (bf16, int8, int8, bf16), then one profiled ``generate`` of each.
    The share of generated tokens equal to bf16's is reported, not gated:
    the weights are random."""
    from repro_torch import configs
    from repro_torch.core import make_engine

    cfg = model.cfg
    gen_cfg = configs.GenerationConfig(
        mode="es", gen_length=64, block_length=32,
        skip_stages=configs.default_skip_stages(cfg.n_layers),
        prompt_refresh_period=32, block_refresh_period=4)
    prompt = torch.randint(3, cfg.vocab_size, (2, PROMPT), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(SEED + 1))
    engines = {"bf16": make_engine(model, gen_cfg, device="cuda"),
               "int8": make_engine(model, gen_cfg, device="cuda", kv_cache_dtype="int8")}
    tokens = {name: eng.generate(prompt) for name, eng in engines.items()}     # warm-up
    torch.cuda.synchronize()
    runs = {name: dict(wall_s=[]) for name in engines}
    for name in ("bf16", "int8", "int8", "bf16"):
        zero_counts(kernel_fns)
        t0 = time.perf_counter()
        again = engines[name].generate(prompt)
        torch.cuda.synchronize()
        runs[name]["wall_s"].append(time.perf_counter() - t0)
        runs[name]["launches"] = counts(kernel_fns)
        if not torch.equal(again, tokens[name]):
            raise AssertionError(f"phase 11a {name}: a repeated greedy generate gave other tokens")
    check_int8_path(runs["int8"]["launches"], "phase 11a", paged=False)
    check_tensor_core_path(runs["bf16"]["launches"], "phase 11a bf16")
    for name, eng in engines.items():
        gen_tok = tokens[name][:, PROMPT:]
        if (gen_tok == eng.mask_id).any().item():
            raise AssertionError(f"phase 11a {name}: a [mask] id is left in the output")
        prof = profile_run(lambda: eng.generate(prompt))
        r = runs[name]
        r.update(ms_per_generate=sum(r["wall_s"]) / len(r["wall_s"]) * 1e3,
                 iterations=eng.iterations, attention_ms=port_kernel_ms(
                     prof, "flash_tc_kernel", "flash_attention_kernel"),
                 scatter_ms=port_kernel_ms(prof, "quant_scatter_kernel", "scatter_rows_kernel"),
                 device_busy_ms=prof["device_busy_ms"],
                 device_busy_share=prof["device_busy_share"],
                 kv_bytes=sum(nbytes(t) for t in eng.last_state.cache),
                 distinct_ids=len(torch.unique(gen_tok)), profile=prof)
    n_layers, hkv, d = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    return dict(batch=2, prompt_len=PROMPT, gen_length=64, block_length=BLOCK, runs=runs,
                equal_to_bf16=(tokens["int8"][:, PROMPT:] == tokens["bf16"][:, PROMPT:])
                .float().mean().item(),
                kv_bytes_per_token_layer={"bf16": 2 * hkv * d * 2, "int8": 2 * hkv * (d + 4)},
                kv_bytes_ratio=runs["int8"]["kv_bytes"] / runs["bf16"]["kv_bytes"],
                int8_over_bf16_ms=runs["int8"]["ms_per_generate"] / runs["bf16"]["ms_per_generate"],
                layers=n_layers)


def int8_gather_served(model, kernel_fns, serving: dict) -> dict:
    """11b: phase 6's trace and scheduler (4 slots, pages of 16, early
    advance, the adaptive cache) with the int8 cache and ``gather_refresh``:
    a prompt refresh of at most 2 of the 4 slots runs compacted.  Compared
    with phase 6 of the same run (``serving``).  Every attention launch must
    read int8 codes on the tensor-core body, and the compact branch must
    run."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.runtime import StreamScheduler

    cfg = model.cfg
    gen_cfg = configs.GenerationConfig(
        mode="es", gen_length=GEN, block_length=BLOCK,
        skip_stages=configs.default_skip_stages(cfg.n_layers),
        prompt_refresh_period=8, block_refresh_period=4, cache_prompt_interval=2)
    rng = np.random.default_rng(SEED)
    lens = (32, 64, 96, 128, 32, 64, 96, 128)
    max_new = (64, 32, 64, 32, 32, 64, 32, 64)
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32) for n in lens]

    def make():
        return StreamScheduler(model, gen_cfg, device="cuda", max_slots=SLOTS,
                               prompt_len=PROMPT, paged=True, page_size=16,
                               early_advance=True, kv_cache_dtype="int8", gather_refresh=True)
    serve_trace(make(), prompts[:1], max_new[:1], every=5)     # warm-up
    torch.cuda.synchronize()
    sched = make()
    zero_counts(kernel_fns)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reqs = serve_trace(sched, prompts, max_new, every=5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(kernel_fns)
    check_drained(sched, reqs)
    check_int8_path(launches, "phase 11b", paged=True)
    n_compact = sched.engine.compact_prefill
    if n_compact <= 0:
        raise AssertionError("phase 11b: no prompt refresh ran compacted")
    pool_bytes = sum(nbytes(t) for t in sched.state.cache)
    again: list = []
    profile = profile_run(lambda: again.extend(serve_trace(make(), prompts, max_new, every=5)))
    if not all(np.array_equal(a.output, b.output) for a, b in zip(reqs, again)):
        raise AssertionError("phase 11b: a repeated greedy serving run gave other tokens")
    st = sched.stats
    n_pages = st.pages_total + 1
    bf16_pool = 2 * cfg.n_layers * n_pages * 16 * cfg.n_kv_heads * cfg.head_dim * 2
    return dict(
        steps=st.steps, wall_s=wall, ms_per_step=wall / st.steps * 1e3,
        tokens_per_s=sum(max_new) / wall, latency_p50_s=st.latency_pct(50),
        peak_pages_in_use=st.peak_pages_in_use, pages_total=st.pages_total,
        pool_bytes=pool_bytes, pool_bytes_bf16=bf16_pool,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        compact_prefill=n_compact, passes=dict(sched.engine.pass_counts),
        cache_hit_fraction=st.cache_hit_fraction, launches=launches,
        device_busy_share=profile["device_busy_share"],
        attention_ms=port_kernel_ms(profile, "flash_tc_kernel"),
        scatter_ms=port_kernel_ms(profile, "quant_scatter_kernel"),
        kernels_per_step=profile["kernels_launched"] / st.steps, profile=profile,
        phase6=dict(steps=serving["steps"], ms_per_step=serving["ms_per_step"],
                    device_busy_share=serving["profile"]["device_busy_share"],
                    peak_pages_in_use=serving["peak_pages_in_use"],
                    peak_mem_gb=serving["peak_mem_gb"]))


def int8_shared_served(model, kernel_fns) -> dict:
    """11c: prefix sharing under the int8 cache at full width, so the fork
    copies the scale pools too: two duplicate-prompt cohorts (2 requests
    each, prompt 128), sampled at temperature 0.2 and top-p 0.95 as phase 7
    samples, admitted in one cycle on 4 slots."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.runtime import Request, StreamScheduler

    cfg = model.cfg
    gen_cfg = configs.GenerationConfig(
        mode="es", gen_length=GEN, block_length=BLOCK,
        skip_stages=configs.default_skip_stages(cfg.n_layers),
        prompt_refresh_period=8, block_refresh_period=4, temperature=0.2, top_p=0.95)
    rng = np.random.default_rng(SEED + 3)
    a, b = (rng.integers(3, cfg.vocab_size, PROMPT).astype(np.int32) for _ in "ab")
    sched = StreamScheduler(model, gen_cfg, device="cuda", max_slots=SLOTS, prompt_len=PROMPT,
                            paged=True, page_size=16, prefix_sharing=True,
                            kv_cache_dtype="int8")
    reqs = [Request(prompt=p.copy(), sample_seed=2000 + i) for i, p in enumerate((a, a, b, b))]
    zero_counts(kernel_fns)
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    sched.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(kernel_fns)
    check_drained(sched, reqs, GEN)
    check_int8_path(launches, "phase 11c", paged=True)
    st = sched.stats
    if st.cow_forks <= 0 or launches["fork_pages scales"] < 1:
        raise AssertionError(f"phase 11c: {st.cow_forks} forks, "
                             f"{launches['fork_pages scales']} of the scale pools")
    return dict(requests=len(reqs), steps=st.steps, wall_s=wall, cow_forks=st.cow_forks,
                launches=launches,
                distinct_outputs=len({r.output.tobytes() for r in reqs}))


# ---------------------------------------------------------------------------
# phase 12: the lock-step BatchServer and the sharded scheduler, LLaDA-8B
# ---------------------------------------------------------------------------
# 12a: the paper's batch 8 (prompt 128, gen 64 in blocks of 32), 16 requests
# of prompts of 32-128 tokens, so two batches
BATCH_SERVER = dict(batch_size=8, requests=16, prompt_len=128)


def batch_server(model, kernel_fns) -> dict:
    """12a: ``BatchServer`` at batch 8 with phase 5's gen config; the first
    batch's tokens must equal one ``engine.generate`` of the same stacked
    prompts with the server's key."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.runtime import BatchServer, Request, pad_and_stack

    cfg = model.cfg
    bsz, n_req, pl = (BATCH_SERVER[k] for k in ("batch_size", "requests", "prompt_len"))
    gen_cfg = configs.GenerationConfig(
        mode="es", gen_length=64, block_length=32,
        skip_stages=configs.default_skip_stages(cfg.n_layers),
        prompt_refresh_period=32, block_refresh_period=4)
    rng = np.random.default_rng(SEED + 12)
    lens = [(32, 64, 96, 128)[i % 4] for i in range(n_req)]
    reqs = [Request(prompt=rng.integers(3, cfg.vocab_size, n).astype(np.int32)) for n in lens]
    server = BatchServer(model, gen_cfg, batch_size=bsz, prompt_len=pl, seed=SEED,
                         device="cuda")
    for r in reqs:
        server.submit(r)
    torch.cuda.synchronize()
    zero_counts(kernel_fns)
    t0 = time.perf_counter()
    done = server.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(kernel_fns)
    if [r.request_id for r in done] != [r.request_id for r in reqs]:
        raise AssertionError("12a: the server did not return every request in order")
    for name in ("flash_attention", "scatter_rows", "importance"):
        if launches[name] <= 0:
            raise AssertionError(f"12a: kernel {name} was not launched")
    check_tensor_core_path(launches, "phase 12a")
    first = torch.from_numpy(pad_and_stack(reqs[:bsz], 0, pl))
    want = server.engine.generate(first, key=prng.split(prng.prng_key(SEED))[1]).cpu().numpy()
    for i, r in enumerate(reqs[:bsz]):
        if not np.array_equal(r.output, want[i, pl:]):
            raise AssertionError(f"12a: request {i} of the first batch differs from "
                                 "engine.generate of the same prompts and key")
        if r.output.shape != (gen_cfg.gen_length,) or (r.output == server.engine.mask_id).any():
            raise AssertionError(f"12a: request {i} output {r.output}")
    st = server.stats
    return dict(batch_size=bsz, requests=n_req, prompt_len=pl, prompt_lens=lens,
                gen_length=gen_cfg.gen_length, block_length=gen_cfg.block_length,
                tps=st.tps, wall_s=st.wall_s, drain_wall_s=wall,
                batch_wall_s=list(server.batch_wall_s), stats_requests=st.requests,
                tokens_generated=st.tokens_generated, first_batch_equal=True,
                launches=launches)


def sharded_trace(sched, prompts, max_new, every: int):
    """Phase 6's submission plan through a sharded scheduler, with page
    conservation checked after every step; returns the requests, the steps,
    and each request's lane step count at its submission."""
    from repro_torch.runtime import Request

    reqs = [Request(prompt=p.copy(), max_new_tokens=m) for p, m in zip(prompts, max_new)]
    at: dict = {}
    step = 0
    while step <= every * (len(reqs) - 1) or sched.has_work():
        if step % every == 0 and step // every < len(reqs):
            r = reqs[step // every]
            sched.submit(r)
            at[r.request_id] = sched.lanes[sched.placements[r.request_id]].stats.steps
        sched.step()
        sched.allocator.check_conservation()
        step += 1
    return reqs, step, at


def lane_replay(model, gen_cfg, lane, seed: int, reqs, at) -> list:
    """A single-shard ``StreamScheduler`` with the lane's ``seed``, width and
    pool fed the lane's requests at the lane's own step counts."""
    from repro_torch.runtime import Request, StreamScheduler

    replay = StreamScheduler(model, gen_cfg, device="cuda", max_slots=len(lane.slot_req),
                             prompt_len=lane.prompt_len, paged=True, page_size=16,
                             kv_pages=lane.allocator.num_pages, early_advance=True,
                             seed=seed)
    pending = [(at[r.request_id], Request(prompt=r.prompt.copy(), request_id=r.request_id,
                                          max_new_tokens=r.max_new_tokens)) for r in reqs]
    copies = [c for _, c in pending]
    while pending or replay.has_work():
        while pending and (pending[0][0] <= replay.stats.steps or not replay.has_work()):
            replay.submit(pending.pop(0)[1])
        replay.step()
    return copies


def sharded_served(model, kernel_fns) -> dict:
    """12b: phase 6's model, gen config and trace through
    ``ShardedStreamScheduler`` with 2 lanes on the one card: (i) least loaded
    on phase 6's 4 slots and its pool split evenly, (ii) disaggregated, one
    refresh lane at prompt 128 and one decode lane at 64.  Each decode-lane
    request of (ii) must equal its single-shard replay."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.runtime import ShardedStreamScheduler

    cfg = model.cfg
    gen_cfg = configs.GenerationConfig(
        mode="es", gen_length=GEN, block_length=BLOCK,
        skip_stages=configs.default_skip_stages(cfg.n_layers),
        prompt_refresh_period=8, block_refresh_period=4, cache_prompt_interval=2)
    rng = np.random.default_rng(SEED)
    lens = (32, 64, 96, 128, 32, 64, 96, 128)
    max_new = (64, 32, 64, 32, 32, 64, 32, 64)
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32) for n in lens]
    runs = {
        "i": dict(placement="least_loaded"),
        "ii": dict(placement="disagg", refresh_shards=1, decode_prompt_len=64),
    }
    out = {}
    for name, kw in runs.items():
        sched = ShardedStreamScheduler(model, gen_cfg, device="cuda", shards=2, seed=SEED,
                                       max_slots=SLOTS, prompt_len=PROMPT, paged=True,
                                       page_size=16, early_advance=True, **kw)
        if sched.devices is not None or len({id(l.engine) for l in sched.lanes}) != 1:
            raise AssertionError(f"12b {name}: the lanes do not share the card and engine")
        torch.cuda.synchronize()
        zero_counts(kernel_fns)
        t0 = time.perf_counter()
        reqs, steps, at = sharded_trace(sched, prompts, max_new, every=5)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts(kernel_fns)
        for r, n in zip(reqs, max_new):
            if r.error is not None or r.output is None or r.output.shape != (n,):
                raise AssertionError(f"12b {name}: request {r.request_id}: {r.error} {r.output}")
        if sched.allocator.used_pages:
            raise AssertionError(f"12b {name}: pages left after the drain")
        for k in ("paged_flash_attention", "scatter_rows_paged", "importance"):
            if launches[k] <= 0:
                raise AssertionError(f"12b {name}: kernel {k} was not launched")
        check_tensor_core_path(launches, f"phase 12b {name}")
        lanes = {}
        for s, lane in enumerate(sched.lanes):
            mine = [r for r in reqs if sched.placements[r.request_id] == s]
            lat = [r.latency_s for r in mine]
            lanes[s] = dict(prompt_len=lane.prompt_len, requests=len(mine), steps=lane.stats.steps,
                            latency_p50_s=float(np.percentile(lat, 50)) if lat else None,
                            latency_p95_s=float(np.percentile(lat, 95)) if lat else None)
        replay_equal = None
        if name == "ii":
            lane = sched.lanes[1]
            mine = [r for r in reqs if sched.placements[r.request_id] == 1]
            if {len(r.prompt) for r in mine} != {32, 64}:
                raise AssertionError("12b ii: the decode lane took prompts of "
                                     f"{sorted(len(r.prompt) for r in mine)} tokens")
            copies = lane_replay(model, gen_cfg, lane, SEED + 1, mine, at)
            for r, c in zip(mine, copies):
                if not np.array_equal(r.output, c.output):
                    raise AssertionError(f"12b ii: decode-lane request {r.request_id} differs "
                                         "from its single-shard replay")
            replay_equal = len(mine)
        st = sched.stats
        out[name] = dict(placement=kw["placement"], steps=steps, lane_steps=st.steps,
                         wall_s=wall, ms_per_step=wall / steps * 1e3,
                         placements={str(k): v for k, v in sched.placements.items()},
                         lanes=lanes, shard_gauges=sched.shard_gauges(),
                         pool_pages=[l.allocator.num_pages for l in sched.lanes],
                         decode_replay_equal=replay_equal, conservation_checked_steps=steps,
                         launches=launches)
    return out


# ---------------------------------------------------------------------------
# phase 7: sampled serving of Dream-7B at full width
# ---------------------------------------------------------------------------
# (submit step, prompt, priority): two duplicate-prompt cohorts (A, B) in
# the first cycle, then two priority classes arriving every 5 steps
DREAM_PLAN = ((0, "A", 0), (0, "A", 0), (0, "B", 0), (0, "B", 0), (5, "C", 1), (10, "D", 0),
              (15, "E", 1), (20, "F", 0))
DREAM_PROMPTS = dict(A=128, B=96, C=64, D=128, E=32, F=100)
# 7b's pool: the four first requests take 44 pages (12 + 12 + 10 + 10), so
# the class-1 arrival can only enter by spilling a class-0 resident
DREAM_PREEMPT_PAGES = 45


# phase 7's depth: Dream-7B's 28 layers cut to 14, and 13a's and 13b's
# (olmoe-1b-7b 16 to 8, gemma3-1b 26 to 13), so that the script's phases
# with phase 14 stay within 790 s; then Dream's to 7, to make room for phase
# 17's served trace of three requests; then, beside phase 18, Dream's to 4,
# olmoe's to 4 and gemma3's to 7 (6 local layers and the global layer 5)
# (PERF.md §4)
DEPTH_7 = 4
DEPTH_13A = 4
DEPTH_13B = 7


def dream_7b():
    """Dream-7B at full width in bf16, ``DEPTH_7`` layers deep, random
    weights from a seeded generator on the card."""
    from repro_torch import configs
    from repro_torch.models import Model

    cfg = dataclasses.replace(configs.get_config("dream-7b"), n_layers=DEPTH_7,
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


class SamplerTimer:
    """Wall time of every sampled-confidence call of the engine on the path,
    from CUDA events around each call (the card's time from the call's first
    kernel to its last, gaps the host leaves included)."""

    def __init__(self):
        from repro_torch.core import sampler
        self.sampler, self.orig, self.spans = sampler, sampler.confidence_and_pred, []

    def __enter__(self):
        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.orig(*args, **kw)
            end.record()
            self.spans.append((start, end))
            return out
        self.sampler.confidence_and_pred = timed
        return self

    def __exit__(self, *exc):
        self.sampler.confidence_and_pred = self.orig

    def total_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.spans)


def dream_gen_config(cfg):
    """The serving cadence of phase 6, sampled as Dream decodes (temperature
    0.2, top-p 0.95)."""
    from repro_torch import configs

    return configs.GenerationConfig(
        mode="es", gen_length=GEN, block_length=BLOCK,
        skip_stages=configs.default_skip_stages(cfg.n_layers),
        prompt_refresh_period=8, block_refresh_period=4, cache_prompt_interval=2,
        temperature=0.2, top_p=0.95)


def dream_trace(sched, prompts: dict, plan=DREAM_PLAN):
    """Submits the plan's requests at their steps and drains; returns the
    requests in plan order and the largest number of shared mappings seen."""
    from repro_torch.runtime import Request

    reqs = [Request(prompt=prompts[name].copy(), priority=prio, sample_seed=1000 + i)
            for i, (_, name, prio) in enumerate(plan)]
    last = max(at for at, _, _ in plan)
    step = peak_shared = 0
    while step <= last or sched.has_work():
        for (at, _, _), r in zip(plan, reqs):
            if at == step:
                sched.submit(r)
        sched.step()
        peak_shared = max(peak_shared, sched.stats.shared_mappings)
        step += 1
    return reqs, peak_shared


def dream_serving(model, kernel_fns) -> dict:
    """7a with prefix sharing, 7b with preemption on a tight pool, 7c with
    neither (run before 7a and after 7b), on one model and one request plan
    (the reference refuses preemption together with sharing), after a
    warm-up run of the plan.  Launches and the sampler's time are counted
    per run."""
    import numpy as np

    from repro_torch.runtime import StreamScheduler

    cfg = model.cfg
    gen_cfg = dream_gen_config(cfg)
    rng = np.random.default_rng(SEED)
    prompts = {k: rng.integers(3, cfg.vocab_size, n).astype(np.int32)
               for k, n in DREAM_PROMPTS.items()}
    # 7c runs first and last: the two bracket the other runs, so a cost of
    # the options shows apart from the order the runs go in
    runs = {"7c first": {}, "7a": dict(prefix_sharing=True),
            "7b": dict(preemption=True, kv_pages=DREAM_PREEMPT_PAGES), "7c": {}}

    def make(kw):
        return StreamScheduler(model, gen_cfg, device="cuda", max_slots=SLOTS, prompt_len=PROMPT,
                               paged=True, page_size=16, early_advance=True, **kw)
    # warm-up with the whole plan: allocator growth and first-use costs
    # would otherwise land on whichever run goes first
    dream_trace(make({}), prompts)
    out, outputs = {}, {}
    for name, kw in runs.items():
        sched = make(kw)
        zero_counts(kernel_fns)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        timer = SamplerTimer()
        t0 = time.perf_counter()
        with timer:
            reqs, peak_shared = dream_trace(sched, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_drained(sched, reqs, GEN)
        st = sched.stats
        outputs[name] = [r.output for r in reqs]
        out[name] = dict(
            options=kw, steps=st.steps, passes=dict(sched.engine.pass_counts), wall_s=wall,
            tokens_per_s=len(reqs) * GEN / wall, ms_per_step=wall / st.steps * 1e3,
            latency_p50_s=st.latency_pct(50), latency_p95_s=st.latency_pct(95),
            pages_total=st.pages_total, peak_pages_in_use=st.peak_pages_in_use,
            resident_peak=st.resident_peak, cow_forks=st.cow_forks,
            peak_shared_mappings=peak_shared, preemptions=st.preemptions,
            pages_spilled=st.pages_spilled, resumes=len(st.resume_waits),
            resume_p50_s=st.resume_p50,
            cache_hit_fraction=st.cache_hit_fraction,
            launches=counts(kernel_fns),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            sampler_calls=len(timer.spans), sampler_ms_per_step=timer.total_ms() / st.steps)
    if out["7a"]["cow_forks"] <= 0 or out["7a"]["launches"]["fork_pages"] < 1:
        raise AssertionError(f"7a: no copy-on-write fork on the path: {out['7a']}")
    if out["7b"]["preemptions"] < 1 or out["7b"]["resumes"] < 1:
        raise AssertionError(f"7b: no preemption and resume: {out['7b']}")
    for name in ("7c first", "7a", "7b"):
        same = [np.array_equal(x, y) for x, y in zip(outputs[name], outputs["7c"])]
        out[name]["share_equal_to_7c"] = sum(same) / len(same)
    if out["7c first"]["share_equal_to_7c"] != 1.0:
        raise AssertionError("two runs of 7c decoded different tokens")
    # one profiled run, 7a's ("7c first" already repeats 7c)
    again: list = []
    out["7a"]["profile"] = profile_run(
        lambda: again.extend(dream_trace(make(runs["7a"]), prompts)[0]))
    out["7a"]["repeat_equal"] = all(np.array_equal(a.output, b) for a, b in
                                    zip(again, outputs["7a"]))
    out["7a"]["kernels_per_step"] = out["7a"]["profile"]["kernels_launched"] / out["7a"]["steps"]
    return dict(arch=cfg.name, dtype=str(model.dtype), layers=cfg.n_layers, d_model=cfg.d_model,
                weights_gb=sum(nbytes(p) for p in model.parameters()) / 1e9, slots=SLOTS,
                prompt_len=PROMPT, page_size=16, gen_length=GEN,
                block_length=BLOCK, temperature=gen_cfg.temperature, top_p=gen_cfg.top_p,
                plan=[list(p) for p in DREAM_PLAN], prompt_lens=DREAM_PROMPTS, runs=out)


# ---------------------------------------------------------------------------
# phase 8: mamba2-370m at full width, offline and served
# ---------------------------------------------------------------------------
def mamba2_370m():
    """mamba2-370m at full width in bf16, ``MAMBA_LAYERS`` deep, random
    weights from a seeded generator on the card."""
    from repro_torch import configs
    from repro_torch.models import Model

    cfg = dataclasses.replace(configs.get_config("mamba2-370m"), n_layers=MAMBA_LAYERS,
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def mamba_offline(model, kernel_fns) -> dict:
    """Offline es and dualcache, batch 4, prompt 128, gen 64 in blocks of 32,
    greedy.  After a warm-up of each, four timed ``generate`` calls in turns
    (es, dualcache, dualcache, es: host time drifts within a call), each
    with its launches counted from 0; then one profiled call of each."""
    from repro_torch import configs
    from repro_torch.core import make_engine

    cfg = model.cfg
    batch, prompt_len = SLOTS, PROMPT
    prompt = torch.randint(3, cfg.vocab_size, (batch, prompt_len), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(SEED + 1))
    engines = {}
    for mode in ("es", "dualcache"):
        gen_cfg = configs.GenerationConfig(
            mode=mode, gen_length=GEN, block_length=BLOCK,
            skip_stages=configs.default_skip_stages(cfg.n_layers) if mode == "es" else (),
            prompt_refresh_period=32, block_refresh_period=4)
        engines[mode] = make_engine(model, gen_cfg, device="cuda")
        engines[mode].generate(prompt)                     # warm-up
    torch.cuda.synchronize()
    walls = {mode: [] for mode in engines}
    out, launches, passes = {}, {}, {}
    for mode in ("es", "dualcache", "dualcache", "es"):
        engine = engines[mode]
        engine.pass_counts = {k: 0 for k in engine.pass_counts}
        zero_counts(kernel_fns)
        t0 = time.perf_counter()
        tokens = engine.generate(prompt)
        torch.cuda.synchronize()
        walls[mode].append(time.perf_counter() - t0)
        launches[mode] = counts(kernel_fns)
        passes[mode] = dict(engine.pass_counts)
        if mode in out and not torch.equal(tokens, out[mode]):
            raise AssertionError(f"mamba2 {mode}: a repeated greedy generate gave other tokens")
        out[mode] = tokens
    result = {}
    for mode, engine in engines.items():
        gen_tok = out[mode][:, prompt_len:]
        if (out[mode].shape != (batch, prompt_len + GEN)
                or (gen_tok == engine.mask_id).any().item()
                or not ((gen_tok >= 0) & (gen_tok < cfg.vocab_size)).all().item()):
            raise AssertionError(f"mamba2 {mode}: output {tuple(out[mode].shape)}, a [mask] id "
                                 "or an id outside the vocabulary")
        for name in ("ssd_chunks", "importance") if mode == "es" else ("ssd_chunks",):
            if launches[mode][name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the mamba2 {mode} path")
        iters = engine.iterations
        profile = profile_run(lambda: engine.generate(prompt))
        mean = sum(walls[mode]) / len(walls[mode])
        result[mode] = dict(
            mode=mode, batch=batch, prompt_len=prompt_len, gen_length=GEN, block_length=BLOCK,
            segments=[dataclasses.asdict(s) for s in engine.segments], iterations=iters,
            passes=passes[mode], wall_s_runs=walls[mode], ms_per_generate=mean * 1e3,
            ms_per_iteration=mean / iters * 1e3, tokens_per_s=batch * GEN / mean,
            distinct_ids=len(torch.unique(gen_tok)), launches=launches[mode],
            launches_per_iteration=profile["kernels_launched"] / iters, profile=profile)
    result["es_over_dualcache_ms"] = (result["es"]["ms_per_generate"]
                                      / result["dualcache"]["ms_per_generate"])
    return result


def mamba_serving(model, kernel_fns) -> dict:
    """The dense-slot scheduler at full width: 4 slots, the phase-6 trace (8
    requests, prompts of 32-128 tokens, 32 or 64 new, one every 5 steps),
    early advance, prompt refresh every 8, block refresh every 4 (no
    adaptive cache: it is outside the SSM slice)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.runtime import StreamScheduler

    cfg = model.cfg
    gen_cfg = configs.GenerationConfig(
        mode="es", gen_length=GEN, block_length=BLOCK,
        skip_stages=configs.default_skip_stages(cfg.n_layers),
        prompt_refresh_period=8, block_refresh_period=4)
    rng = np.random.default_rng(SEED)
    lens = (32, 64, 96, 128, 32, 64, 96, 128)
    max_new = (64, 32, 64, 32, 32, 64, 32, 64)
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32) for n in lens]

    def make():
        return StreamScheduler(model, gen_cfg, device="cuda", max_slots=SLOTS,
                               prompt_len=PROMPT, early_advance=True)
    serve_trace(make(), prompts[:1], max_new[:1], every=5)     # warm-up
    torch.cuda.synchronize()
    sched = make()
    zero_counts(kernel_fns)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reqs = serve_trace(sched, prompts, max_new, every=5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(kernel_fns)
    for r, n in zip(reqs, max_new):
        if r.error is not None or r.output is None or r.output.shape != (n,):
            raise AssertionError(f"mamba2 request {r.request_id}: {r.error!r} {r.output}")
        if (r.output == sched.engine.mask_id).any():
            raise AssertionError(f"mamba2 request {r.request_id}: a [mask] id is left")
    for name in ("ssd_chunks", "importance"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the mamba2 serving path")
    again: list = []
    profile = profile_run(lambda: again.extend(serve_trace(make(), prompts, max_new, every=5)))
    for a, b in zip(reqs, again):
        if not np.array_equal(a.output, b.output):
            raise AssertionError("a repeated greedy mamba2 serving run gave other tokens")
    st = sched.stats
    return dict(slots=SLOTS, prompt_len=PROMPT, gen_length=GEN, block_length=BLOCK,
                requests=len(reqs), prompt_lens=list(lens), max_new_tokens=list(max_new),
                submit_every=5, steps=st.steps, wall_s=wall, serve_wall_s=st.wall_s,
                tokens_per_s=sum(max_new) / wall, ms_per_step=wall / st.steps * 1e3,
                latency_p50_s=st.latency_pct(50), latency_p95_s=st.latency_pct(95),
                resident_peak=st.resident_peak, early_advances=st.early_advances,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                passes=dict(sched.engine.pass_counts), launches=launches,
                launches_per_step=profile["kernels_launched"] / st.steps, profile=profile)


# ---------------------------------------------------------------------------
# phase 13: the MoE and remaining dense archs at full width
# ---------------------------------------------------------------------------
# 13c's depth, cut from the published one so that the script's phases stay
# within 760 s, then to 4 beside phase 18 (PERF.md §4)
DEPTH_13C = 4
ARCHS_13C = ("llama3-8b", "qwen2-1.5b", "chatglm3-6b", "granite-moe-1b-a400m")
# phase 6's arrivals and lengths of new tokens; 13a takes its prompts, 13b
# prompts of 544-640 against gemma3's 512 window
SERVE_MAX_NEW = (64, 32, 64, 32, 32, 64, 32, 64)
LENS_13A = (32, 64, 96, 128, 32, 64, 96, 128)
LENS_13B = (544, 576, 608, 640, 544, 576, 608, 640)
PROFILE_13A = (40, 70)          # the profiled window of 13a's served trace (steps)


def full_width(arch: str, n_layers=None):
    """``arch`` at full width in bf16 (depth ``n_layers`` if given), random
    weights from a seeded generator on the card; (model, init seconds)."""
    from repro_torch import configs
    from repro_torch.models import Model

    cfg = dataclasses.replace(configs.get_config(arch), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def arch_gen_config(cfg, served: bool):
    """Phase 5's offline cadence or phase 6's served one, with the arch's
    default skip stages; served without the adaptive cache on a stack with
    SSM or cross layers, where the reference refuses it."""
    from repro_torch import configs

    kw = (dict(prompt_refresh_period=8, block_refresh_period=4, cache_prompt_interval=2)
          if served else dict(prompt_refresh_period=32, block_refresh_period=4))
    if cfg.ssm is not None or cfg.cross_every:
        kw.pop("cache_prompt_interval", None)
    return configs.GenerationConfig(mode="es", gen_length=GEN, block_length=BLOCK,
                                    skip_stages=configs.default_skip_stages(cfg.n_layers), **kw)


def arch_offline(model, kernel_fns, prompt_len: int = PROMPT) -> dict:
    """One offline es ``generate`` at batch 2 after a warm-up call, phase 5's
    shape (gen 64, blocks of 32) at ``prompt_len``; every attention launch on
    the tensor-core body."""
    from repro_torch.core import make_engine

    cfg = model.cfg
    gen_cfg = arch_gen_config(cfg, served=False)
    prompt = torch.randint(3, cfg.vocab_size, (2, prompt_len), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(SEED + 1))
    engine = make_engine(model, gen_cfg, device="cuda")
    engine.generate(prompt)                       # warm-up
    torch.cuda.synchronize()
    zero_counts(kernel_fns)
    t0 = time.perf_counter()
    out = engine.generate(prompt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(kernel_fns)
    gen_tok = out[:, prompt_len:]
    if out.shape != (2, prompt_len + GEN) or (gen_tok == engine.mask_id).any().item():
        raise AssertionError(f"{cfg.name}: output {tuple(out.shape)} or a [mask] id left")
    if not ((gen_tok >= 0) & (gen_tok < cfg.vocab_size)).all().item():
        raise AssertionError(f"{cfg.name}: generated ids outside the vocabulary")
    for name in ("flash_attention", "scatter_rows", "importance"):
        if launches[name] <= 0:
            raise AssertionError(f"{cfg.name}: kernel {name} was not launched offline")
    check_tensor_core_path(launches, f"phase 13 {cfg.name} offline")
    return dict(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
                weights_gb=sum(nbytes(p) for p in model.parameters()) / 1e9,
                batch=2, prompt_len=prompt_len, gen_length=GEN, iterations=engine.iterations,
                wall_s=wall, tokens_per_s=2 * GEN / wall, distinct_ids=len(torch.unique(gen_tok)),
                launches=launches, option_launches={str(k): n for k, n in kernel_fns[
                    "flash_attention"].option_launches.items()})


def moe_drop_share(model) -> dict:
    """The share of (row, choice) picks dropped at capacity over one
    offline prefill and one skip decode of phase 13a's shape, read from the
    routing's picks of every MoE layer (the capacity factor is the
    published default)."""
    from repro_torch.core import make_engine
    from repro_torch.models import moe

    cfg = model.cfg
    engine = make_engine(model, arch_gen_config(cfg, served=False), device="cuda")
    prompt = torch.randint(3, cfg.vocab_size, (2, PROMPT), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(SEED + 1))
    tokens = torch.cat([prompt.int(), torch.full((2, GEN), engine.mask_id, device="cuda",
                                                 dtype=torch.int32)], dim=1)
    kept: list = []
    routing = moe.routing

    def recording(probs, m, cap):
        r = routing(probs, m, cap)
        kept.append(r.kept)
        return r
    moe.routing = recording
    try:
        st = engine.make_block_state(tokens)
        st = engine.prefill(st, PROMPT)
        n_prefill = len(kept)
        engine.decode_iteration(st, PROMPT)
    finally:
        moe.routing = routing

    def share(ks):
        total = sum(k.numel() for k in ks)
        return sum((~k).sum().item() for k in ks) / total, total
    (pre, n_pre), (dec, n_dec) = share(kept[:n_prefill]), share(kept[n_prefill:])
    return dict(prefill_dropped=pre, prefill_picks=n_pre, decode_dropped=dec,
                decode_picks=n_dec, capacity_factor=cfg.moe.capacity_factor,
                router_group_size=cfg.moe.router_group_size)


def moe_attribution(prof) -> dict:
    """Device ms of one profiled window (CPU and CUDA activity): every
    kernel, those inside ``moe_apply`` (the device-side spans of its
    ``chip_smoke.moe`` range), and of those the expert matmuls (kernels
    linked to an ``aten::bmm`` op); the rest of ``moe_apply`` is the
    router, the routing, the dispatch, the activation and the combine.
    Also the window's 12 kernels with the most device time."""
    import bisect

    cpu_t, cuda_t = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    evs = list(prof.profiler.kineto_results.events())
    ops = {e.correlation_id(): e.name() for e in evs
           if e.device_type() == cpu_t and e.correlation_id() > 0}
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in evs
                   if e.device_type() == cuda_t and e.name() == "chip_smoke.moe")
    starts = [a for a, _ in spans]
    kernels = [e for e in evs if e.device_type() == cuda_t and e.name() != "chip_smoke.moe"
               and not e.is_user_annotation() and "Memcpy" not in e.name()
               and "Memset" not in e.name()]
    out = dict(all_ms=0.0, moe_ms=0.0, experts_ms=0.0, moe_spans=len(spans),
               kernels=len(kernels), linked=0)
    by_name: dict = {}
    for e in kernels:
        ms = e.duration_ns() / 1e6
        out["all_ms"] += ms
        rec = by_name.setdefault(e.name()[:70], [0.0, 0])
        rec[0] += ms
        rec[1] += 1
        op = ops.get(e.linked_correlation_id())
        out["linked"] += op is not None
        i = bisect.bisect_right(starts, e.start_ns()) - 1
        if i >= 0 and e.start_ns() < spans[i][1]:
            out["moe_ms"] += ms
            if op == "aten::bmm":
                out["experts_ms"] += ms
    out["moe_rest_ms"] = out["moe_ms"] - out["experts_ms"]
    out["top"] = [dict(name=n, ms=v[0], count=v[1])
                  for n, v in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]]
    return out


def arch_served(model, kernel_fns, prompt_len: int, lens, profile=None,
                repeat: bool = False) -> dict:
    """Phase 6's served trace (4 slots, pages of 16, early advance, prompt
    refreshes every 8 with the adaptive cache where the arch takes it, 8
    requests one every 5 steps) at ``prompt_len`` with prompts of ``lens``,
    after a one-request warm-up.  With ``repeat`` a second run must give
    the same tokens.  With ``profile = (a, b)`` a further run profiles steps
    [a, b) with CPU and CUDA activity (``MoEProfiled``) and stops there."""
    import numpy as np

    from repro_torch.runtime import Request, StreamScheduler

    cfg = model.cfg
    gen_cfg = arch_gen_config(cfg, served=True)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32) for n in lens]

    def make():
        return StreamScheduler(model, gen_cfg, device="cuda", max_slots=SLOTS,
                               prompt_len=prompt_len, paged=True, page_size=16,
                               early_advance=True)
    serve_trace(make(), prompts[:1], SERVE_MAX_NEW[:1], every=5)     # warm-up
    torch.cuda.synchronize()
    sched = make()
    zero_counts(kernel_fns)
    t0 = time.perf_counter()
    reqs = serve_trace(sched, prompts, SERVE_MAX_NEW, every=5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(kernel_fns)
    check_drained(sched, reqs)
    for r, n in zip(reqs, SERVE_MAX_NEW):
        if r.output.shape != (n,):
            raise AssertionError(f"{cfg.name}: request {r.request_id} output {r.output.shape}")
    for name in ("paged_flash_attention", "scatter_rows_paged", "importance") + (
            ("variation",) if gen_cfg.adaptive_cache else ()) + (
            ("ssd_chunks",) if model.ssm else ()):
        if launches[name] <= 0:
            raise AssertionError(f"{cfg.name}: kernel {name} was not launched served")
    check_tensor_core_path(launches, f"{cfg.name} served")
    if model.ssm:
        check_ssd_tensor_core_path(launches, f"{cfg.name} served")
    st = sched.stats
    rec = dict(arch=cfg.name, prompt_len=prompt_len, prompt_lens=list(lens),
               max_new_tokens=list(SERVE_MAX_NEW), steps=st.steps, wall_s=wall,
               tokens_per_s=sum(SERVE_MAX_NEW) / wall, ms_per_step=wall / st.steps * 1e3,
               latency_p50_s=st.latency_pct(50), latency_p95_s=st.latency_pct(95),
               passes=dict(sched.engine.pass_counts), launches=launches,
               option_launches={str(k): n for k, n in kernel_fns[
                   "paged_flash_attention"].option_launches.items()},
               distinct_ids=len({int(t) for r in reqs for t in r.output}))
    if repeat:
        again = serve_trace(make(), prompts, SERVE_MAX_NEW, every=5)
        if not all(np.array_equal(a.output, b.output) for a, b in zip(again, reqs)):
            raise AssertionError(f"{cfg.name}: a repeated served trace gave other tokens")
        rec["repeat_equal"] = True
    if profile is None:
        return rec
    sched = make()
    trace = [Request(prompt=p.copy(), max_new_tokens=m) for p, m in zip(prompts, SERVE_MAX_NEW)]
    for step in range(profile[1]):
        if step % 5 == 0 and step // 5 < len(trace):
            sched.submit(trace[step // 5])
        if step == profile[0]:
            window = MoEProfiled().__enter__()
        sched.step()
    window.__exit__(None, None, None)
    rec["profile"] = dict(window.result, steps=list(profile))
    return rec


class MoEProfiled:
    """CPU and CUDA activity over whatever runs between enter and exit, each
    ``moe_apply`` in a ``chip_smoke.moe`` range; ``result`` holds
    :func:`moe_attribution`, the window's wall ms and the device ms of each
    of the port's kernels (by symbol) after the exit."""

    def __enter__(self):
        from repro_torch.models import model as model_mod

        self.mod, self.orig = model_mod, model_mod.moe_apply

        def ranged(*args, **kw):
            with torch.profiler.record_function("chip_smoke.moe"):
                return self.orig(*args, **kw)
        torch.cuda.synchronize()
        model_mod.moe_apply = ranged
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                       torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - self.t0) * 1e3
        self.prof.__exit__(*exc)
        self.mod.moe_apply = self.orig
        if exc[0] is not None:
            return
        att = moe_attribution(self.prof)
        cuda = torch.autograd.DeviceType.CUDA
        port: dict = {}
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == cuda and "repro_torch" in e.name():
                key = e.name().replace("(anonymous namespace)::", "").split("(")[0]
                key = key.split("::")[-1].split("<")[0]
                port[key] = port.get(key, 0.0) + e.duration_ns() / 1e6
        att.update(window_wall_ms=window_ms,
                   flash_tc_kernel_ms=port.get("flash_tc_kernel", 0.0),
                   scatter_rows_kernel_ms=port.get("scatter_rows_kernel", 0.0),
                   port_kernels_ms=port)
        self.result = att


def phase13(kernel_fns) -> dict:
    """13a olmoe-1b-7b, 13b gemma3-1b: offline es and served, full width,
    depths ``DEPTH_13A`` and ``DEPTH_13B``; 13c one offline es each of
    ``ARCHS_13C`` at depth ``DEPTH_13C``."""
    out = {}
    model, init_s = full_width("olmoe-1b-7b", DEPTH_13A)
    out["13a"] = dict(init_s=init_s, offline=arch_offline(model, kernel_fns),
                      drops=moe_drop_share(model),
                      served=arch_served(model, kernel_fns, PROMPT, LENS_13A,
                                         profile=PROFILE_13A))
    del model
    torch.cuda.empty_cache()
    model, init_s = full_width("gemma3-1b", DEPTH_13B)
    cfg = model.cfg
    n_local = sum(not cfg.layer_is_global_attn(l) for l in range(cfg.n_layers))
    rec = dict(init_s=init_s, local_layers=n_local,
               offline=arch_offline(model, kernel_fns, GEMMA_PROMPT),
               served=arch_served(model, kernel_fns, GEMMA_PROMPT, LENS_13B))
    for run, att in (("offline", "flash_attention"), ("served", "paged_flash_attention")):
        opts = rec[run]["option_launches"]
        n = rec[run]["launches"][att]
        want = {str((GEMMA_WINDOW, 0, 0, 0, 0)): n * n_local // cfg.n_layers,
                str((0, 0, 0, 0, 0)): n * (cfg.n_layers - n_local) // cfg.n_layers}
        if opts != want:
            raise AssertionError(f"13b {run}: attention option launches {opts}, not {want}")
    out["13b"] = rec
    del model
    torch.cuda.empty_cache()
    for arch in ARCHS_13C:
        model, init_s = full_width(arch, DEPTH_13C)
        out.setdefault("13c", {})[arch] = dict(init_s=init_s,
                                               offline=arch_offline(model, kernel_fns))
        del model
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 14: the Jamba hybrid at full width
# ---------------------------------------------------------------------------
# 14's depth: two of Jamba's four periods of 8.  In bf16 all 32 layers take
# 102.9 GB, three periods 77.5 GB (no room for caches and activations on an
# 80 GB card), two 52.0 GB (PERF.md §4).  Not one: the engine's skip stages
# sit between period groups, so one group runs no early skip
DEPTH_14 = 16


def jamba_offline(model, kernel_fns) -> dict:
    """14a: offline es at phase 5's shape after a warm-up call, three timed
    ``generate`` calls (equal tokens) with the launches of the first, one
    dualcache ``generate`` after its own warm-up, a ``generate`` profiled on
    the card alone (busy share) and one with CPU activity too
    (``MoEProfiled``), split into kernels 1, 3, 6 and 8, the MoE FFN and
    the rest.  Every attention and SSD launch on the tensor-core body."""
    from repro_torch.core import make_engine

    cfg = model.cfg
    gen_cfg = arch_gen_config(cfg, served=False)
    prompt = torch.randint(3, cfg.vocab_size, (2, PROMPT), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(SEED + 1))
    engine = make_engine(model, gen_cfg, device="cuda")
    engine.generate(prompt)                       # warm-up
    torch.cuda.synchronize()
    walls, outs = [], []
    for i in range(3):
        zero_counts(kernel_fns)
        t0 = time.perf_counter()
        outs.append(engine.generate(prompt))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            launches = counts(kernel_fns)
    if not all(torch.equal(o, outs[0]) for o in outs):
        raise AssertionError("jamba: a repeated greedy generate gave other tokens")
    gen_tok = outs[0][:, PROMPT:]
    if (gen_tok == engine.mask_id).any().item() or not (
            (gen_tok >= 0) & (gen_tok < cfg.vocab_size)).all().item():
        raise AssertionError("jamba: a [mask] id or an id outside the vocabulary")
    for name in ("flash_attention", "scatter_rows", "importance", "ssd_chunks"):
        if launches[name] <= 0:
            raise AssertionError(f"jamba: kernel {name} was not launched offline")
    check_tensor_core_path(launches, "phase 14a es")
    check_ssd_tensor_core_path(launches, "phase 14a es")
    dual = make_engine(model, dataclasses.replace(gen_cfg, mode="dualcache", skip_stages=()),
                       device="cuda")
    dual.generate(prompt)
    torch.cuda.synchronize()
    zero_counts(kernel_fns)
    t0 = time.perf_counter()
    dual_out = dual.generate(prompt)
    torch.cuda.synchronize()
    dual_wall = time.perf_counter() - t0
    dual_launches = counts(kernel_fns)
    check_tensor_core_path(dual_launches, "phase 14a dualcache")
    check_ssd_tensor_core_path(dual_launches, "phase 14a dualcache")
    profile = profile_run(lambda: engine.generate(prompt))
    with MoEProfiled() as window:
        engine.generate(prompt)
    att = window.result
    port = att["port_kernels_ms"]
    split = {"1 flash_tc_kernel": port.get("flash_tc_kernel", 0.0),
             "3 scatter_rows_kernel": port.get("scatter_rows_kernel", 0.0),
             "6 score_kernel": port.get("score_kernel", 0.0),
             "8 ssd_tc_kernel": port.get("ssd_tc_kernel", 0.0),
             "moe_ffn": att["moe_ms"]}
    split["rest"] = att["all_ms"] - sum(split.values())
    return dict(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
                attn_layers=model.attn_layers, weights_gb=sum(nbytes(p) for p in
                                                              model.parameters()) / 1e9,
                segments=[dataclasses.asdict(sg) for sg in engine.segments],
                batch=2, prompt_len=PROMPT, gen_length=GEN, block_length=BLOCK,
                iterations=engine.iterations, wall_s=walls[0], wall_s_repeats=walls,
                tokens_per_s=2 * GEN / walls[0], tokens_per_s_best=2 * GEN / min(walls),
                distinct_ids=len(torch.unique(gen_tok)), launches=launches,
                dualcache=dict(wall_s=dual_wall, tokens_per_s=2 * GEN / dual_wall,
                               iterations=dual.iterations, launches=dual_launches,
                               tokens_equal_es=float((dual_out == outs[0]).float().mean())),
                profile=profile, device_ms_split=split, moe_window=att)


def jamba_sampled(model, kernel_fns) -> dict:
    """14c: phase 7's request plan (two duplicate-prompt cohorts, then two
    priority classes) sampled at temperature 0.2 and top-p 0.95 on the paged
    pool with early advance, once with prefix sharing (the fork must run)
    and once with preemption on phase 7b's tight pool (a spill and a
    resume).  MoE rows share routing groups, so the two runs' tokens are
    compared, not required equal."""
    import numpy as np

    from repro_torch.runtime import StreamScheduler

    cfg = model.cfg
    gen_cfg = dataclasses.replace(arch_gen_config(cfg, served=True), temperature=0.2,
                                  top_p=0.95)
    rng = np.random.default_rng(SEED)
    prompts = {k: rng.integers(3, cfg.vocab_size, n).astype(np.int32)
               for k, n in DREAM_PROMPTS.items()}
    out, outputs = {}, {}
    for name, kw in (("sharing", dict(prefix_sharing=True)),
                     ("preemption", dict(preemption=True, kv_pages=DREAM_PREEMPT_PAGES))):
        sched = StreamScheduler(model, gen_cfg, device="cuda", max_slots=SLOTS,
                                prompt_len=PROMPT, paged=True, page_size=16, early_advance=True,
                                **kw)
        zero_counts(kernel_fns)
        t0 = time.perf_counter()
        reqs, peak_shared = dream_trace(sched, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_drained(sched, reqs, GEN)
        launches = counts(kernel_fns)
        check_tensor_core_path(launches, f"phase 14c {name}")
        check_ssd_tensor_core_path(launches, f"phase 14c {name}")
        st = sched.stats
        outputs[name] = [r.output for r in reqs]
        out[name] = dict(options={k: v for k, v in kw.items()}, steps=st.steps, wall_s=wall,
                         tokens_per_s=len(reqs) * GEN / wall, ms_per_step=wall / st.steps * 1e3,
                         latency_p50_s=st.latency_pct(50), latency_p95_s=st.latency_pct(95),
                         cow_forks=st.cow_forks, peak_shared_mappings=peak_shared,
                         preemptions=st.preemptions, pages_spilled=st.pages_spilled,
                         resumes=len(st.resume_waits), pages_total=st.pages_total,
                         peak_pages_in_use=st.peak_pages_in_use, launches=launches)
    if out["sharing"]["cow_forks"] <= 0 or out["sharing"]["launches"]["fork_pages"] < 1:
        raise AssertionError(f"14c: no copy-on-write fork on the path: {out['sharing']}")
    if out["preemption"]["preemptions"] < 1 or out["preemption"]["resumes"] < 1:
        raise AssertionError(f"14c: no preemption and resume: {out['preemption']}")
    same = [np.array_equal(x, y) for x, y in zip(outputs["sharing"], outputs["preemption"])]
    out["tokens_equal_share"] = sum(same) / len(same)
    return out


def phase14(kernel_fns) -> dict:
    """jamba-v0.1-52b at full width, ``DEPTH_14`` layers: 14a offline, the
    MoE drop share, 14b served (twice), 14c sampled sharing and
    preemption; the card's memory before the model and at its peak."""
    before_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    model, init_s = full_width(JAMBA, DEPTH_14)
    out = dict(init_s=init_s, allocated_before_gb=before_gb,
               offline=jamba_offline(model, kernel_fns), drops=moe_drop_share(model),
               served=arch_served(model, kernel_fns, PROMPT, LENS_13A, repeat=True),
               sampled=jamba_sampled(model, kernel_fns))
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del model
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 15: the encoder-conditioned archs at full width
# ---------------------------------------------------------------------------
PROFILE_15B = (40, 70)          # the profiled window of 15b's served trace (steps)
# 15a-b's depth: the vision model's 40 layers cut to 20 (4 of its 8 periods of
# 5, 4 cross layers) to make room for phase 17, then to 10 (2 periods, 2
# cross layers) for phase 18 (PERF.md §4)
DEPTH_15A = 10


def enc_embeds_on_card(cfg, n: int, seed: int) -> torch.Tensor:
    """``[n, E, d_enc]`` float32 stub frontend embeddings, made on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(n, cfg.n_enc_tokens, cfg.d_enc, generator=g, device="cuda")


class CrossProfiled:
    """CPU and CUDA activity over whatever runs between enter and exit, each
    cross-attention layer in a ``chip_smoke.cross`` range; ``result`` holds
    the device ms of every kernel, of those inside the ranges (the query,
    K/V and output projections and kernel 1) and of kernel 1's launches
    among them."""

    def __init__(self):
        from repro_torch.models import model as model_mod

        self.mod, self.orig = model_mod, model_mod.cross_attention

    def __enter__(self):
        def ranged(*args, **kw):
            with torch.profiler.record_function("chip_smoke.cross"):
                return self.orig(*args, **kw)
        torch.cuda.synchronize()
        self.mod.cross_attention = ranged
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                       torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        import bisect

        torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        self.mod.cross_attention = self.orig
        if exc[0] is not None:
            return
        cuda = torch.autograd.DeviceType.CUDA
        evs = [e for e in self.prof.profiler.kineto_results.events() if e.device_type() == cuda]
        spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in evs
                       if e.name() == "chip_smoke.cross")
        starts = [a for a, _ in spans]
        res = dict(all_ms=0.0, cross_ms=0.0, cross_kernel1_ms=0.0, cross_kernel1_launches=0,
                   spans=len(spans))
        for e in evs:
            if (e.name() == "chip_smoke.cross" or e.is_user_annotation()
                    or "Memcpy" in e.name() or "Memset" in e.name()):
                continue
            ms = e.duration_ns() / 1e6
            res["all_ms"] += ms
            i = bisect.bisect_right(starts, e.start_ns()) - 1
            if i >= 0 and e.start_ns() < spans[i][1]:
                res["cross_ms"] += ms
                if "flash_tc_kernel" in e.name() or "flash_attention_kernel" in e.name():
                    res["cross_kernel1_ms"] += ms
                    res["cross_kernel1_launches"] += 1
        res["cross_share"] = res["cross_ms"] / res["all_ms"] if res["all_ms"] else 0.0
        self.result = res


def encoder_offline(model, kernel_fns, temperature: float = 0.0, dualcache: bool = False,
                    profile: bool = False) -> dict:
    """Offline es at phase 5's shape with one ``enc_embeds`` a row made on
    the card, after a warm-up call: one timed ``generate`` with its launches
    (kernel 1 as self-attention, as cross-attention, in the encoder), a
    second that must give the same tokens; with ``dualcache`` one dualcache
    ``generate`` after its warm-up; with ``profile`` a ``generate`` traced
    on the card alone (busy share) and one with CPU activity (the
    cross-attention's device ms).  Every attention launch on the tensor-core
    body."""
    from repro_torch.core import make_engine

    cfg = model.cfg
    gen_cfg = dataclasses.replace(arch_gen_config(cfg, served=False), temperature=temperature)
    prompt = torch.randint(3, cfg.vocab_size, (2, PROMPT), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(SEED + 1))
    enc = enc_embeds_on_card(cfg, 2, SEED + 2)
    engine = make_engine(model, gen_cfg, device="cuda")
    engine.generate(prompt, enc_embeds=enc)                   # warm-up
    torch.cuda.synchronize()
    zero_counts(kernel_fns)
    passes0 = dict(engine.pass_counts)
    with CrossLaunches(model) as cl:
        t0 = time.perf_counter()
        out = engine.generate(prompt, enc_embeds=enc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = counts(kernel_fns)
    passes = {k: n - passes0[k] for k, n in engine.pass_counts.items()}
    t0 = time.perf_counter()
    again = engine.generate(prompt, enc_embeds=enc)
    torch.cuda.synchronize()
    walls = [wall, time.perf_counter() - t0]
    if not torch.equal(again, out):
        raise AssertionError(f"{cfg.name}: a repeated generate gave other tokens")
    gen_tok = out[:, PROMPT:]
    if (gen_tok == engine.mask_id).any().item() or not (
            (gen_tok >= 0) & (gen_tok < cfg.vocab_size)).all().item():
        raise AssertionError(f"{cfg.name}: a [mask] id or an id outside the vocabulary")
    need = ["flash_attention"] + (["scatter_rows"] if model.attn_layers else []) + (
        ["importance"] if passes["skip"] else [])
    for name in need:
        if launches[name] <= 0:
            raise AssertionError(f"{cfg.name}: kernel {name} was not launched offline")
    if cl.cross <= 0 or (model.encoder is not None and cl.encoder <= 0):
        raise AssertionError(f"{cfg.name}: kernel 1 as cross-attention {cl.cross}, in the "
                             f"encoder {cl.encoder}")
    check_tensor_core_path(launches, f"phase 15 {cfg.name} offline")
    cross = engine.last_state.cache.cross
    rec = dict(arch=cfg.name, layers=cfg.n_layers, encoder_layers=cfg.n_encoder_layers,
               cross_layers=len(model.cross_layers), d_model=cfg.d_model,
               enc_tokens=cfg.n_enc_tokens, temperature=temperature,
               weights_gb=sum(nbytes(p) for p in model.parameters()) / 1e9,
               segments=[dataclasses.asdict(sg) for sg in engine.segments],
               batch=2, prompt_len=PROMPT, gen_length=GEN, block_length=BLOCK,
               iterations=engine.iterations, passes=passes,
               wall_s=wall, wall_s_repeats=walls, tokens_per_s=2 * GEN / wall,
               distinct_ids=len(torch.unique(gen_tok)), launches=launches,
               kernel1_self=launches["flash_attention"] - cl.cross - cl.encoder,
               kernel1_cross=cl.cross, kernel1_encoder=cl.encoder,
               cross_plane_bytes_per_row=nbytes(cross.k, cross.v) / 2)
    if dualcache:
        dual = make_engine(model, dataclasses.replace(gen_cfg, mode="dualcache",
                                                      skip_stages=()), device="cuda")
        dual.generate(prompt, enc_embeds=enc)
        torch.cuda.synchronize()
        zero_counts(kernel_fns)
        t0 = time.perf_counter()
        dual_out = dual.generate(prompt, enc_embeds=enc)
        torch.cuda.synchronize()
        dual_wall = time.perf_counter() - t0
        dual_launches = counts(kernel_fns)
        check_tensor_core_path(dual_launches, f"phase 15 {cfg.name} dualcache")
        rec["dualcache"] = dict(wall_s=dual_wall, tokens_per_s=2 * GEN / dual_wall,
                                iterations=dual.iterations, launches=dual_launches,
                                tokens_equal_es=float((dual_out == out).float().mean()))
    if profile:
        rec["profile"] = profile_run(lambda: engine.generate(prompt, enc_embeds=enc))
        with CrossProfiled() as window:
            engine.generate(prompt, enc_embeds=enc)
        rec["cross_profile"] = window.result
    return rec


def enc_trace(sched, prompts, encs, plan):
    """Submits ``plan``'s requests ``(step, prompt index, priority,
    max_new_tokens)``, each with its own row of ``encs``, at their steps and
    drains.  Returns the requests in plan order."""
    from repro_torch.runtime import Request

    reqs = [Request(prompt=prompts[i].copy(), enc_embeds=encs[i], priority=prio,
                    max_new_tokens=m, sample_seed=1000 + n)
            for n, (_, i, prio, m) in enumerate(plan)]
    last = max(at for at, *_ in plan)
    step = 0
    while step <= last or sched.has_work():
        for (at, *_), r in zip(plan, reqs):
            if at == step:
                sched.submit(r)
        sched.step()
        step += 1
    return reqs


# phase 6's plan (8 requests, one every 5 steps, on its prompts) and 7b's
# (two priority classes, on Dream's prompts: the first four fill 44 of the
# 45 pages, so the class-1 arrival spills a resident)
PLAN_15 = tuple((5 * i, i, 0, m) for i, m in enumerate(SERVE_MAX_NEW))
PLAN_15_PREEMPT = tuple((at, i, prio, None) for i, (at, _, prio) in enumerate(DREAM_PLAN))


def encoder_served(model, kernel_fns, preempt: bool = False, profile=None,
                   repeat: bool = False) -> dict:
    """Phase 6's trace on the paged pool (4 slots, pages of 16, early
    advance, no adaptive cache: the reference refuses it on these stacks),
    each request with its own ``enc_embeds`` made on the card, after a
    one-request warm-up; ``Model.encode`` calls counted (one a request).
    With ``repeat`` a second run must give the same tokens; with ``profile
    = (a, b)`` a further run profiles steps [a, b) on the card.  With
    ``preempt``, 7b's plan of two priority classes on its 45-page pool:
    spills and resumes, each resume encoded again."""
    import numpy as np

    from repro_torch.runtime import StreamScheduler

    cfg = model.cfg
    gen_cfg = arch_gen_config(cfg, served=True)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32) for n in LENS_13A]
    dream = {k: rng.integers(3, cfg.vocab_size, n).astype(np.int32)
             for k, n in DREAM_PROMPTS.items()}
    encs = enc_embeds_on_card(cfg, len(prompts), SEED + 3)

    def make(**kw):
        return StreamScheduler(model, gen_cfg, device="cuda", max_slots=SLOTS,
                               prompt_len=PROMPT, paged=True, page_size=16,
                               early_advance=True, **kw)
    enc_trace(make(), prompts, encs, PLAN_15[:1])               # warm-up
    torch.cuda.synchronize()
    runs = {"served": (PLAN_15, prompts, {})}
    if preempt:
        runs["preemption"] = (PLAN_15_PREEMPT, [dream[name] for _, name, _ in DREAM_PLAN],
                              dict(preemption=True, kv_pages=DREAM_PREEMPT_PAGES))
    out = {}
    for name, (plan, run_prompts, kw) in runs.items():
        sched = make(**kw)
        zero_counts(kernel_fns)
        passes0 = dict(sched.engine.pass_counts)
        with CrossLaunches(model) as cl:
            t0 = time.perf_counter()
            reqs = enc_trace(sched, run_prompts, encs, plan)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = counts(kernel_fns)
        check_drained(sched, reqs)
        for r, (*_, m) in zip(reqs, plan):
            if r.output.shape != (m or GEN,):
                raise AssertionError(f"{cfg.name}: request {r.request_id} {r.output.shape}")
        passes = {k: n - passes0[k] for k, n in sched.engine.pass_counts.items()}
        need = ("flash_attention",) + (("importance",) if passes["skip"] else ()) + (
            ("paged_flash_attention", "scatter_rows_paged") if model.attn_layers else ())
        for k in need:
            if launches[k] <= 0:
                raise AssertionError(f"{cfg.name} {name}: kernel {k} was not launched")
        check_tensor_core_path(launches, f"phase 15 {cfg.name} {name}")
        st = sched.stats
        resumes = len(st.resume_waits)
        if cl.encodes != len(plan) + resumes or cl.cross <= 0:
            raise AssertionError(f"{cfg.name} {name}: {cl.encodes} encodes for {len(plan)} "
                                 f"requests and {resumes} resumes; {cl.cross} cross launches")
        if name == "preemption" and (st.preemptions < 1 or resumes < 1):
            raise AssertionError(f"{cfg.name}: no preemption and resume: {st.gauges()}")
        tokens = sum(len(r.output) for r in reqs)
        out[name] = dict(requests=len(reqs), steps=st.steps, wall_s=wall,
                         tokens_per_s=tokens / wall, ms_per_step=wall / st.steps * 1e3,
                         latency_p50_s=st.latency_pct(50), latency_p95_s=st.latency_pct(95),
                         encodes=cl.encodes, preemptions=st.preemptions, resumes=resumes,
                         pages_spilled=st.pages_spilled, pages_total=st.pages_total,
                         peak_pages_in_use=st.peak_pages_in_use,
                         passes=passes, launches=launches,
                         kernel1_cross=cl.cross, kernel1_encoder=cl.encoder,
                         distinct_ids=len({int(t) for r in reqs for t in r.output}))
        if name == "served" and repeat:
            again = enc_trace(make(), prompts, encs, plan)
            if not all(np.array_equal(a.output, b.output) for a, b in zip(again, reqs)):
                raise AssertionError(f"{cfg.name}: a repeated served trace gave other tokens")
            out[name]["repeat_equal"] = True
    if profile is not None:
        sched = make()
        from repro_torch.runtime import Request
        trace = [Request(prompt=prompts[i].copy(), enc_embeds=encs[i], max_new_tokens=m)
                 for _, i, _, m in PLAN_15]
        for step in range(profile[1]):
            if step % 5 == 0 and step // 5 < len(trace):
                sched.submit(trace[step // 5])
            if step == profile[0]:
                window = Profiled().__enter__()
            sched.step()
        window.__exit__(None, None, None)
        out["served"]["profile"] = dict(window.result, steps=list(profile))
    return out


def phase15(kernel_fns) -> dict:
    """15a-b llama-3.2-vision-11b (``DEPTH_15A`` of its 40 layers): offline es
    and dualcache with profiles, then served with a profiled window and under
    preemption;
    15c seamless-m4t-large-v2 (24 decoder and 6 encoder layers): offline es
    greedy and sampled, and served twice on the paged pool (no K/V plane)."""
    out = {}
    model, init_s = full_width(VLM, DEPTH_15A)
    out["15a"] = dict(init_s=init_s, offline=encoder_offline(model, kernel_fns, dualcache=True,
                                                             profile=True))
    out["15b"] = encoder_served(model, kernel_fns, preempt=True, profile=PROFILE_15B)
    del model
    torch.cuda.empty_cache()
    model, init_s = full_width(AUDIO)
    out["15c"] = dict(init_s=init_s, offline=encoder_offline(model, kernel_fns),
                      sampled=encoder_offline(model, kernel_fns, temperature=0.2),
                      served=encoder_served(model, kernel_fns, repeat=True)["served"])
    del model
    torch.cuda.empty_cache()
    return out

def report15(enc_runs: dict) -> None:
    """Phase 15's lines: each run's record and a summary."""
    for name, run in (("15a", enc_runs["15a"]["offline"]), ("15c es", enc_runs["15c"]["offline"]),
                      ("15c sampled", enc_runs["15c"]["sampled"])):
        print(f"phase {name}: {json.dumps(run)}")
        print(f"phase {name} {run['arch']} ({run['layers']} layers, {run['weights_gb']:.2f} GB): "
              f"{json.dumps(run['wall_s_repeats'])} s a generate, {run['tokens_per_s']:.1f} "
              f"tok/s, {run['iterations']} iterations; kernel 1 self {run['kernel1_self']}, "
              f"cross {run['kernel1_cross']}, encoder {run['kernel1_encoder']}; cross planes "
              f"{run['cross_plane_bytes_per_row'] / 1e6:.1f} MB a row")
    r = enc_runs["15a"]["offline"]
    print(f"phase 15a: dualcache {r['dualcache']['wall_s']:.2f} s; busy "
          f"{r['profile']['device_busy_ms']:.1f} ms ({r['profile']['device_busy_share']:.3f}); "
          f"cross-attention {r['cross_profile']['cross_ms']:.2f} ms of "
          f"{r['cross_profile']['all_ms']:.1f} ({r['cross_profile']['cross_share']:.3f}), "
          f"kernel 1 in it {r['cross_profile']['cross_kernel1_ms']:.2f} ms")
    for name, r in (("15b served", enc_runs["15b"]["served"]),
                    ("15b preemption", enc_runs["15b"]["preemption"]),
                    ("15c served", enc_runs["15c"]["served"])):
        print(f"phase {name}: {json.dumps(r)}")
        print(f"phase {name}: {r['steps']} steps at {r['ms_per_step']:.1f} ms, "
              f"{r['tokens_per_s']:.1f} tok/s, p50/p95 {r['latency_p50_s']:.2f}/"
              f"{r['latency_p95_s']:.2f} s, encodes {r['encodes']}, preemptions "
              f"{r['preemptions']}, resumes {r['resumes']}")


# ---------------------------------------------------------------------------
# phases 4 and 16: training
# ---------------------------------------------------------------------------
# phase 4's reduced training check: (arch, MoE capacity factor)
TRAIN_CROSS = (("qwen2-1.5b", None), ("olmoe-1b-7b", 0.5))
# phase 16: the reference launcher's own example at full width and depth
# (repro/launch/train.py:4), f32 as its config; 8 steps of 4 x 512 tokens
TRAIN_FULL = dict(arch="qwen2-1.5b", batch=4, seq=512, ce_chunk=256, lr=1e-3, steps=8)


def train_agreement(card: dict, cpu: dict) -> dict:
    """Card against CPU after the same training steps (flat trees of numpy
    arrays): the first step's gradients (equal parameters going in) within
    1e-4 of each leaf's largest |g|, as the CPU tests hold the port to
    ``jax.value_and_grad``; after the last step, each leaf's move from the
    start within 1e-2 of the CPU's move in l2.  The moves are looser than
    the gradients: Adam divides each gradient element by its own size plus
    1e-8, so an element whose gradient is near 1e-8 turns a rounding
    difference into a visible part of its step (a bias that starts at 0
    shows it most, against its own largest value).  Also reports the
    largest parameter difference over each leaf's largest |value| and over
    the summed learning rates."""
    import numpy as np

    out = dict(grad_err=0.0, move_l2_ratio=0.0, max_err_over_leaf_max=0.0,
               max_err_over_lr_sum=0.0)
    for path, g in cpu["grads"].items():
        out["grad_err"] = max(out["grad_err"], float(np.abs(card["grads"][path] - g).max())
                              / max(float(np.abs(g).max()), 1e-30))
    for path, w in cpu["params"].items():
        d = card["params"][path] - w
        move = float(np.linalg.norm(w - cpu["start"][path]))
        out["move_l2_ratio"] = max(out["move_l2_ratio"],
                                   float(np.linalg.norm(d)) / max(move, 1e-30))
        err = float(np.abs(d).max())
        out["max_err_over_leaf_max"] = max(out["max_err_over_leaf_max"],
                                           err / max(float(np.abs(w).max()), 1e-30))
        out["max_err_over_lr_sum"] = max(out["max_err_over_lr_sum"], err / cpu["lr_sum"])
    if not (out["grad_err"] <= 1e-4 and out["move_l2_ratio"] <= 1e-2):
        raise AssertionError(f"training on the card and the CPU differ: {out}")
    return out


def cross_device_training(kernel_fns) -> dict:
    """Reduced qwen2-1.5b and olmoe-1b-7b (capacity factor 0.5: picks drop)
    at 4 layers in f32, at the init scale: two ``make_train_step`` steps on
    the card against the same two on the CPU, from the same weights, key and
    batches (2 x 64, CE chunks of 32): losses within 1e-5 relative, the
    gradients and the parameters' moves by :func:`train_agreement`; no
    hand-written kernel launches during the card's steps (the training
    forward takes the plain versions).  Then :func:`grad_guard`."""
    from repro_torch.convert import params_to_numpy
    from repro_torch.core import prng
    from repro_torch.train import (
        DataConfig,
        OptimizerConfig,
        SyntheticTextDataset,
        TrainState,
        init_opt_state,
        make_train_step,
    )
    from repro_torch.utils.tree import flatten_with_paths

    out = {}
    for arch, cf in TRAIN_CROSS:
        models = reduced_models(arch, 1.0, capacity_factor=cf)
        start = flatten_with_paths(params_to_numpy(models["cpu"]))
        runs = {}
        for dev in ("cpu", "cuda"):
            model = models[dev]
            step = make_train_step(model, OptimizerConfig(lr=1e-3, warmup_steps=1,
                                                          total_steps=4), ce_chunk=32)
            state = TrainState(model, init_opt_state(model), prng.prng_key(SEED, device=dev))
            ds = SyntheticTextDataset(DataConfig(vocab_size=model.cfg.vocab_size, seq_len=64,
                                                 global_batch=2, seed=SEED))
            zero_counts(kernel_fns)
            run = dict(losses=[], lr_sum=0.0, start=start)
            for i in range(2):
                state, m = step(state, ds.next_batch())
                run["losses"].append(float(m["loss"]))
                run["lr_sum"] += float(m["lr"])
                if i == 0:
                    run["grads"] = flatten_with_paths(params_to_numpy(model, grads=True))
            launched = {k: v for k, v in counts(kernel_fns).items() if v}
            if launched:
                raise AssertionError(f"{arch} training on {dev} launched kernels {launched}")
            runs[dev] = dict(run, params=flatten_with_paths(params_to_numpy(model)))
        for a, b in zip(runs["cuda"]["losses"], runs["cpu"]["losses"]):
            if not abs(a - b) <= 1e-5 * abs(b):
                raise AssertionError(f"{arch}: card losses {runs['cuda']['losses']}, CPU "
                                     f"{runs['cpu']['losses']}")
        out[arch] = dict(losses_card=runs["cuda"]["losses"], losses_cpu=runs["cpu"]["losses"],
                         kernel_launches=0, **train_agreement(runs["cuda"], runs["cpu"]))
    out["grad_guard"] = grad_guard(kernel_fns)
    return out


def grad_guard(kernel_fns) -> list:
    """Every kernel wrapper raises when handed an input that requires grad
    (the kernels have no backward), and runs on the same inputs with grad
    mode off.  Returns the wrappers checked."""
    dev = torch.device("cuda")

    def f(*shape, grad):
        return torch.randn(*shape, device=dev).requires_grad_(grad)

    def z(*shape, dtype=torch.float32):
        return torch.zeros(*shape, dtype=dtype, device=dev)
    pos = torch.arange(8, dtype=torch.int32, device=dev)[None].contiguous()
    bt = torch.ones(1, 1, dtype=torch.int32, device=dev)

    def q8(*lead):
        return (z(*lead, 2, 32, dtype=torch.int8), z(*lead, 2))
    calls = {
        "flash_attention": lambda g: (f(1, 2, 8, 32, grad=g), z(1, 2, 8, 32), z(1, 2, 8, 32),
                                      pos, pos),
        "paged_flash_attention": lambda g: (f(1, 2, 8, 32, grad=g), z(2, 8, 2, 32),
                                            z(2, 8, 2, 32), pos, pos, bt),
        "scatter_rows": lambda g: (((z(1, 16, 2, 32), f(1, 8, 2, 32, grad=g)),
                                    (z(1, 16, 2, 32), f(1, 8, 2, 32, grad=g))), pos),
        "scatter_rows_paged": lambda g: (((z(2, 8, 2, 32), f(1, 8, 2, 32, grad=g)),
                                          (z(2, 8, 2, 32), f(1, 8, 2, 32, grad=g))), pos, bt),
        "quantize_scatter_rows": lambda g: (((q8(1, 16), f(1, 8, 2, 32, grad=g)),
                                             (q8(1, 16), f(1, 8, 2, 32, grad=g))), pos),
        "quantize_scatter_rows_paged": lambda g: (((q8(2, 8), f(1, 8, 2, 32, grad=g)),
                                                   (q8(2, 8), f(1, 8, 2, 32, grad=g))), pos, bt),
        "fork_pages": lambda g: (f(1, 4, 8, 2, 32, grad=g), z(1, 4, 8, 2, 32), [1], [2]),
        "importance": lambda g: (f(1, 8, 64, grad=g), z(1, 8, 64), z(1, 8)),
        "variation": lambda g: (f(1, 8, 64, grad=g), z(1, 8, 64), z(1, 8)),
        "ssd_chunks": lambda g: (f(1, 16, 2, 16, grad=g), z(1, 16, 2) + 0.1, z(2),
                                 z(1, 16, 1, 16), z(1, 16, 1, 16)),
    }
    extra = {"importance": dict(alpha=0.5), "variation": dict(alpha=0.5),
             "ssd_chunks": dict(chunk=16)}
    if set(calls) != set(kernel_fns):
        raise AssertionError(f"grad guard: wrappers {sorted(kernel_fns)}, checked {sorted(calls)}")
    for name, fn in kernel_fns.items():
        try:
            fn(*calls[name](True), **extra.get(name, {}))
        except RuntimeError as e:
            if "requires grad" not in str(e):
                raise
        else:
            raise AssertionError(f"{name} took an input that requires grad")
        with torch.no_grad():
            fn(*calls[name](True), **extra.get(name, {}))
    torch.cuda.synchronize()
    return sorted(calls)


def phase16(kernel_fns) -> dict:
    """qwen2-1.5b at full width and depth in its config's float32 (28
    layers, d 1536, 12 on 2 KV heads of 128, tied vocab 151,936), seeded
    random weights made on the card (``init_train_state``), trained with
    remat for ``TRAIN_FULL["steps"]`` steps of synthetic 4 x 512 batches:
    every loss finite and the least of the last three below the first; no
    hand-written kernel launched.  Times each step (host clock, synchronized
    at both ends); FLOPs counted as 8 N tokens (forward, the remat's second
    forward and the backward pass), attention's score products left out.
    A ninth step, out of the timing, is profiled: the device's busy share
    and the kernels with the most device time."""
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.models import Model
    from repro_torch.train import (
        DataConfig,
        OptimizerConfig,
        SyntheticTextDataset,
        init_train_state,
        make_train_step,
    )
    from repro_torch.utils.tree import param_count

    t = TRAIN_FULL
    cfg = configs.get_config(t["arch"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda")
    state = init_train_state(model, prng.prng_key(SEED, device="cuda"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(dict(model.named_parameters()))
    step = make_train_step(model, OptimizerConfig(lr=t["lr"], warmup_steps=1,
                                                  total_steps=t["steps"]),
                           ce_chunk=t["ce_chunk"])
    ds = SyntheticTextDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=t["seq"],
                                         global_batch=t["batch"], seed=SEED))
    zero_counts(kernel_fns)
    losses, walls, grad_norms = [], [], []
    for _ in range(t["steps"]):
        batch = ds.next_batch()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        losses.append(float(m["loss"]))
        grad_norms.append(float(m["grad_norm"]))
    with Profiled(top=10) as prof:          # one more step, profiled, out of the timing
        state, _ = step(state, ds.next_batch())
    launched = {k: v for k, v in counts(kernel_fns).items() if v}
    if launched:
        raise AssertionError(f"phase 16: training launched kernels {launched}")
    if not all(map(math.isfinite, losses)) or not min(losses[-3:]) < losses[0]:
        raise AssertionError(f"phase 16: losses {losses}")
    tokens = t["batch"] * t["seq"]
    s_step = statistics.median(walls[1:])
    flops = 8 * n_params * tokens
    out = dict(t, layers=cfg.n_layers, params=n_params, tokens_per_step=tokens,
               init_s=init_s, losses=losses, grad_norms=grad_norms, step_s=walls,
               median_s_per_step=s_step, tokens_per_s=tokens / s_step,
               tflops=flops / s_step / 1e12, peak_tflops=PEAK_FLOPS[torch.float32] / 1e12,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               reckoned_gb=16 * n_params / 1e9, kernel_launches=0, profile=prof.result)
    del state, model, step
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 17 and 18: tensor parallelism, two gloo ranks on the one card
# ---------------------------------------------------------------------------
TP = 2
# 17a's depth: LLaDA-8B's 32 layers cut to 8 for the f32 parity check
TP_DEPTH_A = 8
# 17b's depth: LLaDA-8B's 32 layers cut to 16, to make room for phase 18
# (PERF.md §4)
TP_DEPTH_B = 16
# 17b's work, cut to what the phase's time allows (gloo through the host
# takes 4-9 ms an all-reduce on one card, PERF.md §5): a generate of one
# block at phase 5's shape, and phase 6's trace cut to three of its
# requests of one block each (prompts 64, 128 and 32, 32 new tokens),
# submitted 5 steps apart, so that three slots are live at once; 18b the same
TP_GEN_B = BLOCK
TP_SERVE_REQUESTS = (1, 3, 4)
# the dry runs beside 17b's and 18b's configurations: one decode step at
# phase 5's shape
TP_DRYRUN_SHAPE = (T_TOTAL, 2)
# 18a: mamba2-370m's 48 layers cut to 8 and SeamlessM4T uncut, in f32
TP_PARITY_18 = (("mamba2-370m", 8), (AUDIO, None))


def tp_gen_config(cfg):
    """Phase 5's generation config."""
    from repro_torch import configs

    return configs.GenerationConfig(
        mode="es", gen_length=GEN, block_length=BLOCK,
        skip_stages=configs.default_skip_stages(cfg.n_layers),
        prompt_refresh_period=32, block_refresh_period=4)


def tp_cfg(arch: str, dtype: str, n_layers=None):
    from repro_torch import configs

    cfg = dataclasses.replace(configs.get_config(arch), param_dtype=dtype, compute_dtype=dtype)
    return dataclasses.replace(cfg, n_layers=n_layers) if n_layers else cfg


def tp_prompt(cfg):
    import numpy as np

    return np.random.default_rng(SEED + 1).integers(3, cfg.vocab_size, (2, PROMPT)) \
        .astype(np.int32)


def tp_enc(cfg):
    """The encoder-conditioned archs' ``enc_embeds`` of the prompt's two
    rows, made on the card from the seed; None on the others."""
    if cfg.family not in ("audio", "vlm"):
        return None
    return enc_embeds_on_card(cfg, 2, SEED + 2)


def tp_one_block(model, cfg) -> dict:
    """One offline es greedy ``generate`` of one block at phase 5's prompt:
    its tokens, the final block's confidences, and kernel 1's launches in
    the cross-attention layers and the encoder."""
    from repro_torch.core import make_engine

    engine = make_engine(model, dataclasses.replace(tp_gen_config(cfg), gen_length=TP_GEN_B),
                         device="cuda")
    with CrossLaunches(model) as cl:
        out = engine.generate(torch.from_numpy(tp_prompt(cfg)).cuda(), enc_embeds=tp_enc(cfg))
    return dict(tokens=out.cpu().numpy(), conf=engine.last_state.conf.cpu().numpy(),
                kernel1_cross=cl.cross, kernel1_encoder=cl.encoder)


def tp_served_trace(model, gen_cfg, kernel_fns) -> dict:
    """Phase 6's trace cut to ``TP_SERVE_REQUESTS`` on the paged pool, timed,
    with the device ms inside the all-reduces (CUDA events)."""
    import numpy as np

    from repro_torch.runtime import StreamScheduler
    from repro_torch.sharding.comm import COUNTER

    cfg = model.cfg
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32) for n in LENS_13A]
    prompts = [prompts[i] for i in TP_SERVE_REQUESTS]
    max_new = [SERVE_MAX_NEW[i] for i in TP_SERVE_REQUESTS]
    sched = StreamScheduler(model, gen_cfg, device="cuda", max_slots=SLOTS,
                            prompt_len=PROMPT, paged=True, page_size=16, early_advance=True)
    zero_counts(kernel_fns)
    COUNTER.reset()
    COUNTER.timing = True
    t0 = time.perf_counter()
    reqs = serve_trace(sched, prompts, max_new, every=5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    coll_ms = COUNTER.device_ms()
    COUNTER.timing = False
    steps = sched.stats.steps
    n_ar, ar_bytes = sum(COUNTER.count_by_kind.values()), sum(COUNTER.bytes_by_kind.values())
    return dict(outputs=[r.output for r in reqs], steps=steps, wall_s=wall,
                ms_per_step=wall / steps * 1e3, tokens_per_s=sum(max_new) / wall,
                resident_peak=sched.stats.resident_peak,
                launches=counts(kernel_fns), all_reduce_per_step=n_ar / steps,
                all_reduce_bytes_per_step=ar_bytes / steps,
                all_reduce_by_site=dict(COUNTER.count_by_site),
                all_reduce_device_ms=coll_ms, all_reduce_device_ms_per_step=coll_ms / steps,
                passes=dict(sched.engine.pass_counts))


def tp_timed_block(model, gen_cfg, kernel_fns) -> dict:
    """A timed one-block offline ``generate`` (the process is warm) with its
    launches and its all-reduces and bytes by site."""
    from repro_torch.core import make_engine
    from repro_torch.sharding.comm import COUNTER

    cfg = model.cfg
    engine = make_engine(model, dataclasses.replace(gen_cfg, gen_length=TP_GEN_B),
                         device="cuda")
    prompt = torch.from_numpy(tp_prompt(cfg)).cuda()
    zero_counts(kernel_fns)
    COUNTER.reset()
    t0 = time.perf_counter()
    b = engine.generate(prompt, enc_embeds=tp_enc(cfg))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(tokens=b.cpu().numpy(), wall_s=wall, iterations=engine.iterations,
                launches=counts(kernel_fns), all_reduce=dict(COUNTER.count_by_site),
                all_reduce_bytes=dict(COUNTER.bytes_by_site))


def tp_state_bytes(model, gen_cfg) -> int:
    """Bytes of the offline state at ``TP_DRYRUN_SHAPE`` (what the dry run's
    ``argument_size`` counts beside the parameters)."""
    from repro_torch.core import make_engine

    engine = make_engine(model, gen_cfg, device="cuda")
    state = engine.make_block_state(torch.zeros(TP_DRYRUN_SHAPE[::-1], dtype=torch.int32,
                                                device="cuda"))
    return nbytes(*[t for t in torch.utils._pytree.tree_leaves(state) if torch.is_tensor(t)])


def tp17_rank(mesh, kernel_fns) -> dict:
    """Phase 17 on one rank: 17a's f32 generate at ``TP_DEPTH_A`` layers;
    17b's bf16 model at ``TP_DEPTH_B`` layers, an idle all-reduce's time, a
    timed one-block generate, phase 6's trace cut to three requests, the
    bytes of the rank's parameters and of the state the dry run is held to
    (17c)."""
    from repro_torch import configs
    from repro_torch.launch.tp import build_model

    out = {}
    cfg = tp_cfg("llada-8b", "float32", TP_DEPTH_A)
    out["a"] = tp_one_block(build_model(cfg, mesh, "cuda", seed=SEED), cfg)
    torch.cuda.empty_cache()
    cfg = tp_cfg("llada-8b", "bfloat16", TP_DEPTH_B)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, mesh, "cuda", seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen_cfg = tp_gen_config(cfg)
    # the idle all-reduce of a served step's hidden states, [4, 32, 4096] bf16
    x = torch.zeros((SLOTS, BLOCK, cfg.d_model), dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        model.tp.all_reduce_sum(x, "idle")
    torch.cuda.synchronize()
    idle_ms = (time.perf_counter() - t0) / 20 * 1e3
    serve_cfg = configs.GenerationConfig(
        mode="es", gen_length=GEN, block_length=BLOCK,
        skip_stages=configs.default_skip_stages(cfg.n_layers),
        prompt_refresh_period=8, block_refresh_period=4, cache_prompt_interval=2)
    out["b"] = dict(offline=tp_timed_block(model, gen_cfg, kernel_fns),
                    served=tp_served_trace(model, serve_cfg, kernel_fns), init_s=init_s,
                    params_bytes=nbytes(*model.parameters()),
                    state_bytes=tp_state_bytes(model, gen_cfg), all_reduce_idle_ms=idle_ms,
                    max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                    local_heads=model.layers[0].attn.wq.shape[1] // cfg.head_dim,
                    local_kv_heads=model.layers[0].attn.wk.shape[1] // cfg.head_dim)
    return out


def tp18_rank(mesh, kernel_fns) -> dict:
    """Phase 18 on one rank: 18a's f32 generates of ``TP_PARITY_18`` with
    their all-reduces by site; 18b's bf16 Jamba at ``DEPTH_14`` layers, a
    timed one-block generate, phase 6's trace cut to three requests, the
    rank's memory, heads and bytes (18c)."""
    from repro_torch.launch.tp import build_model
    from repro_torch.sharding.comm import COUNTER

    out = {"a": {}}
    for arch, depth in TP_PARITY_18:
        cfg = tp_cfg(arch, "float32", depth)
        model = build_model(cfg, mesh, "cuda", seed=SEED)
        zero_counts(kernel_fns)
        COUNTER.reset()
        out["a"][arch] = dict(tp_one_block(model, cfg), launches=counts(kernel_fns),
                              all_reduce=dict(COUNTER.count_by_site))
        del model
        torch.cuda.empty_cache()
    cfg = tp_cfg(JAMBA, "bfloat16", DEPTH_14)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, mesh, "cuda", seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen_cfg = tp_gen_config(cfg)
    mixer = model.layers[model.ssm_layers[0]].mixer
    out["b"] = dict(offline=tp_timed_block(model, gen_cfg, kernel_fns),
                    served=tp_served_trace(model, arch_gen_config(cfg, served=True), kernel_fns),
                    init_s=init_s, params_bytes=nbytes(*model.parameters()),
                    state_bytes=tp_state_bytes(model, gen_cfg),
                    max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                    local_ssm_heads=mixer.dt_proj.shape[1], local_d_inner=mixer.x_proj.shape[1],
                    local_heads=model.layers[model.attn_layers[0]].attn.wq.shape[1]
                    // cfg.head_dim)
    return out


def tp_rank_job(mesh) -> dict:
    """One rank of phases 17 and 18 (its own process, sharing the card):
    the kernels built once, then each phase's work, each freed before the
    next."""
    import gc

    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.library()
    kernel_fns = all_kernel_fns()
    out = {}
    for name, job in (("17", tp17_rank), ("18", tp18_rank)):
        t0 = time.perf_counter()
        out[name] = job(mesh, kernel_fns)
        gc.collect()
        torch.cuda.empty_cache()
        out[name]["rank_s"] = time.perf_counter() - t0
    return out


def tp1_one_block(arch: str, depth) -> dict:
    """TP 1 of a parity check: ``tp_one_block`` in this process, on the same
    seeded weights as the ranks'."""
    cfg = tp_cfg(arch, "float32", depth)
    model = seeded_model(cfg)
    out = tp_one_block(model, cfg)
    del model
    torch.cuda.empty_cache()
    return out


def phase17(kernel_fns) -> tuple[dict, dict]:
    """Tensor parallelism at TP 2: two processes on the one card, one rank
    each, over gloo (its ``all_reduce`` takes CUDA tensors through the host;
    NCCL refuses two ranks on one card), every kernel launch in the ranks
    on the card.  The ranks run phase 17's work and phase 18's
    (``phase18`` checks it).  17a: LLaDA-8B at full width, ``TP_DEPTH_A``
    layers, f32, offline es greedy: both ranks' tokens equal, and equal to
    TP 1's (this process, the same seeded weights).  17b: LLaDA-8B at
    ``TP_DEPTH_B`` layers, bf16: one offline generate of one block and phase
    6's served trace cut to three requests (``TP_GEN_B``,
    ``TP_SERVE_REQUESTS``: times, memory, all-reduces and their device time:
    gloo through the host on one card, not a multi-card figure).  17c: the
    dry run of 17b's configuration at TP 2 (``launch/dryrun.py``, fake
    tensors) beside rank 0's measured bytes of parameters and state, and the
    single-pod dry run of llada-8b and dream-7b at decode_32k.  Returns
    (phase 17's record, phase 18's inputs: its TP-1 runs and the ranks')."""
    import numpy as np

    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.tp import spawn

    t0 = time.perf_counter()
    tp1 = tp1_one_block("llada-8b", TP_DEPTH_A)
    tp1_18 = {arch: tp1_one_block(arch, depth) for arch, depth in TP_PARITY_18}
    tp1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tp17_", dir=ROOT / "build") as work:
        ranks = spawn(tp_rank_job, TP, workdir=work)
    ranks_s = time.perf_counter() - t0
    a = [r["17"]["a"] for r in ranks]
    b = [r["17"]["b"] for r in ranks]
    if not all(np.array_equal(r["tokens"], a[0]["tokens"]) for r in a):
        raise AssertionError("phase 17a: the ranks' tokens differ")
    diff = int((a[0]["tokens"] != tp1["tokens"]).sum())
    if diff:
        raise AssertionError(f"phase 17a: TP {TP} tokens differ from TP 1's at {diff} positions")
    if not all(np.array_equal(r["offline"]["tokens"], b[0]["offline"]["tokens"]) for r in b):
        raise AssertionError("phase 17b: the ranks' offline tokens differ")
    check_tp_served(b, "phase 17b")
    cfg = tp_cfg("llada-8b", "bfloat16", TP_DEPTH_B)
    gen_tok = b[0]["offline"]["tokens"][:, PROMPT:]
    if gen_tok.shape != (2, TP_GEN_B) or not ((gen_tok >= 0)
                                              & (gen_tok < cfg.vocab_size)).all():
        raise AssertionError(f"phase 17b: generated ids {gen_tok}")
    for name in ("flash_attention", "scatter_rows", "importance"):
        if b[0]["offline"]["launches"][name] <= 0:
            raise AssertionError(f"phase 17b: {name} not launched on the offline path")
    for name in ("paged_flash_attention", "scatter_rows_paged", "importance", "variation"):
        if b[0]["served"]["launches"][name] <= 0:
            raise AssertionError(f"phase 17b: {name} not launched on the served path")
    # 17c: the dry run of 17b's configuration beside rank 0's bytes
    t0 = time.perf_counter()
    dry = dryrun.run_one("llada-8b", "phase17", "debug", debug=(1, TP), cfg=cfg,
                         shape=InputShape("phase17_decode", *TP_DRYRUN_SHAPE, "decode"),
                         gen=tp_gen_config(cfg), verbose=False)
    measured = b[0]["params_bytes"] + b[0]["state_bytes"]
    if dry["memory"]["argument_size"] != measured:
        raise AssertionError(f"phase 17c: dry-run argument_size {dry['memory']['argument_size']}"
                             f" != measured {measured}")
    single = {arch: dryrun.run_one(arch, "decode_32k", "single", verbose=False)
              for arch in ("llada-8b", "dream-7b")}
    end_dry_run_group()
    dry_s = time.perf_counter() - t0
    rec = dict(tp=TP, backend="gloo", depth_a=TP_DEPTH_A, depth_b=TP_DEPTH_B, tp1_s=tp1_s,
               ranks_s=ranks_s, rank_s=[r["17"]["rank_s"] for r in ranks], dryrun_s=dry_s,
               a=dict(tokens_equal_tp1=True, ranks_equal=True,
                      conf_max_abs_diff=float(np.abs(a[0]["conf"] - tp1["conf"]).max()),
                      distinct_ids=len(np.unique(tp1["tokens"][:, PROMPT:]))),
               b=[served_summary(r) for r in b],
               c=dict(dryrun=dry, measured_bytes=measured, single=single))
    return rec, dict(tp1=tp1_18, ranks=[r["18"] for r in ranks])


def check_tp_served(b: list, where: str) -> None:
    """Every rank served the same tokens, three requests of one block, with
    more than one live at once."""
    import numpy as np

    for r in b[1:]:
        if not all(np.array_equal(x, y) for x, y in zip(r["served"]["outputs"],
                                                        b[0]["served"]["outputs"])):
            raise AssertionError(f"{where}: the ranks' served tokens differ")
    outs = b[0]["served"]["outputs"]
    if len(outs) != len(TP_SERVE_REQUESTS) or any(r is None or r.shape != (BLOCK,)
                                                  for r in outs):
        raise AssertionError(f"{where}: served outputs {outs}")
    if b[0]["served"]["resident_peak"] < 2:
        raise AssertionError(f"{where}: at most {b[0]['served']['resident_peak']} request "
                             f"live at once")


def served_summary(r: dict) -> dict:
    """A rank's record without its tokens."""
    return dict(r, offline={k: v for k, v in r["offline"].items() if k != "tokens"},
                served={k: v for k, v in r["served"].items() if k != "outputs"})


def end_dry_run_group() -> None:
    """Tears down the dry run's fake process group."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def phase18(inputs: dict) -> dict:
    """Tensor parallelism on the SSM, hybrid, cross-attention and encoder
    stacks, from the ranks phase 17 started.  18a: mamba2-370m (8 of 48
    layers) and seamless-m4t-large-v2 (uncut) in f32, offline es greedy, one
    block: both ranks' tokens equal, and equal to TP 1's, confidences within
    1e-4.  18b: jamba-v0.1-52b at ``DEPTH_14`` layers, bf16: one offline
    generate of one block and phase 6's trace cut to three requests (ranks
    equal; ``ssm`` and ``ssm_norm`` all-reduces once a mixer layer and pass;
    kernel 8 at the rank's 64 of 128 SSM heads, every SSD launch on the
    tensor-core body; kernels 1, 3, 6 offline, 2, 4, 6 served).  18c: the
    dry run of 18b's configuration at TP 2 beside rank 0's measured bytes,
    and the single-pod dry runs of jamba-v0.1-52b at all 32 layers and
    llama-3.2-vision-11b at decode_32k."""
    import numpy as np

    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun

    ranks, tp1 = inputs["ranks"], inputs["tp1"]
    a = {}
    for arch, depth in TP_PARITY_18:
        got = [r["a"][arch] for r in ranks]
        if not all(np.array_equal(g["tokens"], got[0]["tokens"]) for g in got):
            raise AssertionError(f"phase 18a {arch}: the ranks' tokens differ")
        diff = int((got[0]["tokens"] != tp1[arch]["tokens"]).sum())
        if diff:
            raise AssertionError(f"phase 18a {arch}: TP {TP} tokens differ from TP 1's at "
                                 f"{diff} positions")
        conf = float(np.abs(got[0]["conf"] - tp1[arch]["conf"]).max())
        if not conf <= 1e-4:
            raise AssertionError(f"phase 18a {arch}: confidences {conf} from TP 1's")
        cfg = tp_cfg(arch, "float32", depth)
        c = got[0]["all_reduce"]
        n_ssm = sum(cfg.layer_kind(l) == "ssm" for l in range(cfg.n_layers))
        if c.get("ssm", 0) != n_ssm * c["embed"] or c.get("ssm_norm", 0) != n_ssm * c["embed"]:
            raise AssertionError(f"phase 18a {arch}: all-reduces {c}")
        if cfg.n_encoder_layers and (got[0]["kernel1_cross"] <= 0
                                     or got[0]["kernel1_encoder"] <= 0):
            raise AssertionError(f"phase 18a {arch}: kernel 1 as cross-attention "
                                 f"{got[0]['kernel1_cross']}, in the encoder "
                                 f"{got[0]['kernel1_encoder']}")
        a[arch] = dict(layers=cfg.n_layers, tokens_equal_tp1=True, ranks_equal=True,
                       conf_max_abs_diff=conf, all_reduce=c, launches=got[0]["launches"],
                       kernel1_cross=got[0]["kernel1_cross"],
                       kernel1_encoder=got[0]["kernel1_encoder"],
                       distinct_ids=len(np.unique(got[0]["tokens"][:, PROMPT:])))
    b = [r["b"] for r in ranks]
    if not all(np.array_equal(r["offline"]["tokens"], b[0]["offline"]["tokens"]) for r in b):
        raise AssertionError("phase 18b: the ranks' offline tokens differ")
    check_tp_served(b, "phase 18b")
    cfg = tp_cfg(JAMBA, "bfloat16", DEPTH_14)
    gen_tok = b[0]["offline"]["tokens"][:, PROMPT:]
    if gen_tok.shape != (2, TP_GEN_B) or not ((gen_tok >= 0)
                                              & (gen_tok < cfg.vocab_size)).all():
        raise AssertionError(f"phase 18b: generated ids {gen_tok}")
    n_ssm = sum(cfg.layer_kind(l) == "ssm" for l in range(cfg.n_layers))
    for where, c in (("offline", b[0]["offline"]["all_reduce"]),
                     ("served", b[0]["served"]["all_reduce_by_site"])):
        if not c["ssm"] == c["ssm_norm"] == n_ssm * c["embed"]:
            raise AssertionError(f"phase 18b {where}: all-reduces {c}, not {n_ssm} ssm and "
                                 f"ssm_norm a pass")
    if b[0]["local_ssm_heads"] != JAMBA_SSD[0] // TP:
        raise AssertionError(f"phase 18b: {b[0]['local_ssm_heads']} SSM heads a rank")
    for name in ("flash_attention", "scatter_rows", "importance", "ssd_chunks"):
        if b[0]["offline"]["launches"][name] <= 0:
            raise AssertionError(f"phase 18b: {name} not launched on the offline path")
    # variation runs only with the adaptive cache, which stacks with SSM
    # layers refuse (as the reference does)
    for name in ("paged_flash_attention", "scatter_rows_paged", "importance", "ssd_chunks"):
        if b[0]["served"]["launches"][name] <= 0:
            raise AssertionError(f"phase 18b: {name} not launched on the served path")
    for where in ("offline", "served"):
        check_tensor_core_path(b[0][where]["launches"], f"phase 18b {where}")
        check_ssd_tensor_core_path(b[0][where]["launches"], f"phase 18b {where}")
    # 18c: the dry run of 18b's configuration beside rank 0's bytes
    t0 = time.perf_counter()
    dry = dryrun.run_one(JAMBA, "phase18", "debug", debug=(1, TP), cfg=cfg,
                         shape=InputShape("phase18_decode", *TP_DRYRUN_SHAPE, "decode"),
                         gen=tp_gen_config(cfg), verbose=False)
    measured = b[0]["params_bytes"] + b[0]["state_bytes"]
    if dry["memory"]["argument_size"] != measured:
        raise AssertionError(f"phase 18c: dry-run argument_size {dry['memory']['argument_size']}"
                             f" != measured {measured}")
    single = {arch: dryrun.run_one(arch, "decode_32k", "single", verbose=False)
              for arch in (JAMBA, VLM)}
    end_dry_run_group()
    for arch, d in single.items():
        if "unsupported" in d:
            raise AssertionError(f"phase 18c: {arch} decode_32k single: {d['unsupported']}")
    return dict(tp=TP, backend="gloo", depth_b=DEPTH_14, dryrun_s=time.perf_counter() - t0,
                rank_s=[r["rank_s"] for r in ranks], a=a, b=[served_summary(r) for r in b],
                c=dict(dryrun=dry, measured_bytes=measured, single=single))


def seeded_model(cfg):
    """``cfg``'s model on the card, its weights from the seeded generator."""
    from repro_torch.models import Model

    return Model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(SEED))


def report_tp_rank(phase: str, rank: int, b: dict, layers: int, heads: str) -> None:
    off, srv = b["offline"], b["served"]
    print(f"phase {phase} rank {rank} (bf16, {layers} layers, {heads}): max_memory_allocated "
          f"{b['max_memory_allocated_gb']:.2f} GB, params {b['params_bytes'] / 1e9:.2f} GB, "
          f"init {b['init_s']:.1f} s"
          + (f"; idle all-reduce {b['all_reduce_idle_ms']:.2f} ms" if "all_reduce_idle_ms" in b
             else "")
          + f"; generate of {TP_GEN_B} tokens {off['wall_s']:.2f} s "
          f"({off['iterations']} iterations, all-reduces {json.dumps(off['all_reduce'])}, "
          f"bytes {json.dumps(off['all_reduce_bytes'])}); "
          f"served ({len(TP_SERVE_REQUESTS)} requests, {srv['resident_peak']} live at "
          f"most) {srv['steps']} steps at {srv['ms_per_step']:.1f} ms, "
          f"{srv['tokens_per_s']:.1f} tok/s, {srv['all_reduce_per_step']:.1f} all-reduces and "
          f"{srv['all_reduce_bytes_per_step'] / 1e6:.2f} MB a step, "
          f"{srv['all_reduce_device_ms_per_step']:.2f} ms a step inside them (CUDA events); "
          f"launches offline {json.dumps({k: v for k, v in off['launches'].items() if v})}, "
          f"served {json.dumps({k: v for k, v in srv['launches'].items() if v})}")


def report_single(phase: str, single: dict) -> None:
    for arch, d in single.items():
        if "unsupported" in d:
            print(f"phase {phase}: {arch} decode_32k single: unsupported ({d['unsupported']})")
        else:
            print(f"phase {phase}: {arch} decode_32k single ({d['n_chips']} ranks): flops "
                  f"{d['flops']:.3e}, argument_size {d['memory']['argument_size'] / 2**30:.2f} "
                  f"GiB, temp {d['memory']['temp_size'] / 2**30:.2f} GiB, all-reduces "
                  f"{d['collectives']['total_count']} ({d['collectives']['total_bytes']:.3e} B)"
                  f" by site {json.dumps(d['collectives_by_site']['count'])}")


def report17(r: dict) -> None:
    print(f"phase 17: TP {r['tp']} over {r['backend']}, two ranks on one card (times are gloo "
          f"through the host on one card, not a multi-card figure); TP 1 of 17a and 18a "
          f"{r['tp1_s']:.1f} s, ranks {r['ranks_s']:.1f} s (phase 17's work "
          f"{json.dumps([round(x, 1) for x in r['rank_s']])} s), dry runs {r['dryrun_s']:.1f} s")
    a = r["a"]
    print(f"phase 17a (f32, {r['depth_a']} layers): tokens equal TP 1's {a['tokens_equal_tp1']}, "
          f"ranks equal {a['ranks_equal']}, final-block confidences within "
          f"{a['conf_max_abs_diff']:.2e} of TP 1's, {a['distinct_ids']} distinct ids")
    for rank, b in enumerate(r["b"]):
        report_tp_rank("17b", rank, b, r["depth_b"], f"{b['local_heads']} heads and "
                       f"{b['local_kv_heads']} KV heads a rank")
    c = r["c"]
    mem = c["dryrun"]["memory"]
    print(f"phase 17c: dry run of 17b's TP-2 decode step: argument_size {mem['argument_size']} "
          f"= rank 0's measured {c['measured_bytes']}, temp_size {mem['temp_size']}, flops "
          f"{c['dryrun']['flops']:.3e}, all-reduces {c['dryrun']['collectives']['total_count']} "
          f"({c['dryrun']['collectives']['total_bytes']} B)")
    report_single("17c", c["single"])


def report18(r: dict) -> None:
    print(f"phase 18: TP {r['tp']} over {r['backend']} (phase 17's ranks; phase 18's work "
          f"{json.dumps([round(x, 1) for x in r['rank_s']])} s a rank), dry runs "
          f"{r['dryrun_s']:.1f} s")
    for arch, a in r["a"].items():
        print(f"phase 18a {arch} (f32, {a['layers']} layers): tokens equal TP 1's "
              f"{a['tokens_equal_tp1']}, ranks equal {a['ranks_equal']}, final-block "
              f"confidences within {a['conf_max_abs_diff']:.2e} of TP 1's, {a['distinct_ids']} "
              f"distinct ids; all-reduces {json.dumps(a['all_reduce'])}; kernel 1 as "
              f"cross-attention {a['kernel1_cross']}, in the encoder {a['kernel1_encoder']}")
    for rank, b in enumerate(r["b"]):
        report_tp_rank("18b", rank, b, r["depth_b"], f"{b['local_ssm_heads']} SSM heads "
                       f"({b['local_d_inner']} channels) and {b['local_heads']} query heads a "
                       f"rank")
    c = r["c"]
    mem = c["dryrun"]["memory"]
    print(f"phase 18c: dry run of 18b's TP-2 decode step: argument_size {mem['argument_size']} "
          f"= rank 0's measured {c['measured_bytes']}, temp_size {mem['temp_size']}, flops "
          f"{c['dryrun']['flops']:.3e}, all-reduces by site "
          f"{json.dumps(c['dryrun']['collectives_by_site']['count'])}")
    report_single("18c", c["single"])


# ---------------------------------------------------------------------------
# phase 19: training under FSDP x TP, four gloo ranks sharing the card
# ---------------------------------------------------------------------------
FSDP_MESH = (2, 2)                     # (data, model)
# 19a and 19b: full width, cut in depth to fit the phase's 60 s (PERF.md §4)
FSDP_ARCHS = (("qwen2-1.5b", 4), ("mamba2-370m", 4))
FSDP_TRAIN = dict(steps=2, batch=4, seq=256, ce_chunk=128, lr=1e-3)


def fsdp_steps(model, cfg, kernel_fns, masks: dict | None = None, *,
               ce_chunk: int | None = None, eps: float | None = None) -> dict:
    """``FSDP_TRAIN``'s train steps on ``model`` (a rank's shards, or TP 1
    whole) from ``SEED``'s key and batches: each step's loss, grad norm and
    seconds (host clock, synchronized at both ends), its collectives by kind
    and site with their bytes and device ms (CUDA events); no hand-written
    kernel may launch.  With ``masks`` (TP 1), ``masks[name]`` is set to
    where every step's gradient of parameter ``name`` is at least 1e-4 of
    its largest |g| and its clipped gradient at least ``100 eps``.  Also the
    bytes of the step's arguments: parameters, moments, key and the rank's
    rows of the batch.  ``ce_chunk`` and ``eps`` replace ``FSDP_TRAIN``'s
    CE chunk and AdamW's eps (phase 19's witness)."""
    from repro_torch.core import prng
    from repro_torch.sharding.comm import COUNTER
    from repro_torch.train import (
        DataConfig,
        OptimizerConfig,
        SyntheticTextDataset,
        TrainState,
        init_opt_state,
        make_train_step,
    )
    from repro_torch.train.optimizer import clip_scale

    t = FSDP_TRAIN
    opt = OptimizerConfig(lr=t["lr"], warmup_steps=1, total_steps=t["steps"])
    if eps is not None:
        opt = dataclasses.replace(opt, eps=eps)
    step = make_train_step(model, opt, ce_chunk=ce_chunk or t["ce_chunk"])
    state = TrainState(model, init_opt_state(model), prng.prng_key(SEED, device="cuda"))
    ds = SyntheticTextDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=t["seq"],
                                         global_batch=t["batch"], seed=SEED))
    rows = t["batch"] // (1 if model.dp is None else model.dp.batch_size)
    out = dict(losses=[], grad_norms=[], step_s=[], collectives=[],
               arg_bytes=nbytes(*model.parameters(), *state.opt.mu.values(),
                                *state.opt.nu.values(), state.key)
               + rows * t["seq"] * (4 + 1))           # int32 tokens, bool loss region
    zero_counts(kernel_fns)
    for _ in range(t["steps"]):
        batch = ds.next_batch()
        COUNTER.reset()
        COUNTER.timing = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        COUNTER.timing = False
        out["collectives"].append(dict(
            count={k: dict(v) for k, v in COUNTER.count_by_kind_site.items()},
            bytes=dict(COUNTER.bytes_by_site),
            device_ms=COUNTER.device_ms_by_site()))
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        if masks is not None:
            clip = float(clip_scale(m["grad_norm"], opt.grad_clip))
            for name, p in model.named_parameters():
                g = p.grad.abs()
                big = (g >= 1e-4 * g.max()) & (g * clip >= 100 * opt.eps)
                masks[name] = big if name not in masks else masks[name] & big
    launched = {k: v for k, v in counts(kernel_fns).items() if v}
    if launched:
        raise AssertionError(f"phase 19: training launched kernels {launched}")
    return out


def fsdp_metric_rtol(name: str, step: int) -> float:
    """Phase 19's relative bound on a step's loss or grad norm against TP
    1's: 1e-5, but 1e-4 on the grad norm after the first step.  From equal
    parameters the two differ only in the order of f32 additions (the sums
    over the ranks, the card's GEMMs at a rank's shapes), but step 2's
    gradient is taken at parameters AdamW has moved: an element whose
    clipped gradient is near its eps (1e-8) moves by ``lr g / (|g| + eps)``,
    so a rounding difference of its gradient moves it, and the gradient at
    step 2 follows.  ``fsdp_witness`` shows it without the mesh: TP 1
    against TP 1 with only the CE's order of additions changed, at eps and
    at eps raised."""
    return 1e-4 if name == "grad_norms" and step > 0 else 1e-5


def fsdp_witness(kernel_fns, base: dict) -> dict:
    """Where the step-2 gap of ``fsdp_metric_rtol`` comes from, on 19a's
    model at TP 1: ``base`` (``fsdp_steps`` at ``FSDP_TRAIN``) against the
    same steps with CE chunks of 256 (which changes only the order in which
    the head's weight gradient adds the chunks), and both again with AdamW's
    eps raised to 1e-6.  Returns the relative gaps of each step's loss and
    grad norm at each eps."""
    arch, depth = FSDP_ARCHS[0]
    cfg = tp_cfg(arch, "float32", depth)

    def run(**kw) -> dict:
        model = seeded_model(cfg)
        out = fsdp_steps(model, cfg, kernel_fns, **kw)
        del model
        torch.cuda.empty_cache()
        return out

    def gaps(x: dict, y: dict) -> dict:
        return {name: [abs(a - b) / abs(b) for a, b in zip(x[name], y[name])]
                for name in ("losses", "grad_norms")}
    raised = run(eps=1e-6)
    return {"1e-08": gaps(run(ce_chunk=256), base),
            "1e-06": gaps(run(ce_chunk=256, eps=1e-6), raised)}


def fsdp_param_errs(got: dict, want: dict, masks: dict) -> dict:
    """19a's and 19b's bound on the parameters after the two steps (flat
    trees of numpy arrays, the reference's paths), as the CPU tests state
    it against the reference: every element within ``4 lr`` of TP 1's (an
    AdamW update is at most 1 at step 1 and 1.0007 at step 2, so a sign
    flipped by rounding moves an element by at most that), and every
    element whose gradient at each step was at least 1e-4 of its
    parameter's largest |g| and whose clipped gradient was at least
    ``100 eps`` within ``1e-2 lr`` (``well_set_share`` of the elements).
    Returns the largest error of each kind."""
    import numpy as np

    lr = FSDP_TRAIN["lr"]
    worst = dict(all=0.0, well_set=0.0, well_set_share=0.0)
    n = n_set = 0
    for path, w in want.items():
        err = np.abs(got[path] - w)
        worst["all"] = max(worst["all"], float(err.max(initial=0)))
        worst["well_set"] = max(worst["well_set"], float(err[masks[path]].max(initial=0)))
        n, n_set = n + err.size, n_set + int(masks[path].sum())
    worst["well_set_share"] = n_set / n
    if not (worst["all"] <= 4 * lr and worst["well_set"] <= 1e-2 * lr):
        raise AssertionError(f"phase 19: parameters after two steps {worst} from TP 1's")
    return worst


def fsdp_rank_job(mesh, tp1_dir: str) -> dict:
    """One rank of phase 19 (its own process, sharing the card): for each of
    ``FSDP_ARCHS``, the rank's shards of the seeded weights, the two steps,
    its memory, a digest of every gathered leaf and of each of its shards;
    on rank 0 the gathered parameters against TP 1's (from ``tp1_dir``)."""
    import hashlib

    import numpy as np
    import torch.distributed as dist

    from repro_torch.convert import params_to_numpy
    from repro_torch.launch.tp import build_model
    from repro_torch.sharding import specs
    from repro_torch.utils.tree import flatten_with_paths

    kernel_fns = all_kernel_fns()
    out = {}
    for arch, depth in FSDP_ARCHS:
        cfg = tp_cfg(arch, "float32", depth)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = build_model(cfg, mesh, "cuda", seed=SEED, mode="train")
        torch.cuda.synchronize()
        run = dict(init_s=time.perf_counter() - t0, coords=specs.mesh_coords(mesh),
                   full_shapes={n: shape for n, (shape, _) in model.fsdp.layout.items()})
        run.update(fsdp_steps(model, cfg, kernel_fns))
        run["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
        run["shard_digest"] = {n: hashlib.sha1(p.detach().cpu().numpy().tobytes()).hexdigest()
                               for n, p in model.named_parameters()}
        t0 = time.perf_counter()
        tree = flatten_with_paths(params_to_numpy(model))
        run["gather_s"] = time.perf_counter() - t0
        run["digest"] = {k: hashlib.sha1(a.tobytes()).hexdigest() for k, a in tree.items()}
        if dist.get_rank() == 0:
            with np.load(Path(tp1_dir) / f"{arch}.npz") as f:
                want = {k: f[k] for k in tree}
                masks = {k: f["mask:" + k] for k in tree}
            run["vs_tp1"] = fsdp_param_errs(tree, want, masks)
        out[arch] = run
        del model, tree
        torch.cuda.empty_cache()
    return out


def phase19(kernel_fns) -> dict:
    """Training under FSDP x TP over ``FSDP_MESH``: four gloo ranks on the
    one card (NCCL refuses two ranks on one card).  TP 1 first, in this
    process, on the same seeded weights: its two steps, then its final
    parameters and gradient masks written for rank 0 into a directory that
    is removed once the ranks return; ``fsdp_witness``; then the ranks (19a,
    19b) and the dry run of 19a's step (19c: its bytes and its collectives
    by kind and site against rank 0's).  Raises where a check fails."""
    import numpy as np

    from repro_torch.configs import InputShape
    from repro_torch.convert import params_to_numpy, restack
    from repro_torch.launch import dryrun
    from repro_torch.launch.tp import spawn
    from repro_torch.utils.tree import flatten_with_paths

    work = Path(tempfile.mkdtemp(prefix="fsdp19_", dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        tp1 = {}
        for arch, depth in FSDP_ARCHS:
            cfg = tp_cfg(arch, "float32", depth)
            model = seeded_model(cfg)
            masks: dict = {}
            tp1[arch] = fsdp_steps(model, cfg, kernel_fns, masks)
            arrays = flatten_with_paths(params_to_numpy(model))
            arrays.update({"mask:" + k: v for k, v in flatten_with_paths(
                restack(model, lambda n: masks[n].cpu().numpy())).items()})
            np.savez(work / f"{arch}.npz", **arrays)
            del model, masks, arrays
            torch.cuda.empty_cache()
        tp1_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        witness = fsdp_witness(kernel_fns, tp1[FSDP_ARCHS[0][0]])
        witness_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = spawn(fsdp_rank_job, math.prod(FSDP_MESH), (str(work),),
                      workdir=work / "ranks", mesh_shape=FSDP_MESH)
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rec = dict(mesh=dict(zip(("data", "model"), FSDP_MESH)), backend="gloo", tp1_s=tp1_s,
               ranks_s=ranks_s, witness_s=witness_s, witness=witness, train=FSDP_TRAIN,
               runs={})
    for (arch, depth), part in zip(FSDP_ARCHS, "ab"):
        got = [r[arch] for r in ranks]
        for name in ("losses", "grad_norms"):
            for i, (x, y) in enumerate(zip(got[0][name], tp1[arch][name])):
                if not abs(x - y) <= fsdp_metric_rtol(name, i) * abs(y):
                    raise AssertionError(f"phase 19{part} {arch}: {name} {got[0][name]} at "
                                         f"(2, 2), {tp1[arch][name]} at TP 1")
        if any(g[name] != got[0][name] for g in got for name in ("losses", "grad_norms")):
            raise AssertionError(f"phase 19{part} {arch}: the ranks' metrics differ")
        if any(g["digest"] != got[0]["digest"] for g in got):
            raise AssertionError(f"phase 19{part} {arch}: the ranks' gathered parameters differ")
        shared = fsdp_shared_pieces(tp_cfg(arch, "float32", depth), got)
        rec["runs"][arch] = dict(
            part=part, layers=depth, tp1=tp1[arch], vs_tp1=got[0]["vs_tp1"],
            pieces_held_by_several_ranks=shared,
            ranks=[{k: v for k, v in g.items() if k not in ("digest", "shard_digest",
                                                            "vs_tp1", "full_shapes")}
                   for g in got])
    # 19c: the dry run of 19a's configuration beside rank 0's bytes
    t0 = time.perf_counter()
    arch, depth = FSDP_ARCHS[0]
    t = FSDP_TRAIN
    dry = dryrun.run_one(arch, "phase19", "debug", debug=FSDP_MESH,
                         cfg=tp_cfg(arch, "float32", depth), verbose=False,
                         shape=InputShape("phase19_train", t["seq"], t["batch"], "train"),
                         ce_chunk=t["ce_chunk"])
    end_dry_run_group()
    measured = ranks[0][arch]["arg_bytes"]
    if dry["memory"]["argument_size"] != measured:
        raise AssertionError(f"phase 19c: dry-run argument_size {dry['memory']['argument_size']}"
                             f" != measured {measured}")
    real = ranks[0][arch]["collectives"][-1]["count"]
    if dry["collectives_by_site"]["count_by_kind"] != real:
        raise AssertionError(f"phase 19c: dry-run collectives "
                             f"{dry['collectives_by_site']['count_by_kind']} != rank 0's {real}")
    rec["c"] = dict(dryrun=dry, measured_bytes=measured, dryrun_s=time.perf_counter() - t0)
    return rec


def fsdp_shared_pieces(cfg, got: list) -> int:
    """The ranks that hold one piece of a leaf hold the same bits
    (``shard_digest``): raises where two differ; returns how many such
    pairs were compared."""
    from repro_torch.sharding import specs

    sizes = dict(zip(("data", "model"), FSDP_MESH))
    shared = 0
    for name, shape in got[0]["full_shapes"].items():
        spec = specs.port_param_spec(name, shape, sizes, cfg.head_dim, mode="train",
                                     ssm=cfg.ssm)
        pieces: dict = {}
        for g in got:
            idx = specs.local_index(shape, spec, sizes, g["coords"])
            pieces.setdefault(tuple((s.start, s.stop) for s in idx), []).append(g)
        for holders in pieces.values():
            for g in holders[1:]:
                shared += 1
                if g["shard_digest"][name] != holders[0]["shard_digest"][name]:
                    raise AssertionError(f"phase 19: {name}: ranks {holders[0]['coords']} and "
                                         f"{g['coords']} hold one piece with other bits")
    return shared


def report19(r: dict) -> None:
    print(f"phase 19: training under FSDP x TP, mesh {json.dumps(r['mesh'])} over "
          f"{r['backend']}, four ranks on one card (times are gloo through the host, not a "
          f"multi-card figure); TP 1 {r['tp1_s']:.1f} s, witness {r['witness_s']:.1f} s, ranks "
          f"{r['ranks_s']:.1f} s, dry run {r['c']['dryrun_s']:.1f} s")
    print(f"phase 19 witness, {FSDP_ARCHS[0][0]} at TP 1, CE chunks of 256 against "
          f"{FSDP_TRAIN['ce_chunk']}, relative gaps by AdamW eps: {json.dumps(r['witness'])}")
    for arch, a in r["runs"].items():
        t1 = a["tp1"]
        print(f"phase 19{a['part']} {arch} (f32, {a['layers']} layers): losses "
              f"{a['ranks'][0]['losses']} (TP 1 {t1['losses']}), grad norms "
              f"{a['ranks'][0]['grad_norms']} (TP 1 {t1['grad_norms']}); parameters after "
              f"two steps vs TP 1 {json.dumps(a['vs_tp1'])}; {a['pieces_held_by_several_ranks']}"
              f" shared pieces bit-equal; TP 1 s a step {json.dumps(t1['step_s'])}")
        for rank, g in enumerate(a["ranks"]):
            c = g["collectives"][-1]
            print(f"phase 19{a['part']} rank {rank} {json.dumps(g['coords'])}: s a step "
                  f"{json.dumps([round(x, 3) for x in g['step_s']])}, max_memory_allocated "
                  f"{g['max_memory_allocated_gb']:.2f} GB, gather of the tree "
                  f"{g['gather_s']:.1f} s; step 2's collectives {json.dumps(c['count'])}, "
                  f"bytes by site {json.dumps(c['bytes'])}, device ms by site "
                  f"{json.dumps({k: round(v, 2) for k, v in c['device_ms'].items()})}")
    c = r["c"]
    mem = c["dryrun"]["memory"]
    print(f"phase 19c: dry run of 19a's train step at (2, 2): argument_size "
          f"{mem['argument_size']} = rank 0's measured {c['measured_bytes']}, temp_size "
          f"{mem['temp_size']}, flops {c['dryrun']['flops']:.3e}, collectives "
          f"{json.dumps(c['dryrun']['collectives']['count_by_kind'])} (by site = rank 0's)")


def profile_run(fn, top: int = 8) -> dict:
    """Where one run's time goes on the device: the share of the wall time
    some kernel was running, and the kernels with the most device time."""
    with Profiled(top) as p:
        fn()
    return p.result


class Profiled:
    """:func:`profile_run` over whatever runs between enter and exit (a
    window of a serving trace's steps), with the card synchronized at both
    ends; ``result`` holds the summary after the exit."""

    def __init__(self, top: int = 8):
        self.top, self.result = top, None

    def __enter__(self):
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.t0 = time.perf_counter()
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - self.t0) * 1e6
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.result = summarize_profile(self.prof, wall_us, self.top)


def summarize_profile(prof, wall_us: float, top: int) -> dict:
    """Read from the raw Kineto records: the profiler's own event list
    (``prof.events()``) builds a tree that takes minutes for a run of a
    million kernels."""
    cuda = torch.autograd.DeviceType.CUDA
    evs = [(e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3)
           for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((s, s + d) for _, s, d in evs):     # union of the kernels' intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict[str, list] = {}
    for name, _, d in evs:
        rec = by_name.setdefault(name[:60], [0.0, 0])
        rec[0] += d
        rec[1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    port: dict[str, list] = {}          # the port's kernels, by symbol and template arguments
    for name, _, d in evs:
        if "repro_torch" in name:
            key = name.replace("(anonymous namespace)::", "").split("(")[0].split("::")[-1]
            rec = port.setdefault(key, [0.0, 0])
            rec[0] += d
            rec[1] += 1
    scatter = [(us, c) for n, (us, c) in port.items() if n.startswith("scatter_rows_kernel")]
    return dict(profiled_wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                device_busy_share=busy / wall_us, kernels_launched=len(evs),
                top=[dict(name=n, ms=us / 1e3, count=c) for n, (us, c) in ranked],
                port_kernels={n: dict(ms=us / 1e3, count=c) for n, (us, c) in port.items()},
                scatter_ms=sum(us for us, _ in scatter) / 1e3,
                scatter_launches=sum(c for _, c in scatter))


def all_kernel_fns() -> dict:
    """Every kernel wrapper by name: each counts its launches."""
    from repro_torch.kernels.flash_attention import flash_attention, paged_flash_attention
    from repro_torch.kernels.importance import importance, variation
    from repro_torch.kernels.scatter_kv import (
        fork_pages,
        quantize_scatter_rows,
        quantize_scatter_rows_paged,
        scatter_rows,
        scatter_rows_paged,
    )
    from repro_torch.kernels.ssd_scan import ssd_chunks

    return {"flash_attention": flash_attention, "paged_flash_attention": paged_flash_attention,
            "scatter_rows": scatter_rows, "scatter_rows_paged": scatter_rows_paged,
            "importance": importance, "variation": variation, "fork_pages": fork_pages,
            "ssd_chunks": ssd_chunks, "quantize_scatter_rows": quantize_scatter_rows,
            "quantize_scatter_rows_paged": quantize_scatter_rows_paged}


def main() -> int:
    # phase 1: environment
    smi = sh("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader")
    print(smi.splitlines()[0] if smi else "nvidia-smi: no card listed")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.flash_attention import flash_attention, paged_flash_attention
    from repro_torch.kernels.importance import importance, variation
    from repro_torch.kernels.scatter_kv import (
        fork_pages,
        quantize_scatter_rows,
        quantize_scatter_rows_paged,
        scatter_rows,
        scatter_rows_paged,
    )
    from repro_torch.kernels.ssd_scan import ssd_chunks

    print(sh(build.nvcc(), "--version").splitlines()[-1])
    try:
        import triton
        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton: not importable")
    kernel_fns = all_kernel_fns()

    phase_s: dict = {}                    # wall seconds of each phase
    t_phase = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        phase_s[name] = now - t_phase
        t_phase = now

    # phase 2: build
    lib_path, build_s = build.build()
    build.library()
    print(f"build: {lib_path.name} in {build_s:.1f} s")
    ptxas = [ln.strip() for ln in lib_path.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    print("\n".join(ptxas))
    lap("1-2")

    # phase 3: kernels vs plain versions
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = check_flash(ref, flash_attention, gen)
    cases += check_scatter(ref, scatter_rows, gen)
    cases += check_importance(ref, importance, gen)
    cases += check_paged_flash(ref, paged_flash_attention, gen)
    cases += check_paged_scatter(ref, scatter_rows_paged, gen)
    cases += check_variation(ref, variation, gen)
    cases += check_fork(ref, fork_pages, gen)
    cases += check_ssd(ref, ops, ssd_chunks, gen)
    cases += check_ssd_jamba(ref, ssd_chunks, gen)
    cases += check_flash_int8(ref, flash_attention, gen)
    cases += check_paged_flash_int8(ref, paged_flash_attention, gen)
    cases += check_quant_scatter(ref, ops, gen)
    cases += check_fork_scales(ref, fork_pages, gen)
    d256, scatter256 = check_head_dim_256(ref, flash_attention, paged_flash_attention, gen)
    cases += d256
    cases += check_cross(ref, flash_attention, gen)
    cases += check_tp_local(ref, kernel_fns, gen)
    print(f"timer: {len(TIMER_FALLBACKS)} incomplete profiler traces {TIMER_FALLBACKS[:20]}, "
          f"{len(EVENT_TIMED)} measurements timed by CUDA events")
    for c in cases:           # below the bound, the timer and not the kernel is at fault
        if c["ms"] < c["bound_ms"]:
            raise AssertionError(f"{c['kernel']} {c['case']} {c['dtype']}: {c['ms']} ms is "
                                 f"below its bound {c['bound_ms']} ms")
    for c in cases:
        lib = "-" if c["library_ms"] is None else f"{c['library_ms']:.4f}"
        if "+" in c.get("library", ""):
            lib += " (2 calls)"
        body = ""
        if "heads_per_block" in c:
            body = f" {c['body']} hb{c['heads_per_block']}"
        elif "body" in c:
            body = f" {c['body']} x{c['n_splits']}"
            if c.get("bf16_ms") is not None:
                body += f" bf16 {c['bf16_ms']:.4f}"
            if c.get("options"):
                body += (f" empty {c['empty_splits']} {json.dumps(c['options'])} "
                         f"bidi {c['bidi_ms']:.4f}")
        elif "plan" in c and "chunk_bytes" in c["plan"]:
            body = " {threads}x{rows_per_block}x{chunk_bytes}".format(**c["plan"])
        elif "plan" in c and "per_block" in c["plan"]:
            body = " {group}x{per_block}".format(**c["plan"])
        elif "plan" in c:
            body = " {group}x{loads}".format(**c["plan"])
        if c.get("full_ms") is not None:
            body += f" without holes {c['full_ms']:.4f}"
        print(f"{c['kernel']:21s} {c['case']:34s} {c['dtype']:15s}{body} "
              f"err {c['max_abs_err']:.2e} ms {c['ms']:.4f} (wall {c['wall_ms']:.4f}) "
              f"plain {c['plain_ms']:.4f} library {lib} bound {c['bound_ms']:.4f} "
              f"({c['bound_by']})")
        if c.get("hb_ms"):
            print(f"{'':21s} heads a block: {json.dumps(c['hb_ms'])} (bytes-only bound "
                  f"{c['bytes_bound_ms']:.4f})")
    slower = [f"{c['kernel']} {c['case']}" for c in cases if c.get("body") == "tensor_core"
              and c["library_ms"] is not None and c["ms"] > c["library_ms"]]
    print(f"tensor-core attention cases slower than their library call: {slower}")
    threefry = check_threefry(gen)
    print(f"threefry: {json.dumps(threefry)}")
    scatter_host = scatter_host_cost(ops, gen)
    print(f"ops.scatter_rows_paged per call: {json.dumps(scatter_host)}")
    for name, r in scatter_host.items():
        if r["kernels_per_call"] != 1:
            raise AssertionError(f"ops.scatter_rows_paged with mask {name}: "
                                 f"{r['kernels_per_call']} kernels a call, not 1")
    print(f"K/V scatters at gemma3's 512-byte rows, bit-equal: {scatter256}")
    importance_host = importance_host_cost(ops, gen)
    print(f"ops.importance_score with idx per call: {json.dumps(importance_host)}")
    for name, r in importance_host.items():
        if r["kernels_per_call"] != 1:
            raise AssertionError(f"ops.importance_score with idx, {name}: "
                                 f"{r['kernels_per_call']} kernels a call, not 1")
    lap("3")

    # phase 4: cross-device engine and scheduler checks
    cross = cross_device_check()
    print(f"cross-device: {json.dumps(cross)}")
    cross_serving = cross_device_serving()
    print(f"cross-device serving: {json.dumps(cross_serving)}")
    cross_sampled = cross_device_sampled_serving()
    print(f"cross-device sampled serving with prefix sharing: {json.dumps(cross_sampled)}")
    cross_preempt = cross_device_preemption()
    print(f"cross-device preemption: {json.dumps(cross_preempt)}")
    cross_quarantine = cross_device_quarantine()
    print(f"quarantine: {json.dumps(cross_quarantine)}")
    cross_mamba = cross_device_mamba()
    print(f"cross-device mamba2: {json.dumps(cross_mamba)}")
    cross_bc = cross_device_block_causal()
    print(f"cross-device block-causal and window: {json.dumps(cross_bc)}")
    cross_sparse = cross_device_sparse()
    print(f"cross-device sparse eviction and lazy reservation: {json.dumps(cross_sparse)}")
    cross_int8 = dict(gather=cross_device_int8_gather(),
                      sharing=cross_device_sampled_serving(kv_cache_dtype="int8"),
                      preemption={arch: cross_device_preemption(arch, kv_cache_dtype="int8")
                                  for arch in ("llada-8b", "dream-7b")})
    print(f"cross-device int8 cache and gather_refresh: {json.dumps(cross_int8)}")
    cross_archs = cross_device_archs(kernel_fns)
    print(f"cross-device MoE and dense archs: {json.dumps(cross_archs)}")
    cross_jamba = cross_device_jamba()
    print(f"cross-device jamba: {json.dumps(cross_jamba)}")
    cross_enc = cross_device_encoders(kernel_fns)
    print(f"cross-device encoder archs: {json.dumps(cross_enc)}")
    cross_train = cross_device_training(kernel_fns)
    print(f"cross-device training: {json.dumps(cross_train)}")
    lap("4")

    # phases 5 and 6: the offline and serving paths at full width, one model
    model, init_s = llada_8b(DEPTH_5)
    run = main_path(model, init_s, kernel_fns)
    print(f"offline path: {json.dumps(run)}")
    serving = serving_path(model, kernel_fns)
    print(f"serving path: {json.dumps(serving)}")
    check_tensor_core_path(run["launches"], "phase 5")
    check_tensor_core_path(serving["launches"], "phase 6")
    if run["launches"]["flash_attention"] != LAUNCHES_OFFLINE_GENERATE:
        raise AssertionError(f"phase 5: {run['launches']['flash_attention']} attention "
                             f"launches per generate, not {LAUNCHES_OFFLINE_GENERATE}")
    if serving["launches"]["paged_flash_attention"] != LAUNCHES_SERVING_TRACE:
        raise AssertionError(f"phase 6: {serving['launches']['paged_flash_attention']} "
                             f"attention launches per trace, not {LAUNCHES_SERVING_TRACE}")
    lap("5-6")

    # phase 9 (LLaDA-8B, depth cut): block-causal ES-dLLM with the window,
    # offline and served with the persistent prefix store
    cut, _ = llada_8b(DEPTH_9_10)
    bc_runs = bc_window_paths(cut, kernel_fns)
    for name, r in bc_runs.items():
        print(f"block-causal + window {name}: {json.dumps(r)}")
        check_tensor_core_path(r["launches"], f"phase 9 {name}")
    lap("9")

    # phase 10 (on phase 9's model): Sparse-dLLM eviction offline, and the
    # lazy, windowed, sparse served trace
    sparse_runs = {"offline": sparse_offline(cut, kernel_fns),
                   "served": lazy_served(cut, kernel_fns)}
    del cut
    torch.cuda.empty_cache()
    for name, r in sparse_runs["offline"]["runs"].items():
        print(f"phase 10 offline {name}: {json.dumps(r)}")
    served = sparse_runs["served"]
    print(f"phase 10 served: {json.dumps(served)}")
    print("phase 10 served, per request: output tokens {output_tokens}, max_new_tokens "
          "{max_new_tokens}, max_blocks {max_blocks}; pages_deferred {pages_deferred} "
          "(at admission {admission_deferred}), blocks_grown {blocks_grown}, window_stalls "
          "{window_stalls}, pages_reclaimed {pages_reclaimed}, peak pages {peak_pages_in_use} "
          "of {pool_pages}".format(**served))
    lap("10")

    # phase 11 (on phase 5's model): the int8 cache offline, served with
    # gather_refresh, and forked under prefix sharing
    int8_runs = {"11a": int8_offline(model, kernel_fns),
                 "11b": int8_gather_served(model, kernel_fns, serving),
                 "11c": int8_shared_served(model, kernel_fns)}
    for name, r in int8_runs.items():
        print(f"phase {name}: {json.dumps(r)}")
    lap("11")

    # phase 12 (on phase 5's model): the lock-step BatchServer at batch 8,
    # and phase 6's trace through two sharded lanes on the one card
    runtime_runs = {"12a": batch_server(model, kernel_fns),
                    "12b": sharded_served(model, kernel_fns)}
    r = runtime_runs["12a"]
    print(f"phase 12a: {json.dumps(r)}")
    print("phase 12a: BatchServer TPS {tps:.2f}, batch walls {batch_wall_s} s, launches "
          "flash_attention {fa}, scatter_rows {sc}, importance {im}".format(
              fa=r["launches"]["flash_attention"], sc=r["launches"]["scatter_rows"],
              im=r["launches"]["importance"], **r))
    for name, r in runtime_runs["12b"].items():
        print(f"phase 12b {name}: {json.dumps(r)}")
        print(f"phase 12b {name}: {r['steps']} steps at {r['ms_per_step']:.1f} ms, lanes "
              f"{json.dumps(r['lanes'])}, launches paged_flash_attention "
              f"{r['launches']['paged_flash_attention']}, scatter_rows_paged "
              f"{r['launches']['scatter_rows_paged']}, importance {r['launches']['importance']}")
    del model
    torch.cuda.empty_cache()
    lap("12")

    # phase 7: sampled serving of Dream-7B at full width
    dream, dream_init_s = dream_7b()
    sampled = dream_serving(dream, kernel_fns)
    sampled["init_s"] = dream_init_s
    for name, r in sampled["runs"].items():
        print(f"dream-7b {name}: {json.dumps(r)}")
        check_tensor_core_path(r["launches"], f"phase 7 {name}")
    del dream
    torch.cuda.empty_cache()
    lap("7")

    # phase 8: mamba2-370m at full width (depth cut), offline es and dualcache,
    # and served
    mamba, mamba_init_s = mamba2_370m()
    mamba_runs = mamba_offline(mamba, kernel_fns)
    mamba_runs["serving"] = mamba_serving(mamba, kernel_fns)
    mamba_runs["init_s"] = mamba_init_s
    mamba_runs["weights_gb"] = sum(nbytes(p) for p in mamba.parameters()) / 1e9
    for name in ("es", "dualcache", "serving"):
        print(f"mamba2-370m {name}: {json.dumps(mamba_runs[name])}")
        check_ssd_tensor_core_path(mamba_runs[name]["launches"], f"phase 8 {name}")
    if mamba_runs["es"]["launches"]["ssd_chunks"] != SSD_LAUNCHES_ES_GENERATE:
        raise AssertionError(f"phase 8: {mamba_runs['es']['launches']['ssd_chunks']} SSD "
                             f"launches per es generate, not {SSD_LAUNCHES_ES_GENERATE}")
    print(f"mamba2-370m es / dualcache ms per generate: {mamba_runs['es_over_dualcache_ms']}")
    del mamba
    torch.cuda.empty_cache()
    lap("8")

    # phase 13: olmoe-1b-7b and gemma3-1b offline and served, and the other
    # archs offline, at full width
    arch_runs = phase13(kernel_fns)
    for name in ("13a", "13b"):
        for mode in ("offline", "served"):
            r = arch_runs[name][mode]
            print(f"phase {name} {r['arch']} {mode}: {json.dumps(r)}")
            print(f"phase {name} {r['arch']} {mode}: wall {r['wall_s']:.2f} s, "
                  f"{r['tokens_per_s']:.1f} tok/s"
                  + (f", {r['steps']} steps at {r['ms_per_step']:.1f} ms" if mode == "served"
                     else "")
                  + f"; launches {json.dumps({k: v for k, v in r['launches'].items() if v})}")
    print(f"phase 13a drops at capacity: {json.dumps(arch_runs['13a']['drops'])}")
    print(f"phase 13a served profile: {json.dumps(arch_runs['13a']['served']['profile'])}")
    for mode in ("offline", "served"):
        print(f"phase 13b {mode} attention option launches: "
              f"{arch_runs['13b'][mode]['option_launches']}")
    for arch, r in arch_runs["13c"].items():
        r = r["offline"]
        print(f"phase 13c {arch} ({r['layers']} layers): wall {r['wall_s']:.2f} s, "
              f"{r['tokens_per_s']:.1f} tok/s; launches "
              f"{json.dumps({k: v for k, v in r['launches'].items() if v})}")
    lap("13")

    # phase 14: jamba-v0.1-52b at full width, two of its four periods
    jamba = phase14(kernel_fns)
    r = jamba["offline"]
    print(f"phase 14a: {json.dumps(r)}")
    print(f"phase 14a {r['arch']} ({r['layers']} layers, {r['weights_gb']:.2f} GB): es "
          f"{json.dumps(r['wall_s_repeats'])} s a generate, {r['tokens_per_s']:.1f} tok/s; "
          f"dualcache {r['dualcache']['wall_s']:.2f} s; busy {r['profile']['device_busy_ms']:.1f}"
          f" ms ({r['profile']['device_busy_share']:.3f}); device ms "
          f"{json.dumps(r['device_ms_split'])}; launches "
          f"{json.dumps({k: v for k, v in r['launches'].items() if v})}")
    print(f"phase 14 drops at capacity: {json.dumps(jamba['drops'])}")
    r = jamba["served"]
    print(f"phase 14b: {json.dumps(r)}")
    print(f"phase 14b: {r['steps']} steps at {r['ms_per_step']:.1f} ms, "
          f"{r['tokens_per_s']:.1f} tok/s, p50/p95 {r['latency_p50_s']:.2f}/"
          f"{r['latency_p95_s']:.2f} s, repeat equal {r['repeat_equal']}")
    for name in ("sharing", "preemption"):
        r = jamba["sampled"][name]
        print(f"phase 14c {name}: {json.dumps(r)}")
        print(f"phase 14c {name}: {r['steps']} steps at {r['ms_per_step']:.1f} ms, cow_forks "
              f"{r['cow_forks']}, preemptions {r['preemptions']}, resumes {r['resumes']}")
    print(f"phase 14: init {jamba['init_s']:.1f} s, allocated before "
          f"{jamba['allocated_before_gb']:.2f} GB, peak memory {jamba['peak_mem_gb']:.2f} GB")
    lap("14")

    # phase 15: llama-3.2-vision-11b and seamless-m4t-large-v2 at full width
    enc_runs = phase15(kernel_fns)
    report15(enc_runs)
    lap("15")

    # phase 16: qwen2-1.5b trained at full width and depth, f32
    train_run = phase16(kernel_fns)
    r = train_run
    print(f"phase 16: {json.dumps(r)}")
    print(f"phase 16 {r['arch']} ({r['layers']} layers, {r['params'] / 1e9:.3f} B params, f32): "
          f"median {r['median_s_per_step']:.3f} s a step over steps 2-{r['steps']}, "
          f"{r['tokens_per_s']:.0f} tokens/s, {r['tflops']:.1f} TFLOP/s (8 N tokens) of "
          f"{r['peak_tflops']:.0f} f32 peak; max_memory_allocated "
          f"{r['max_memory_allocated_gb']:.2f} GB, reckoned {r['reckoned_gb']:.2f} GB "
          f"(params, grads, two moments); losses {json.dumps([round(x, 4) for x in r['losses']])}")
    p = r["profile"]
    print(f"phase 16 profiled step: busy {p['device_busy_ms']:.1f} ms of "
          f"{p['profiled_wall_ms']:.1f} ({p['device_busy_share']:.3f}), {p['kernels_launched']} "
          f"kernels; top {json.dumps([(t['name'], round(t['ms'], 1), t['count']) for t in p['top']])}")
    lap("16")

    # phases 17 and 18: TP 2, two gloo ranks on the one card, and the dry runs:
    # LLaDA-8B (17), then mamba2-370m, SeamlessM4T and Jamba (18)
    tp_run, tp18_inputs = phase17(kernel_fns)
    report17(tp_run)
    tp18_run = phase18(tp18_inputs)
    report18(tp18_run)
    lap("17-18")
    # phase 19: training under FSDP x TP, four gloo ranks on the one card
    fsdp_run = phase19(kernel_fns)
    report19(fsdp_run)
    lap("19")
    print(f"phase seconds: {json.dumps(phase_s)}")

    # the kernels record, at a decode shape and dtype each path gives each
    # kernel: bf16 attention and K/V, f32 hidden states; launches from the
    # path that runs the kernel (the serving path for importance, which both run)
    headline = {"flash_attention": ("llada block Lq=32", torch.bfloat16),
                "paged_flash_attention": ("llada block Lq=32 ps=16", torch.bfloat16),
                "scatter_rows": ("llada block K=32", torch.bfloat16),
                "scatter_rows_paged": ("llada block K=32 ps=16 mask=none", torch.bfloat16),
                "importance": (f"llada stage1 K=32 B={SLOTS}", torch.float32),
                "variation": (f"llada partial [{SLOTS}, {T_TOTAL}, 4096]", torch.float32),
                # 7a forks cohort A's 8 and cohort B's 6 shared pages in one launch
                "fork_pages": ("dream F=14 ps=16", torch.bfloat16),
                "ssd_chunks": (f"decode [{SLOTS}, {BLOCK}] G=1", torch.bfloat16),
                "flash_attention_int8": ("llada block Lq=32 int8", torch.bfloat16),
                "paged_flash_attention_int8": ("llada block Lq=32 ps=16 int8", torch.bfloat16),
                "quantize_scatter_rows": ("llada block K=32 int8", torch.bfloat16),
                "quantize_scatter_rows_paged": ("llada block K=32 ps=16 mask=none int8",
                                                torch.bfloat16),
                # 11c forks the two cohorts' shared prompt pages
                "fork_pages_scales": ("llada F=14 ps=16 scales", torch.float32),
                # gemma3's head_dim 256 (phase 13b)
                "flash_attention_d256": (f"gemma3 dense Lq=32 Lkv={GEMMA_T} "
                                         f"window={GEMMA_WINDOW}", torch.bfloat16),
                "paged_flash_attention_d256": (f"gemma3 paged Lq=32 Lkv={GEMMA_T} ps=16 "
                                               f"window={GEMMA_WINDOW}", torch.bfloat16),
                # Jamba's SSD widths (phase 14)
                "ssd_chunks_jamba": (JAMBA_SSD_CASES[0][0], torch.bfloat16),
                # kernel 1 as cross-attention and encoder attention (phase 15)
                **{row: (label, torch.bfloat16) for row, label, *_ in CROSS_CASES},
                # kernels 1-4 at a TP-2 rank's 16 heads (phase 17b)
                "flash_attention_tp2": (f"llada tp2 block Lq={BLOCK} H={TP_HEADS}",
                                        torch.bfloat16),
                "paged_flash_attention_tp2": (f"llada tp2 block Lq={BLOCK} ps=16 H={TP_HEADS}",
                                              torch.bfloat16),
                "scatter_rows_tp2": (f"llada tp2 block K={BLOCK} H={TP_HEADS}", torch.bfloat16),
                "scatter_rows_paged_tp2": (f"llada tp2 block K={BLOCK} ps=16 H={TP_HEADS}",
                                           torch.bfloat16),
                # kernel 8 at a TP-2 rank's 64 of Jamba's SSM heads (phase 18b), and
                # kernel 1 as SeamlessM4T's cross-attention at 8 of 16 heads,
                # in 18a's f32
                "ssd_chunks_tp2": (JAMBA_SSD_TP2_CASES[0][0], torch.bfloat16),
                "flash_attention_cross_tp2": (CROSS_CASES[-1][1], torch.float32)}
    # the int8 rows' launches: phase 11's runs
    offline8 = int8_runs["11a"]["runs"]["int8"]["launches"]
    int8_launches = {
        "flash_attention_int8": offline8["flash_attention int8"],
        "paged_flash_attention_int8": int8_runs["11b"]["launches"]["paged_flash_attention int8"],
        "quantize_scatter_rows": offline8["quantize_scatter_rows"],
        "quantize_scatter_rows_paged": int8_runs["11b"]["launches"]["quantize_scatter_rows_paged"],
        "fork_pages_scales": int8_runs["11c"]["launches"]["fork_pages scales"]}
    # every attention launch of 13b is at head_dim 256
    d256_launches = {
        "flash_attention_d256": arch_runs["13b"]["offline"]["launches"]["flash_attention"],
        "paged_flash_attention_d256":
            arch_runs["13b"]["served"]["launches"]["paged_flash_attention"]}
    # kernel 1's launches as cross-attention in 15a's es generate and 15c's
    # sampled one (greedy, a block unmasks in its prefill), and in 15c's
    # encoder
    cross_launches = {
        "flash_attention_cross": enc_runs["15a"]["offline"]["kernel1_cross"],
        "flash_attention_cross_seamless": enc_runs["15c"]["sampled"]["kernel1_cross"],
        "flash_attention_encoder": enc_runs["15c"]["offline"]["kernel1_encoder"]}
    # rank 0's launches in phase 17b: the offline generate and the served
    # trace; in 18b's offline generate (kernel 8) and 18a's SeamlessM4T
    # generate (kernel 1 as cross-attention, f32)
    tp_b = tp_run["b"][0]
    tp_launches = {
        "flash_attention_tp2": tp_b["offline"]["launches"]["flash_attention"],
        "paged_flash_attention_tp2": tp_b["served"]["launches"]["paged_flash_attention"],
        "scatter_rows_tp2": tp_b["offline"]["launches"]["scatter_rows"],
        "scatter_rows_paged_tp2": tp_b["served"]["launches"]["scatter_rows_paged"],
        "ssd_chunks_tp2": tp18_run["b"][0]["offline"]["launches"]["ssd_chunks"],
        "flash_attention_cross_tp2": tp18_run["a"][AUDIO]["kernel1_cross"]}

    def case_row(x) -> str:
        """The kernels line's row a phase-3 case belongs to."""
        return x.get("row") or (x["kernel"] + "_d256" if x.get("head_dim") == 256
                                else x["kernel"])
    kernels = []
    for name, (case, dt) in headline.items():
        c = next(c for c in cases if case_row(c) == name and c["case"] == case
                 and c["dtype"] == str(dt))
        if name in tp_launches:
            launches = tp_launches[name]
        elif name in cross_launches:
            launches = cross_launches[name]
        elif name in d256_launches:
            launches = d256_launches[name]
        elif name in int8_launches:
            launches = int8_launches[name]
        elif name == "fork_pages":
            launches = sampled["runs"]["7a"]["launches"][name]
        elif name == "ssd_chunks":                  # the offline es run of phase 8
            launches = mamba_runs["es"]["launches"][name]
        elif name == "ssd_chunks_jamba":            # the offline es run of phase 14a
            launches = jamba["offline"]["launches"]["ssd_chunks"]
        else:
            launches = (serving if serving["launches"][name] else run)["launches"][name]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=launches,
            max_abs_err=max(x["max_abs_err"] for x in cases if case_row(x) == name),
            ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"]))
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        dict(card=smi, torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
             phase_s=phase_s,
             ptxas=ptxas, timer_fallbacks=TIMER_FALLBACKS, event_timed=len(EVENT_TIMED),
             cases=cases, threefry=threefry, cross_device=cross,
             cross_device_serving=cross_serving, cross_device_sampled=cross_sampled,
             cross_device_preemption=cross_preempt, quarantine=cross_quarantine,
             scatter_host=scatter_host, importance_host=importance_host,
             cross_device_mamba=cross_mamba, cross_device_block_causal=cross_bc,
             cross_device_sparse=cross_sparse, cross_device_int8=cross_int8,
             int8_paths=int8_runs, runtime_paths=runtime_runs,
             offline_path=run, serving_path=serving, block_causal_window=bc_runs,
             sparse_lazy=sparse_runs, cross_device_archs=cross_archs, archs=arch_runs,
             scatter_d256=scatter256, cross_device_jamba=cross_jamba, jamba=jamba,
             cross_device_encoders=cross_enc, encoder_archs=enc_runs,
             cross_device_training=cross_train, training=train_run, tensor_parallel=tp_run,
             tensor_parallel_stacks=tp18_run, fsdp_training=fsdp_run,
             dream_sampled_serving=sampled, mamba2=mamba_runs, kernels=kernels),
        indent=1))
    print(smi.splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
