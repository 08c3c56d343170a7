"""Diffusion-LLM generation engines of the port: vanilla, DualCache, ES-dLLM.

The block loop of the reference (``repro.core.engine``): the output is
generated block by block; within a block, denoising iterations run until
every position is unmasked.

* ``vanilla``   -- full-sequence forward every iteration, no caches.
* ``dualcache`` -- Fast-dLLM DualCache: out-of-block K/V cached; each
                   iteration recomputes only the current block.
* ``es``        -- the paper: DualCache + early-skip.  At each skip stage the
                   active set shrinks to the top-k rows by importance (Eq. 1);
                   the K/V, hidden and confidence caches are updated only for
                   the computed rows (Alg. 1), with periodic prompt and block
                   refreshes (Table 5).

Where the reference traces a ``lax.while_loop`` over iterations with a
``lax.switch`` over the branches, the port runs a Python loop whose exit
check reads one host scalar per iteration, and branches in Python on the
phase.  The KV cache planes are updated in place by the scatter kernel; the
SSM layers' caches (state, conv tail, block buffer) are written in place too.
Segments are ranges of layer groups (``core.schedule.resolve_segments``), so
a hybrid's skip stages land on its period boundaries, as in the reference.

Paged KV (``paged=True``): the K/V caches are one pool ``[n_attn, P, ps,
Hkv, Dh]`` shared by every slot and addressed through a per-slot block table
(-1 = unmapped; page 0 is the garbage page).  Offline ``generate`` uses an
identity table, so dense and paged greedy tokens agree.  The SSM layers'
caches stay per slot (a pure SSM stack's pool has no plane at all).

Adaptive feature cache (``cache_prompt_interval > 1``): between full prompt
refreshes, a partial refresh (branch 3) runs the shallow probe groups over
the whole sequence, scores each past token's feature variation, and pushes
only the top tokens through the deep groups, whose K/V scatters are token-
masked.  ``feat``/``conf_full`` carry across blocks.

Tensor parallelism (``Model(cfg, mesh=...)``) needs nothing here: every
rank runs this engine on the same values, and its host reads (the offline
loop's exit check, ``step``'s choice of passes) read tokens and per-slot
counters, which the model's sums make equal on every rank.

Serving (``EngineState``, ``step``): every per-request quantity is a ``[B]``
vector indexed by slot, including the within-block phase, so each row
resolves its own branch per step.  ``step`` runs up to four passes in the
reference's order (skip decode, block refresh, prefill, partial refresh),
each only when some active row needs it; a pass's scatters leave the rows it
does not own unwritten, and its outputs merge per row.  Rows advance their
block the moment it unmasks with ``early_advance``; the lifetime ``iters``
then jumps to the offline numbering.

Sampling (``temperature > 0``) draws with the reference's per-row key chain
``fold_in(fold_in(key, sample_seed[b]), iters[b])`` (``core.prng``): a
request's stream depends only on its own seed and lifetime iteration, so a
served request replays offline bit for bit, whatever shares the batch.

Block-causal attention (``block_causal``): a query attends the prompt and
its own and earlier blocks only, so a position's K/V depend on nothing
after its block.  A full refresh then leaves positions below
``core.schedule.invariant_limit`` unwritten (their K/V are final), which
is sound only because the caches carry across blocks, offline and served.
The sliding active window (``window_blocks``): a row attends positions
below ``core.schedule.window_limit`` of its block start, through a clamp
of ``kv_pos`` and, paged, a read view of the block table.

Sparse-dLLM eviction (``sparse_attention``, App. C.3.2): each full refresh
scores the out-of-block cache rows by the attention the block's queries
give them at the layer after the first skip stage and keeps the top
``sparse_retention`` share (``_sparse_evict``, plain PyTorch as in the
reference, outside any kernel).  The retained set ``kv_valid`` is sticky:
it carries across refreshes and blocks, offline and served, and a refresh
only shrinks it outside the current block.  Evicted rows read as ``kv_pos
< 0``; the scheduler unmaps pages wholly dead behind the block
(``dead_pages``) and the kernels read and write around them.

Page operations for the scheduler (paged serving): ``fork_pages`` (the
copy-on-write copy behind prefix sharing, a hand-written kernel on the
card), ``spill_pages``/``restore_pages`` (preemption) and ``scrub_pages``
(quarantine), all in place on every pool plane: K, V and, int8, the scales;
the SSM caches are per slot and no page operation touches them.

The int8 KV cache (``kv_cache_dtype="int8"``): K/V rows stored as int8
codes with f32 per-(token, head) scales, quantized by the scatter kernel and
read by the attention kernels, offline and served.

Gathered-subset refresh (``gather_refresh``, paged serving): when at most
half the slots take a prompt refresh in a step, the refreshing rows are
gathered into a half-width prefill (``_compact_prefill``); the batch-free
pool takes their writes in place through their gathered block tables.

On a stack with SSM layers the engine refuses what the reference's
refuses: the adaptive cache, ``gather_refresh`` and sparse attention
(``ValueError``).

Encoder-conditioned stacks (cross layers: Llama-3.2-Vision, SeamlessM4T):
``generate(prompt, enc_embeds=...)`` encodes once (``Model.encode``) and the
encoder output rides in ``BlockState.enc_out`` through every pass; serving
passes the scheduler's per-slot plane as ``step(state, enc_out)``.  A
prefill projects each cross layer's K/V from it into the per-slot cross
planes (the owned rows only), the decode passes read the planes, a vanilla
pass projects them afresh.  The engine refuses on these stacks what the
reference refuses or fails on: the adaptive cache, ``gather_refresh`` and
sparse attention.  The int8 cache covers the self-attention K/V only; the
cross planes stay in the parameter dtype.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import GenerationConfig
from repro_torch.core import prng
from repro_torch.core import sampler as smp
from repro_torch.core.schedule import (
    BLOCK_REFRESH,
    PARTIAL,
    PREFILL,
    SKIP_DECODE,
    Segment,
    branch_index,
    invariant_limit,
    prompt_refresh_pred,
    resolve_segments,
    window_limit,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.attention import KVCache, QuantKVCache
from repro_torch.models.common import apply_rope, rms_norm, row_gather, row_scatter
from repro_torch.models.mamba import SSMCache
from repro_torch.models.model import (
    ForwardCtx,
    HybridCache,
    Model,
    cache_planes,
    split_cache,
)

MODES = ("vanilla", "dualcache", "es")
NEG_INF = -1e30
PASSES = {SKIP_DECODE: "skip", BLOCK_REFRESH: "noskip", PREFILL: "prefill",
          PARTIAL: "partial"}
KV_DTYPES = (None, "int8")


class BlockState(NamedTuple):
    tokens: torch.Tensor             # [B, T] int32
    cache: Optional[KVCache | QuantKVCache | SSMCache | HybridCache]
                                     # K/V planes or pools (int8: with
                                     # scales) and the SSM caches (None for
                                     # vanilla)
    conf: torch.Tensor               # [B, Lb] f32 confidence cache
    pred: torch.Tensor               # [B, Lb] int32 predicted-token cache
    hidden: tuple                    # per skip stage: [B, Lb, d] f32 indicator cache
    kv_valid: torch.Tensor           # [B, T] bool sparse-attention retention set
    t: int                           # iteration counter within the block
    # adaptive feature cache (None without it): probe-boundary features and
    # last-observed confidence at every position, carried across blocks
    feat: Optional[torch.Tensor] = None        # [B, T, d] f32
    conf_full: Optional[torch.Tensor] = None   # [B, T] f32
    # the encoder output a prefill projects the cross K/V from (None on a
    # stack without cross layers)
    enc_out: Optional[torch.Tensor] = None     # [B, E, d_out]


class EngineState(NamedTuple):
    """Slot-addressable serving state: the block caches plus per-slot
    progress, every per-request quantity a ``[B]`` tensor."""
    tokens: torch.Tensor             # [B, T] int32
    cache: Optional[KVCache | QuantKVCache | SSMCache | HybridCache]
    conf: torch.Tensor               # [B, Lb]
    pred: torch.Tensor               # [B, Lb]
    hidden: tuple
    kv_valid: torch.Tensor           # [B, T] bool sparse-attention retention set
    bs: torch.Tensor                 # [B] int32 start of the current block
    blocks_left: torch.Tensor        # [B] int32 blocks not yet completed (incl. current)
    phase: torch.Tensor              # [B] int32 within-block iteration phase
    iters: torch.Tensor              # [B] int32 lifetime iteration counter
    active: torch.Tensor             # [B] bool: slot holds a live request
    key: torch.Tensor                # [2] int64 base sampling key (never split)
    prompt_start: torch.Tensor       # [B] int32 first real (non-pad) prompt position
    sample_seeds: torch.Tensor       # [B] int32 per-request seed folded into the key
    block_tables: Optional[torch.Tensor] = None   # [B, T / page_size] int32 (paged)
    feat: Optional[torch.Tensor] = None           # [B, T, d] f32 (adaptive cache)
    conf_full: Optional[torch.Tensor] = None      # [B, T] f32 (adaptive cache)
    cache_refreshed: Optional[torch.Tensor] = None   # [B] int32 cumulative tokens refreshed
    cache_eligible: Optional[torch.Tensor] = None    # [B] int32 cumulative eligible tokens
    poisoned: Optional[torch.Tensor] = None       # [B] bool: a non-finite value was seen


class DiffusionEngine:
    def __init__(
        self,
        model: Model,
        gen: GenerationConfig,
        *,
        device: str | torch.device | None = None,
        window_override: int = 0,            # local attention window of every layer
        anchor: int = 0,                     # positions below it bypass the window
        eos_id: int = 2,
        disallow_eos: bool = False,
        kv_cache_dtype: str | None = None,   # "int8": int8 K/V codes + f32 scales
        paged: bool = False,                 # paged KV pool + block tables
        page_size: int = 16,                 # tokens per KV page (paged only)
        kv_pages: int | None = None,         # pool pages incl. garbage page 0;
                                             # None => dense-equivalent sizing
        early_advance: bool = False,         # serving: advance a row's block
                                             # the moment it fully unmasks
        gather_refresh: bool = False,        # serving: compact a refresh of at most
                                             # half the slots (paged, attention-only)
    ):
        if gen.mode not in MODES:
            raise NotImplementedError(f"mode={gen.mode!r} (one of {MODES})")
        if kv_cache_dtype not in KV_DTYPES:
            raise ValueError(f"kv_cache_dtype={kv_cache_dtype!r}: one of {KV_DTYPES}")
        if gather_refresh and model.ssm:
            raise ValueError("gather_refresh: attention-only archs (SSM caches are batch-major "
                             "and would need a second gather/scatter path); the reference "
                             "refuses it too")
        if gather_refresh and not paged:
            raise ValueError("gather_refresh compaction needs the paged KV pool (batch-free "
                             "pool planes make row gathering transparent)")
        self.device = resolve_device(device)
        if self.device.type != model.device.type:
            raise ValueError(f"engine device {self.device} differs from the model's "
                             f"{model.device}")
        if gen.gen_length % gen.block_length:
            raise ValueError("gen_length must be a multiple of block_length")
        if paged and (gen.mode == "vanilla" or page_size <= 0):
            raise ValueError("paged KV needs a cached engine mode and page_size > 0")
        if model.ssm and gen.adaptive_cache:
            raise ValueError("the adaptive feature cache needs an attention-only period-1 "
                             "stack (its partial refresh cannot rejoin SSM layers); the "
                             "reference refuses it too")
        if model.ssm and gen.sparse_attention:
            raise ValueError("sparse attention on a stack with SSM layers: its probe scores "
                             "layer group 0's K cache; the reference refuses a period other "
                             "than 1 and fails on a pure SSM stack too")
        if model.cross and gen.adaptive_cache:
            raise ValueError("the adaptive feature cache needs an attention-only period-1 "
                             "stack (its partial refresh cannot rejoin cross layers); the "
                             "reference refuses it too ('adaptive feature cache: "
                             "attention-only period-1 archs only')")
        if model.cross and gather_refresh:
            raise ValueError("gather_refresh: attention-only archs (the cross caches are "
                             "batch-major and would need a second gather/scatter path); the "
                             "reference refuses it too")
        if model.cross and gen.sparse_attention:
            raise ValueError("sparse attention on a stack with cross layers: its probe scores "
                             "layer group 0's self-attention K cache; the reference refuses "
                             "a period other than 1 (the vision model) and fails on "
                             "SeamlessM4T, whose decoder has no K/V cache")
        if model.tp is not None and gen.sparse_attention:
            raise ValueError("sparse attention under tensor parallelism: its probe scores the "
                             "rank's own K heads, so the ranks would keep different rows; "
                             "see ROADMAP.md (A8)")
        self.model = model
        self.cfg = model.cfg
        self.gen = gen
        self.window_override = window_override
        self.anchor = anchor
        self.eos_id = eos_id
        self.disallow_eos = disallow_eos
        self.paged = paged
        self.page_size = page_size if paged else 0
        self.kv_pages = kv_pages
        self.early_advance = early_advance
        self.kv_cache_dtype = kv_cache_dtype
        self.gather_refresh = gather_refresh
        self.mask_id = self.cfg.vocab_size          # first padded-vocab slot
        lb = gen.block_length
        if gen.mode == "es":
            self.segments, _ = resolve_segments(self.cfg, gen, lb)
        else:
            self.segments = [Segment(0, model.n_groups, None, None)]
        self.n_stages = sum(1 for s in self.segments if s.keep_k is not None)
        self.sparse = gen.sparse_attention
        if self.sparse and (model.period != 1 or self.n_stages == 0):
            raise ValueError("sparse attention needs a period-1 stack and a skip stage as its "
                             "indicator probe; use a zero-ratio stage (SkipStage(l, 0.0)) "
                             "for sparse-only mode")
        self.n_per_step = max(1, -(-lb // gen.resolved_steps()))
        self.adaptive_cache = gen.adaptive_cache
        if self.adaptive_cache:
            if gen.mode != "es" or self.n_stages == 0:
                raise ValueError("the adaptive feature cache needs the es mode and a skip "
                                 "stage as its probe boundary")
            self.cache_probe_groups = self.segments[0].group_hi
        # reporting: iterations of the last generate() and its final block's
        # state; cached-mode passes run (offline iterations and step() passes)
        self.iterations = 0
        self.last_state: Optional[BlockState] = None
        self.pass_counts = {name: 0 for name in PASSES.values()}
        # prompt-refresh passes that ran compacted (gather_refresh), each also
        # counted as a "prefill" pass
        self.compact_prefill = 0

    # ------------------------------------------------------------------
    # indexing helpers
    # ------------------------------------------------------------------
    def _rows(self, b: int, n: int) -> torch.Tensor:
        """[B, n] int32 rows of 0..n-1 (positions, cache rows, block rows)."""
        return torch.arange(n, dtype=torch.int32, device=self.device)[None].expand(b, n).contiguous()

    def _block_cols(self, bs: torch.Tensor) -> torch.Tensor:
        """[B] block starts -> [B, Lb] int32 absolute columns."""
        lb = self.gen.block_length
        return bs[:, None] + torch.arange(lb, dtype=torch.int32, device=self.device)[None]

    def _kv_pos(self, kv_valid: torch.Tensor, prompt_start: torch.Tensor) -> torch.Tensor:
        """[B, T] int32 cache-validity positions: -1 for sparse-evicted rows
        (``kv_valid`` false) and pad prompt rows (pos < prompt_start).
        Unmapped pages are masked one level down, by ``ops.paged_attention``.
        Without sparse attention ``kv_valid`` is all true and not read."""
        pos = torch.arange(kv_valid.shape[1], dtype=torch.int32, device=self.device)[None]
        valid = pos >= prompt_start[:, None]
        if self.sparse:
            valid = valid & kv_valid
        return torch.where(valid, pos, -1)

    def _in_block(self, bs: torch.Tensor, t_total: int) -> torch.Tensor:
        """[B, T] bool: the positions of each row's current block."""
        col = torch.arange(t_total, dtype=torch.int32, device=self.device)[None]
        return (col >= bs[:, None]) & (col < bs[:, None] + self.gen.block_length)

    def _bc_args(self, t_total: int) -> dict:
        """Block-causal mask options for a ``t_total``-position sequence: the
        generation region starts at ``t_total - gen_length`` (the padded
        prompt end, offline and served) in blocks of ``block_length``;
        empty without ``block_causal``."""
        gen = self.gen
        if not gen.block_causal:
            return {}
        return {"bc_start": t_total - gen.gen_length, "bc_block": gen.block_length}

    def _invariant_limit(self, bs, iters, t_total: int):
        """[B] (or 0) exclusive write horizon of a full refresh under
        block-causal attention (``core.schedule.invariant_limit``), or None
        without it."""
        return invariant_limit(self.gen, bs, iters, t_total - self.gen.gen_length)

    def _ctx(self, positions, mode: str = "nocache", *, t_total: int, **kw) -> ForwardCtx:
        """A ``ForwardCtx`` with the engine's mask options: the window
        override, its anchor and the block-causal options."""
        return ForwardCtx(positions, mode, window_override=self.window_override,
                          anchor=self.anchor, **self._bc_args(t_total), **kw)

    def _identity_block_tables(self, b: int, t_total: int) -> torch.Tensor:
        """Offline layout: slot b owns pages [1 + b*n_vp, 1 + (b+1)*n_vp)."""
        n_vp = t_total // self.page_size
        if self.kv_pages is not None and b * n_vp + 1 > self.kv_pages:
            raise ValueError(f"kv_pages={self.kv_pages} cannot hold {b} offline rows of "
                             f"{n_vp} pages (+ garbage page)")
        return torch.arange(1, b * n_vp + 1, dtype=torch.int32,
                            device=self.device).reshape(b, n_vp)

    # ------------------------------------------------------------------
    # public API: offline
    # ------------------------------------------------------------------
    @torch.no_grad()
    def generate(self, prompt: torch.Tensor,
                 prompt_start: Optional[torch.Tensor] = None, *,
                 enc_embeds: Optional[torch.Tensor] = None,
                 key: Optional[torch.Tensor] = None,
                 sample_seeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Generates ``gen.gen_length`` tokens after ``prompt [B, P]``;
        returns the ``[B, P + gen_length]`` int32 tokens.  ``prompt_start
        [B]`` masks each row's left-pad prompt positions out of attention
        (the serving runtime's variable-length-prompt contract).  ``key`` is
        the base sampling key (``prng.prng_key(0)`` by default); row ``b``
        draws with ``fold_in(fold_in(key, sample_seeds[b]), iteration)``, and
        ``sample_seeds`` defaults to the row index, so duplicate prompts
        sample distinct completions.  Pass a request's serving seed to replay
        it.  ``enc_embeds [B, E, d_enc]`` (float32 stub frontend embeddings)
        condition an encoder arch's cross layers; they are encoded once."""
        gen = self.gen
        b, p = prompt.shape
        enc_out = None if enc_embeds is None else self.model.encode(enc_embeds)
        lb = gen.block_length
        t_total = p + gen.gen_length
        tokens = torch.cat([
            prompt.to(device=self.device, dtype=torch.int32),
            torch.full((b, gen.gen_length), self.mask_id, dtype=torch.int32,
                       device=self.device)], dim=1)
        if prompt_start is None:
            prompt_start = torch.zeros((b,), dtype=torch.int32, device=self.device)
        prompt_start = prompt_start.to(device=self.device, dtype=torch.int32)
        key, seeds = self._key_and_seeds(b, key, sample_seeds)
        bt = self._identity_block_tables(b, t_total) if self.paged else None
        # the KV cache, the sticky retention set and the adaptive cache's
        # planes carry across blocks; each block's first iteration is a
        # prefill that rewrites the K/V
        cache = self._init_cache(b, t_total)
        kv_valid = torch.ones((b, t_total), dtype=torch.bool, device=self.device)
        feat, conf_full = self._feature_planes(b, t_total)
        self.iterations = 0
        for blk in range(gen.gen_length // lb):
            self.last_state = self._run_block(tokens, cache, kv_valid, feat, conf_full,
                                              p + blk * lb, blk * gen.resolved_steps(),
                                              prompt_start, bt, key, seeds, enc_out)
            tokens, kv_valid, feat, conf_full = (
                self.last_state.tokens, self.last_state.kv_valid, self.last_state.feat,
                self.last_state.conf_full)
        return tokens

    def make_block_state(self, tokens: torch.Tensor) -> BlockState:
        b, t_total = tokens.shape
        return self._block_state(tokens.to(device=self.device, dtype=torch.int32),
                                 self._init_cache(b, t_total),
                                 torch.ones((b, t_total), dtype=torch.bool, device=self.device),
                                 *self._feature_planes(b, t_total))

    @torch.no_grad()
    def prefill(self, st: BlockState, bs: int) -> BlockState:
        """Cache initialization / prompt refresh as a standalone step.  A
        sampled draw uses the reference's defaults for standalone steps: the
        base key ``PRNGKey(0)``, row index seeds and iteration ``st.t``."""
        bs_rows, pstart, bt = self._offline_rows(st, bs)
        return self._apply_unmask(st, bs_rows, *self._prefill_step(st, bs_rows, st.t, pstart, bt,
                                                                   self._standalone_keys(st)))

    @torch.no_grad()
    def decode_iteration(self, st: BlockState, bs: int) -> BlockState:
        """One steady-state ES iteration (paper Alg. 1): skip decode."""
        bs_rows, pstart, bt = self._offline_rows(st, bs)
        return self._apply_unmask(st, bs_rows, *self._decode_step(
            st, bs_rows, pstart, bt, self._standalone_keys(st), skip=True))

    # ------------------------------------------------------------------
    # per-block loop
    # ------------------------------------------------------------------
    def _init_cache(self, b: int, t_total: int):
        if self.gen.mode == "vanilla":
            return None
        kw = {}
        if self.paged:
            if t_total % self.page_size:
                raise ValueError(f"page_size {self.page_size} must divide the sequence "
                                 f"{t_total}")
            kw = dict(kv_pages=self.kv_pages or b * (t_total // self.page_size) + 1,
                      page_size=self.page_size)
        return self.model.init_cache(b, t_total, block_len=self.gen.block_length,
                                     kv_dtype=self.kv_cache_dtype, **kw)

    def _feature_planes(self, b: int, t_total: int):
        if not self.adaptive_cache:
            return None, None
        return (torch.zeros((b, t_total, self.cfg.d_model), dtype=torch.float32,
                            device=self.device),
                torch.zeros((b, t_total), dtype=torch.float32, device=self.device))

    def _block_state(self, tokens, cache, kv_valid, feat=None, conf_full=None,
                     enc_out=None) -> BlockState:
        b, lb, d = tokens.shape[0], self.gen.block_length, self.cfg.d_model
        dev = self.device
        return BlockState(
            tokens=tokens, cache=cache,
            conf=torch.zeros((b, lb), dtype=torch.float32, device=dev),
            pred=torch.zeros((b, lb), dtype=torch.int32, device=dev),
            hidden=tuple(torch.zeros((b, lb, d), dtype=torch.float32, device=dev)
                         for _ in range(self.n_stages)),
            kv_valid=kv_valid, t=0, feat=feat, conf_full=conf_full, enc_out=enc_out)

    def _offline_rows(self, st: BlockState, bs: int):
        """(bs [B], prompt_start [B], block tables) of the offline layout."""
        b, t_total = st.tokens.shape
        bs_rows = torch.full((b,), bs, dtype=torch.int32, device=self.device)
        pstart = torch.zeros((b,), dtype=torch.int32, device=self.device)
        bt = self._identity_block_tables(b, t_total) if self.paged else None
        return bs_rows, pstart, bt

    # ------------------------------------------------------------------
    # sampling keys
    # ------------------------------------------------------------------
    def _key_and_seeds(self, b: int, key, seeds):
        """(base key [2], seeds [B]) on the engine's device, with the
        reference's defaults: ``PRNGKey(0)`` and the row index."""
        key = prng.prng_key(0) if key is None else key
        if seeds is None:
            seeds = torch.arange(b, dtype=torch.int32)
        return (key.to(device=self.device, dtype=torch.int64),
                torch.as_tensor(seeds).to(device=self.device, dtype=torch.int32))

    def _row_keys(self, key, seeds, iters) -> Optional[torch.Tensor]:
        """[B, 2] draw keys ``fold_in(fold_in(key, seeds[b]), iters[b])``, or
        None at temperature 0, where nothing is drawn."""
        if self.gen.temperature <= 0:
            return None
        iters = torch.as_tensor(iters, device=self.device).expand(seeds.shape)
        return prng.row_keys(key, seeds, iters)

    def _standalone_keys(self, st: BlockState) -> Optional[torch.Tensor]:
        key, seeds = self._key_and_seeds(st.tokens.shape[0], None, None)
        return self._row_keys(key, seeds, st.t)

    def _run_block(self, tokens, cache, kv_valid, feat, conf_full, bs: int, iters0: int,
                   prompt_start, bt, key, seeds, enc_out=None) -> BlockState:
        gen = self.gen
        st = self._block_state(tokens, cache, kv_valid, feat, conf_full, enc_out)
        bs_rows = torch.full((tokens.shape[0],), bs, dtype=torch.int32, device=self.device)
        max_steps = gen.resolved_steps() + 1
        while st.t == 0 or (st.t < max_steps and self._any_masked(st, bs)):
            keys = self._row_keys(key, seeds, iters0 + st.t)
            outs = self._iteration_outputs(st, bs_rows, iters0 + st.t, prompt_start, bt, keys)
            st = self._apply_unmask(st, bs_rows, *outs)
            self.iterations += 1
        return st

    def _any_masked(self, st: BlockState, bs: int) -> bool:
        lb = self.gen.block_length
        return bool((st.tokens[:, bs:bs + lb] == self.mask_id).any().item())

    def _iteration_outputs(self, st: BlockState, bs, iters: int, prompt_start, bt, keys):
        """Branch-dispatched compute for one denoising iteration at phase
        ``st.t`` and lifetime iteration ``iters``, drawing with ``keys``.
        Returns ``(cache, conf, pred, hidden, kv_valid, feat, stats)``."""
        if self.gen.mode == "vanilla":
            conf, pred = self._vanilla_compute(st, bs, keys)
            return st.cache, conf, pred, st.hidden, st.kv_valid, st.feat, None
        branch = branch_index(self.gen, st.t, iters)
        self.pass_counts[PASSES[branch]] += 1
        if branch == PREFILL:
            return self._prefill_step(st, bs, iters, prompt_start, bt, keys)
        if branch == PARTIAL:
            return self._partial_refresh_step(st, bs, prompt_start, bt, keys)
        return self._decode_step(st, bs, prompt_start, bt, keys, skip=branch != BLOCK_REFRESH)

    def _apply_unmask(self, st: BlockState, bs, cache, conf, pred, hidden, kv_valid,
                      feat=None, stats=None,
                      active: Optional[torch.Tensor] = None) -> BlockState:
        cols = self._block_cols(bs)
        blk_tok = row_gather(st.tokens, cols)
        sel = smp.select_unmask(conf, blk_tok == self.mask_id, self.gen, self.n_per_step)
        if active is not None:
            sel = sel & active[:, None]
        tokens = st.tokens.scatter(1, cols.long(), torch.where(sel, pred, blk_tok))
        conf_full = st.conf_full
        if self.adaptive_cache:
            # the block's freshest confidences at their absolute positions:
            # settled blocks keep their final values for the refresh priority
            conf_full = st.conf_full.scatter(1, cols.long(), conf)
        return BlockState(tokens, cache, conf, pred, hidden, kv_valid, st.t + 1,
                          st.feat if feat is None else feat, conf_full, st.enc_out)

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def init_engine_state(self, batch: int, prompt_len: int,
                          key: Optional[torch.Tensor] = None) -> EngineState:
        """All-idle slot state for ``batch`` slots; ``prompt_len`` fixes the
        padded prompt region, so the sequence is ``prompt_len + gen_length``.
        ``key`` is the base sampling key (``prng.prng_key(0)`` by default)."""
        t_total = prompt_len + self.gen.gen_length
        dev = self.device
        tokens = torch.full((batch, t_total), self.mask_id, dtype=torch.int32, device=dev)
        bst = self.make_block_state(tokens)
        zeros = lambda dtype: torch.zeros((batch,), dtype=dtype, device=dev)  # noqa: E731
        bt = None
        if self.paged:
            # every slot starts unmapped; the scheduler maps pages at admission
            bt = torch.full((batch, t_total // self.page_size), -1, dtype=torch.int32,
                            device=dev)
        return EngineState(
            tokens=bst.tokens, cache=bst.cache, conf=bst.conf, pred=bst.pred,
            hidden=bst.hidden, kv_valid=bst.kv_valid,
            bs=torch.full((batch,), prompt_len, dtype=torch.int32, device=dev),
            blocks_left=zeros(torch.int32), phase=zeros(torch.int32),
            iters=zeros(torch.int32), active=zeros(torch.bool),
            key=self._key_and_seeds(batch, key, None)[0],
            prompt_start=zeros(torch.int32), sample_seeds=zeros(torch.int32), block_tables=bt,
            feat=bst.feat, conf_full=bst.conf_full,
            cache_refreshed=zeros(torch.int32), cache_eligible=zeros(torch.int32),
            poisoned=zeros(torch.bool))

    @torch.no_grad()
    def step(self, state: EngineState, enc_out: Optional[torch.Tensor] = None) -> EngineState:
        """One denoising iteration for every resident slot.  Each row's branch
        comes from its own phase; the KV caches are updated in place, every
        other field of the returned state is new.  ``enc_out [B, E, d_out]``
        is the encoder output of each slot's request (the scheduler's
        plane), which an encoder arch's prefill passes read."""
        gen = self.gen
        steps_pb, lb = gen.resolved_steps(), gen.block_length
        bs = state.bs
        st = BlockState(state.tokens, state.cache, state.conf, state.pred, state.hidden,
                        state.kv_valid, state.phase, state.feat, state.conf_full, enc_out)
        keys = self._row_keys(state.key, state.sample_seeds, state.iters)
        if gen.mode == "vanilla":
            conf, pred = self._vanilla_compute(st, bs, keys)
            outs = (st.cache, conf, pred, st.hidden, st.kv_valid, st.feat, None)
        else:
            outs = self._mixed_step_outputs(state, st, keys)
        stats = outs[6]
        st = self._apply_unmask(st, bs, *outs[:6], active=state.active)

        # poison detector: a non-finite confidence, indicator or feature value
        # of an active row sets its sticky flag (the scheduler raises on it)
        bad = ~torch.isfinite(st.conf).all(dim=1)
        for hh in st.hidden:
            bad |= ~torch.isfinite(hh).all(dim=2).all(dim=1)
        if st.feat is not None:
            bad |= ~torch.isfinite(st.feat).all(dim=2).all(dim=1)
        poisoned = state.poisoned | (bad & state.active)

        # per-row block advance: a row whose block fully unmasked moves to its
        # next block (or completes) -- at once with early_advance, else at its
        # own phase wrap.  The lifetime counter jumps to the offline numbering
        # (block blk starts at blk * steps_pb): the skipped iterations were
        # no-ops.
        phase_used = state.phase
        phase = (phase_used + 1) % steps_pb
        blk_done = ~(row_gather(st.tokens, self._block_cols(bs)) == self.mask_id).any(dim=1)
        adv = state.active & blk_done
        if not self.early_advance:
            adv = adv & (phase == 0)
        blocks_left = state.blocks_left - adv.int()
        finished = adv & (blocks_left == 0)
        cache_refreshed, cache_eligible = state.cache_refreshed, state.cache_eligible
        if stats is not None:
            cache_refreshed = cache_refreshed + stats[:, 0]
            cache_eligible = cache_eligible + stats[:, 1]
        return EngineState(
            tokens=st.tokens, cache=st.cache, conf=st.conf, pred=st.pred, hidden=st.hidden,
            kv_valid=st.kv_valid, bs=torch.where(adv & ~finished, bs + lb, bs),
            blocks_left=blocks_left,
            phase=torch.where(adv, 0, phase),
            iters=torch.where(adv, state.iters - phase_used + steps_pb,
                              state.iters + state.active.int()),
            active=state.active & ~finished, key=state.key,
            prompt_start=state.prompt_start, sample_seeds=state.sample_seeds,
            block_tables=state.block_tables,
            feat=st.feat, conf_full=st.conf_full,
            cache_refreshed=cache_refreshed, cache_eligible=cache_eligible,
            poisoned=poisoned)

    def _mixed_step_outputs(self, state: EngineState, st: BlockState, keys):
        """Up to four passes, in the reference's order (skip decode, block
        refresh, prefill, partial refresh), each run only when some active
        row is in its branch and masked to those rows.  Rows a pass does not
        own still flow through it; their scatters are dropped and their
        outputs merged away.  With ``gather_refresh`` a prefill pass of at
        most ``max(1, B // 2)`` rows runs compacted (``_compact_prefill``).
        One host read per step decides the passes."""
        br = branch_index(self.gen, state.phase, state.iters)
        codes = [SKIP_DECODE, BLOCK_REFRESH, PREFILL] + ([PARTIAL] if self.adaptive_cache else [])
        masks = [state.active & (br == code) for code in codes]
        refreshing = masks[codes.index(PREFILL)]
        *run, n_refresh = torch.stack([m.any() for m in masks] + [refreshing.sum()]).tolist()
        cap = max(1, state.bs.shape[0] // 2)
        bs, pstart, bt = state.bs, state.prompt_start, state.block_tables
        stats = None
        if self.adaptive_cache:
            stats = torch.zeros((bs.shape[0], 2), dtype=torch.int32, device=self.device)
        carry = (st.cache, st.conf, st.pred, st.hidden, st.kv_valid, st.feat, stats)
        for code, mask, on in zip(codes, masks, run):
            if not on:
                continue
            self.pass_counts[PASSES[code]] += 1
            cst = st._replace(cache=carry[0], conf=carry[1], pred=carry[2], hidden=carry[3],
                              kv_valid=carry[4], feat=carry[5])
            if code == PREFILL and self.gather_refresh and n_refresh <= cap:
                self.compact_prefill += 1
                carry = self._compact_prefill(cst, state, keys, mask, cap, carry)
                continue
            if code == PREFILL:
                out = self._prefill_step(cst, bs, state.iters, pstart, bt, keys, row_mask=mask)
            elif code == PARTIAL:
                out = self._partial_refresh_step(cst, bs, pstart, bt, keys, row_mask=mask)
            else:
                out = self._decode_step(cst, bs, pstart, bt, keys, skip=code == SKIP_DECODE,
                                        row_mask=mask)
            carry = _merge_step_outputs(mask, carry, out)
        return carry

    def _compact_prefill(self, st: BlockState, state: EngineState, keys, mask, cap: int,
                         carry):
        """Gathered-subset prompt refresh (``gather_refresh``), the
        reference's ``_compact_prefill``: the refreshing rows (stable order)
        and filler rows after them, ``cap`` in all, run the prefill as a
        half-width batch under their own row mask, and its outputs scatter
        back onto those rows of ``carry``.  The paged pool is batch-free:
        the gathered block tables route the rows' K/V writes to their own
        pages in place, and the filler rows' writes are masked."""
        rows = torch.sort((~mask).int(), stable=True).indices[:cap]
        sub_mask = mask[rows]

        def g(a):
            return None if a is None else a[rows]
        st_g = st._replace(tokens=g(st.tokens), conf=g(st.conf), pred=g(st.pred),
                           hidden=tuple(g(h) for h in st.hidden), kv_valid=g(st.kv_valid),
                           feat=g(st.feat), conf_full=g(st.conf_full), enc_out=g(st.enc_out))
        out = self._prefill_step(st_g, g(state.bs), g(state.iters), g(state.prompt_start),
                                 g(state.block_tables), g(keys), row_mask=sub_mask)

        def put(full, sub):
            if full is None:
                return None
            m = sub_mask.view((cap,) + (1,) * (sub.dim() - 1))
            res = full.clone()
            res[rows] = torch.where(m, sub.to(full.dtype), full[rows])
            return res
        cache, conf, pred, hidden, kv_valid, feat, stats = out
        o_cache, o_conf, o_pred, o_hidden, o_kv, o_feat, o_stats = carry
        return (cache, put(o_conf, conf), put(o_pred, pred),
                tuple(put(o, n) for o, n in zip(o_hidden, hidden)),
                o_kv if kv_valid is st_g.kv_valid else put(o_kv, kv_valid),
                put(o_feat, feat), o_stats if stats is None else put(o_stats, stats))

    # ------------------------------------------------------------------
    # branches
    # ------------------------------------------------------------------
    def _prefill_step(self, st: BlockState, bs, iters, prompt_start, bt, keys,
                      row_mask: Optional[torch.Tensor] = None):
        """Full forward over the whole sequence: rebuilds the KV cache and
        the block's confidence/prediction/indicator caches (cache init and
        prompt refresh) at lifetime iteration ``iters`` ([B], or an int
        offline).  Under a ``row_mask`` the carried caches are not zeroed:
        the other rows' cache state (in a shared pool, their pages) must
        survive, and the refresh rewrites every owned position anyway.

        Block-causal: positions below the invariant horizon already hold
        their final K/V, so the refresh's token mask leaves them unwritten
        (which keeps persistently shared prompt pages read-only) and the
        caches are not zeroed.

        Sparse attention: the refresh is sticky.  Rows outside the current
        block that an earlier eviction dropped stay out of this pass's reads
        and can never re-enter the retained set (``_sparse_evict``); their
        K/V are still recomputed and scattered, onto the garbage page where
        the scheduler has reclaimed their page."""
        model = self.model
        b, t_total = st.tokens.shape
        cols = self._block_cols(bs)
        pos = self._rows(b, t_total)
        inv = self._invariant_limit(bs, iters, t_total)
        refresh_tok = None
        if inv is not None:
            refresh_tok = pos >= (inv[:, None] if torch.is_tensor(inv) else inv)
        if row_mask is None and inv is None:
            for plane in cache_planes(st.cache):
                plane.zero_()
        # the current block is always attendable and retained; every other
        # row keeps its carried validity
        attend_valid = (st.kv_valid | self._in_block(bs, t_total)) if self.sparse else st.kv_valid
        ctx = self._ctx(pos, "prefill", t_total=t_total,
                        kv_pos=self._kv_pos(attend_valid, prompt_start), slot_idx=pos,
                        block_tables=bt, scatter_mask=row_mask, refresh_mask=refresh_tok,
                        block_start=bs, window_limit=window_limit(self.gen, bs),
                        enc_out=st.enc_out)
        h = model.embed_tokens(st.tokens)
        hidden, feat = [], st.feat
        for seg in self.segments:
            h = model.run_layers(h, ctx, st.cache, group_lo=seg.group_lo,
                                 group_hi=seg.group_hi)
            if self.adaptive_cache and seg.group_hi == self.cache_probe_groups:
                # the baseline the next partial refresh measures variation against
                feat = h.float()
            if seg.keep_k is not None:
                hidden.append(row_gather(h, cols).float())
        conf, pred = self._confidence(st, bs, model.logits(row_gather(h, cols)), keys)
        kv_valid = st.kv_valid
        if self.sparse:
            keep = self._sparse_evict(st.cache, hidden, bs, prompt_start, bt, attend_valid)
            # sticky: a refresh only shrinks the retained set outside the block
            kv_valid = keep & attend_valid
        stats = None
        if self.adaptive_cache:
            # a full refresh recomputes every eligible past token
            n_el = self._cache_eligible(bs, prompt_start, bt, st.kv_valid).sum(dim=1).int()
            stats = torch.stack([n_el, n_el], dim=1)
        return st.cache, conf, pred, tuple(hidden), kv_valid, feat, stats

    def _decode_step(self, st: BlockState, bs, prompt_start, bt, keys, *, skip: bool,
                     row_mask: Optional[torch.Tensor] = None):
        """One diffusion iteration on the current block (paper Alg. 1).
        ``skip=True`` applies the early-skip schedule; ``skip=False`` is the
        block refresh (all block rows computed).  A sampled draw's noise
        follows the rows in their top-k selection order, as the reference's."""
        model, gen = self.model, self.gen
        b, t_total = st.tokens.shape
        h = model.embed_tokens(row_gather(st.tokens, self._block_cols(bs)))
        s_idx = self._rows(b, gen.block_length)
        kv_pos = self._kv_pos(st.kv_valid, prompt_start)
        hidden = list(st.hidden)
        wl = window_limit(self.gen, bs)
        for seg in self.segments:
            rows = bs[:, None] + s_idx
            ctx = self._ctx(rows, "decode", t_total=t_total, kv_pos=kv_pos, slot_idx=rows,
                            block_tables=bt, scatter_mask=row_mask, block_idx=s_idx,
                            window_limit=wl, enc_out=st.enc_out)
            h = model.run_layers(h, ctx, st.cache, group_lo=seg.group_lo,
                                 group_hi=seg.group_hi)
            if seg.keep_k is not None:
                i = seg.stage_idx
                hf = h.float()
                scores = ops.importance_score(hf, hidden[i], st.conf, alpha=gen.alpha,
                                              idx=s_idx)
                hidden[i] = row_scatter(hidden[i], hf, s_idx)
                if skip:
                    sel = _top_k(scores, seg.keep_k)
                    s_idx = torch.gather(s_idx, 1, sel)
                    h = row_gather(h, sel)
        conf_new, pred_new = smp.confidence_and_pred(
            keys, model.logits(h), gen, self.cfg.vocab_size, self.mask_id)
        conf = row_scatter(st.conf, conf_new, s_idx)
        pred = row_scatter(st.pred, pred_new, s_idx)
        return st.cache, conf, pred, tuple(hidden), st.kv_valid, st.feat, None

    def _cache_eligible(self, bs, prompt_start, bt, kv_valid) -> torch.Tensor:
        """[B, T] bool: past tokens whose K/V a partial refresh may recompute:
        attendable (not sparse-evicted), real (not left-pad), outside the
        current block (the block pass owns those), and, paged, on a mapped
        page (a write to an unmapped page would land on the garbage page and
        lose the fresh values).
        Block-causal: only positions past the block (everything before it
        is final since the block's entry refresh, and a write would touch
        persistently shared prompt pages).  Windowed: only positions inside
        the window (the others are read by no one)."""
        t_total = kv_valid.shape[1]
        col = torch.arange(t_total, dtype=torch.int32, device=self.device)[None]
        eligible = ~self._in_block(bs, t_total) & (col >= prompt_start[:, None])
        if self.sparse:
            eligible &= kv_valid
        if self.gen.block_causal:
            eligible &= col >= bs[:, None]
        wl = window_limit(self.gen, bs)
        if wl is not None:
            eligible &= col < wl[:, None]
        if self.paged:
            eligible &= (bt >= 0).repeat_interleave(self.page_size, dim=1)
        return eligible

    def _partial_refresh_step(self, st: BlockState, bs, prompt_start, bt, keys,
                              row_mask: Optional[torch.Tensor] = None):
        """Partial prompt refresh (branch 3, adaptive feature cache): probe
        the shallow groups over the whole sequence, score each past token's
        feature variation against ``st.feat`` blended with ``st.conf_full``,
        recompute the deep-group K/V of the top ``cache_refresh_fraction``
        tokens at or above ``cache_variation_threshold`` (the others keep
        their cached K/V: token-masked scatters), then run the block refresh.
        The carried caches are never zeroed here."""
        model, gen = self.model, self.gen
        b, t_total = st.tokens.shape
        gp = self.cache_probe_groups
        attend_valid = (st.kv_valid | self._in_block(bs, t_total)) if self.sparse else st.kv_valid
        kv_pos = self._kv_pos(attend_valid, prompt_start)
        wl = window_limit(self.gen, bs)
        # 1. shallow probe over every position: its K/V refresh everywhere
        pos = self._rows(b, t_total)
        ctx = self._ctx(pos, "prefill", t_total=t_total, kv_pos=kv_pos, slot_idx=pos,
                        block_tables=bt, scatter_mask=row_mask, window_limit=wl)
        h_probe = model.run_layers(model.embed_tokens(st.tokens), ctx, st.cache,
                                   group_lo=0, group_hi=gp)
        feat = h_probe.float()
        # 2. variation-gated selection: top-R by score, then the threshold
        scores = ops.variation_score(feat, st.feat, st.conf_full, alpha=gen.alpha)
        eligible = self._cache_eligible(bs, prompt_start, bt, st.kv_valid)
        cand = torch.where(eligible, scores, -math.inf)
        r = max(1, min(t_total,
                       math.ceil(gen.cache_refresh_fraction * (t_total - gen.block_length))))
        sel = _top_k(cand, r)
        val = torch.gather(cand, 1, sel)
        tok_ok = torch.isfinite(val) & (val >= gen.cache_variation_threshold)
        # 3. deep refresh of the selected tokens; the token mask keeps the
        # K/V of the filler and below-threshold ones
        sel = sel.int()
        dctx = self._ctx(sel, "decode", t_total=t_total, kv_pos=kv_pos, slot_idx=sel,
                         block_tables=bt, scatter_mask=row_mask, refresh_mask=tok_ok,
                         window_limit=wl)
        model.run_layers(row_gather(h_probe, sel), dctx, st.cache, group_lo=gp,
                         group_hi=model.n_groups)
        # 4. the block refresh on the partially refreshed caches
        out = self._decode_step(st, bs, prompt_start, bt, keys, skip=False, row_mask=row_mask)
        stats = torch.stack([tok_ok.sum(dim=1), eligible.sum(dim=1)], dim=1).int()
        return out[:5] + (feat, stats)

    def _vanilla_compute(self, st: BlockState, bs, keys):
        """Full-sequence forward, no caches (the original LLaDA loop)."""
        model = self.model
        b, t_total = st.tokens.shape
        h = model.run_layers(model.embed_tokens(st.tokens),
                             self._ctx(self._rows(b, t_total), t_total=t_total,
                                       enc_out=st.enc_out))
        return self._confidence(st, bs, model.logits(row_gather(h, self._block_cols(bs))),
                                keys)

    def _confidence(self, st: BlockState, bs, logits_blk: torch.Tensor, keys):
        if self.disallow_eos:
            masked = (row_gather(st.tokens, self._block_cols(bs)) == self.mask_id).int()
            rev = masked.flip(1).cumsum(1).flip(1)
            logits_blk = smp.disallow_premature_eos(logits_blk, (rev - masked) > 0,
                                                    self.eos_id)
        return smp.confidence_and_pred(keys, logits_blk, self.gen, self.cfg.vocab_size,
                                       self.mask_id)

    # ------------------------------------------------------------------
    # Sparse-dLLM cache eviction (App. C.3.2)
    # ------------------------------------------------------------------
    def _sparse_evict(self, cache: KVCache | QuantKVCache, hidden, bs, prompt_start, bt,
                      kv_valid) -> torch.Tensor:
        """[B, T] bool retained set of a refresh: out-of-block cache rows
        scored by the attention the current block's queries give them at
        the layer right after the first skip stage, mean-pooled over
        ``sparse_kernel_size`` neighbours (edge padding); the top
        ``sparse_retention`` share is kept, every row tied with the last
        kept one included, and the block always.

        Rows the block can never attend -- pad prompt rows, rows an earlier
        eviction dropped (``kv_valid`` false; their page may be reclaimed),
        unmapped pages (their gathered rows are garbage-page content) and
        rows past the window -- are masked out of the probe's softmax and
        ranked below everything.  The caller ANDs the result with the
        carried set (sticky eviction).  Plain PyTorch in float32: the
        reference computes it in XLA, outside any Pallas kernel.

        Under the int8 cache the probe scores the int8 codes without their
        scales, as the reference does (it reads ``caches["kv"]["0"].k[g]``):
        a reference-side fault the port mirrors on purpose, so the retained
        sets stay equal to the JAX package's (ROADMAP.md Queue C)."""
        cand, in_block, n_keep = self._sparse_candidates(cache, hidden, bs, prompt_start, bt,
                                                         kv_valid)
        # a threshold, not a top-k: every row tied with the kth value is kept
        kth = torch.sort(cand, dim=-1).values[:, -n_keep][:, None]
        return (cand >= kth) | in_block

    def _sparse_candidates(self, cache, hidden, bs, prompt_start, bt, kv_valid):
        """The ranking :meth:`_sparse_evict` thresholds: ``(cand [B, T],
        in_block [B, T], n_keep)``, ``cand`` the pooled probe score, +inf on
        the block and -inf where the block cannot attend."""
        gen, cfg = self.gen, self.cfg
        b, t_total = kv_valid.shape
        lb = gen.block_length
        seg = next(s for s in self.segments if s.keep_k is not None)
        g = min(seg.group_hi, self.model.n_groups - 1)
        layer = self.model.layers[g]
        xq = rms_norm(hidden[seg.stage_idx].float(), layer.ln1, cfg.rms_eps) \
            @ layer.attn.wq.float()
        if layer.attn.bq is not None:
            xq = xq + layer.attn.bq.float()
        q = apply_rope(xq.view(b, lb, cfg.n_heads, cfg.head_dim), self._block_cols(bs),
                       theta=cfg.rope_theta, fraction=cfg.rope_fraction)
        k = cache.k[g]
        col = torch.arange(t_total, dtype=torch.int32, device=self.device)[None]
        attendable = kv_valid & (col >= prompt_start[:, None])
        if bt is not None:                       # paged: the pool's dense view
            k = ops.gather_pages(k, bt)
            attendable &= (bt >= 0).repeat_interleave(self.page_size, dim=1)
        wl = window_limit(gen, bs)
        if wl is not None:
            attendable &= col < wl[:, None]
        k = k.float().transpose(1, 2).repeat_interleave(cfg.n_heads // cfg.n_kv_heads, dim=1)
        scores = torch.einsum("bhqd,bhtd->bhqt", q.transpose(1, 2), k) / cfg.head_dim ** 0.5
        scores = torch.where(attendable[:, None, None, :], scores, NEG_INF)
        recv = torch.softmax(scores, dim=-1).mean(dim=(1, 2))           # [B, T]
        ks = gen.sparse_kernel_size
        pooled = recv
        if ks > 1:
            pad = ks // 2
            padded = torch.cat([recv[:, :1].expand(b, pad), recv,
                                recv[:, -1:].expand(b, pad)], dim=1)
            pooled = torch.stack([padded[:, i:i + t_total] for i in range(ks)], -1).mean(-1)
        in_block = self._in_block(bs, t_total)
        cand = torch.where(in_block, math.inf,
                           torch.where(attendable, pooled, -math.inf))
        return cand, in_block, int(gen.sparse_retention * (t_total - lb)) + lb

    # ------------------------------------------------------------------
    # page operations of the scheduler (paged serving)
    # ------------------------------------------------------------------
    def _pools(self, state: EngineState) -> tuple:
        """Every pool plane: K and V, then, int8, their scales; none on a
        pure SSM stack."""
        if not self.paged:
            raise ValueError("page operations need the paged KV pool (paged=True)")
        return tuple(split_cache(state.cache)[0] or ())

    def _page_index(self, pages) -> torch.Tensor:
        return torch.as_tensor(np.asarray(pages, np.int64).ravel(), device=self.device)

    def fork_pages(self, state: EngineState, src: Sequence[int],
                   dst: Sequence[int]) -> EngineState:
        """Copy-on-write fork: physical page ``src[i]`` is copied onto
        ``dst[i]`` in the K and V pools of every attention layer, and in
        their scale pools under the int8 cache, in place (one kernel launch
        on the card, and one more for the scale pools; none on a pure SSM
        stack, whose pool has no plane).  The scheduler calls it right before a refresh
        would scatter diverged content into a page shared by several slots,
        then repoints the forking slot's block table at ``dst``.  The lists
        are padded to a multiple of 8 with ``(0, 0)`` no-ops, as the
        reference pads them; a real destination may not also be a source."""
        src = np.asarray(src, np.int32).ravel()
        dst = np.asarray(dst, np.int32).ravel()
        if src.shape != dst.shape:
            raise ValueError(f"fork_pages: {src.size} sources but {dst.size} destinations")
        if src.size and self._pools(state):
            kv = split_cache(state.cache)[0]
            pad = np.zeros(-(-src.size // 8) * 8 - src.size, np.int32)
            ops.fork_pages(kv.k, kv.v, np.concatenate([src, pad]), np.concatenate([dst, pad]),
                           k_scale=kv.k_scale, v_scale=kv.v_scale)
        return state

    def spill_pages(self, state: EngineState, pages: Sequence[int]):
        """The exact bytes of physical ``pages`` (in that order) from every
        pool plane, copied to host memory: ``(k, v)``, each ``[n_attn, n, ps,
        Hkv, Dh]``, and under the int8 cache ``(k, v, k_scale, v_scale)``,
        the scales ``[n_attn, n, ps, Hkv]``; ``()`` on a pure SSM stack.  The pool is not modified; the pages can
        be released as soon as this returns."""
        idx = self._page_index(pages)
        return tuple(pool.index_select(1, idx).to("cpu", copy=True)
                     for pool in self._pools(state))

    def restore_pages(self, state: EngineState, pages: Sequence[int], data) -> EngineState:
        """Writes a ``spill_pages`` snapshot back onto physical ``pages``
        (same order as the spill), in place."""
        idx = self._page_index(pages)
        for pool, d in zip(self._pools(state), data):
            if d.shape[1] != idx.numel():
                raise ValueError(f"restore_pages: snapshot of {d.shape[1]} pages, "
                                 f"not {idx.numel()}")
            pool.index_copy_(1, idx, d.to(device=pool.device, dtype=pool.dtype))
        return state

    def scrub_pages(self, state: EngineState, pages: Sequence[int]) -> EngineState:
        """Zeroes physical ``pages`` in every pool plane, in place: a
        quarantined row's non-finite K/V (or scales) must not outlive it."""
        idx = self._page_index(pages)
        if idx.numel():
            for pool in self._pools(state):
                pool.index_fill_(1, idx, 0)
        return state

    def dead_pages(self, state: EngineState) -> torch.Tensor:
        """[B, n_vp] bool on the engine's device: mapped pages of active
        rows every row of which is dead (``kv_pos < 0``: sparse-evicted or
        pad) and that lie wholly before the row's current block.  As ``bs``
        only moves forward, the in-block retention can never revive them:
        nothing reads them again, and a refresh's scatter to them lands on
        the garbage page once they are unmapped."""
        ps = self.page_size
        b, t_total = state.kv_valid.shape
        col = torch.arange(t_total, dtype=torch.int32, device=self.device)[None]
        alive = state.kv_valid & (col >= state.prompt_start[:, None])
        page_alive = alive.view(b, t_total // ps, ps).any(dim=2)
        page_end = (torch.arange(t_total // ps, dtype=torch.int32, device=self.device) + 1) * ps
        settled = page_end[None] <= state.bs[:, None]
        return (state.block_tables >= 0) & ~page_alive & settled & state.active[:, None]

    def dead_page_report(self, state: EngineState) -> np.ndarray:
        """:meth:`dead_pages` on the host: the pages the scheduler unmaps
        and returns to the free list."""
        if not self.paged or state.block_tables is None:
            raise ValueError("dead_page_report needs the paged KV pool (paged=True)")
        return self.dead_pages(state).cpu().numpy()

    def prompt_refresh_rows(self, phases) -> np.ndarray:
        """[B] bool: which slots' next step is a prompt refresh, the only
        branch that scatters into the row's prompt pages, given the slots'
        phases.  The scheduler keys copy-on-write forks on it."""
        return np.asarray(prompt_refresh_pred(self.gen, np.asarray(phases, np.int64)), bool)


def _merge_step_outputs(mask: torch.Tensor, old, new):
    """Per-row merge of one pass's ``(cache, conf, pred, hidden, kv_valid,
    feat, stats)`` into the carried tuple: rows in ``mask`` take the pass's
    results.  The cache is taken as it is: the pass's K/V scatters and its
    SSM and cross cache writes (``model._store`` under the pass's row mask,
    where the reference merges those planes per row here) already left the
    other rows unwritten.  A retention set the
    pass handed back unchanged (every pass but a sparse refresh) is kept."""
    o_cache, o_conf, o_pred, o_hidden, o_kv, o_feat, o_stats = old
    n_cache, n_conf, n_pred, n_hidden, n_kv, n_feat, n_stats = new
    m1, m2 = mask[:, None], mask[:, None, None]
    return (
        n_cache,
        torch.where(m1, n_conf, o_conf),
        torch.where(m1, n_pred, o_pred),
        tuple(torch.where(m2, n, o) for o, n in zip(o_hidden, n_hidden)),
        o_kv if n_kv is o_kv else torch.where(m1, n_kv, o_kv),
        None if o_feat is None else torch.where(m2, n_feat, o_feat),
        o_stats if n_stats is None else torch.where(m1, n_stats, o_stats),
    )


def _top_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices [B, k] of the k largest scores per row, largest first, ties to
    the lower index -- ``lax.top_k``'s order, which ``torch.topk`` does not
    promise."""
    return torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]


def make_engine(model: Model, gen: GenerationConfig, **kw) -> DiffusionEngine:
    return DiffusionEngine(model, gen, **kw)
