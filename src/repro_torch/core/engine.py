"""Diffusion-LLM generation engines of the port: vanilla, DualCache, ES-dLLM.

The offline block loop of the reference (``repro.core.engine``): the output
is generated block by block; within a block, denoising iterations run until
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
``lax.switch`` over three branches, the port runs a Python loop whose exit
check reads one host scalar per iteration, and branches in Python on the
phase.  The KV cache planes are updated in place by the scatter kernel.
Greedy decoding only; the serving state, sampling and the beyond-paper
cache features raise ``NotImplementedError`` (see ROADMAP.md).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import GenerationConfig
from repro_torch.core import sampler as smp
from repro_torch.core.schedule import (
    BLOCK_REFRESH,
    PREFILL,
    Segment,
    branch_index,
    resolve_segments,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.attention import KVCache
from repro_torch.models.model import ForwardCtx, Model

MODES = ("vanilla", "dualcache", "es")


class BlockState(NamedTuple):
    tokens: torch.Tensor             # [B, T] int32
    cache: Optional[KVCache]         # [G, B, T, Hkv, Dh] planes (None for vanilla)
    conf: torch.Tensor               # [B, Lb] f32 confidence cache
    pred: torch.Tensor               # [B, Lb] int32 predicted-token cache
    hidden: tuple                    # per skip stage: [B, Lb, d] f32 indicator cache
    t: int                           # iteration counter within the block


def _row_gather(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """buf[b, idx[b, k]] for [B, N] or [B, N, d] buffers."""
    idx = idx.long()
    if buf.dim() == 2:
        return torch.gather(buf, 1, idx)
    return torch.gather(buf, 1, idx[..., None].expand(-1, -1, buf.shape[-1]))


def _row_scatter(buf: torch.Tensor, new: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Out of place: a copy of ``buf`` with ``buf[b, idx[b, k]] = new[b, k]``."""
    idx = idx.long()
    if buf.dim() == 3:
        idx = idx[..., None].expand(-1, -1, buf.shape[-1])
    return buf.scatter(1, idx, new.to(buf.dtype))


def _unsupported(gen: GenerationConfig, kv_cache_dtype, paged) -> Optional[str]:
    if gen.mode not in MODES:
        return f"mode={gen.mode!r} (one of {MODES})"
    if gen.temperature > 0:
        return ("temperature > 0: sampled decoding needs the reference's threefry "
                "key chain (ROADMAP.md Queue A5)")
    for flag, what in ((gen.sparse_attention, "sparse_attention"),
                       (gen.adaptive_cache, "the adaptive feature cache"),
                       (gen.windowed, "window_blocks"),
                       (gen.block_causal, "block_causal"),
                       (kv_cache_dtype is not None, "the int8 KV cache"),
                       (paged, "paged=True")):
        if flag:
            return f"{what} is outside this slice of the port (ROADMAP.md open items)"
    return None


class DiffusionEngine:
    def __init__(
        self,
        model: Model,
        gen: GenerationConfig,
        *,
        device: str | torch.device | None = None,
        eos_id: int = 2,
        disallow_eos: bool = False,
        kv_cache_dtype: str | None = None,
        paged: bool = False,
    ):
        why = _unsupported(gen, kv_cache_dtype, paged)
        if why is not None:
            raise NotImplementedError(why)
        self.device = resolve_device(device)
        if self.device.type != model.device.type:
            raise ValueError(f"engine device {self.device} differs from the model's "
                             f"{model.device}")
        if gen.gen_length % gen.block_length:
            raise ValueError("gen_length must be a multiple of block_length")
        self.model = model
        self.cfg = model.cfg
        self.gen = gen
        self.eos_id = eos_id
        self.disallow_eos = disallow_eos
        self.mask_id = self.cfg.vocab_size          # first padded-vocab slot
        lb = gen.block_length
        if gen.mode == "es":
            self.segments, _ = resolve_segments(self.cfg, gen, lb)
        else:
            self.segments = [Segment(0, model.n_groups, None, None)]
        self.n_stages = sum(1 for s in self.segments if s.keep_k is not None)
        self.n_per_step = max(1, -(-lb // gen.resolved_steps()))
        # reporting: iterations of the last generate() and its final block's state
        self.iterations = 0
        self.last_state: Optional[BlockState] = None

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    @torch.no_grad()
    def generate(self, prompt: torch.Tensor) -> torch.Tensor:
        """Generates ``gen.gen_length`` tokens after ``prompt [B, P]``;
        returns the ``[B, P + gen_length]`` int32 tokens."""
        gen = self.gen
        b, p = prompt.shape
        lb = gen.block_length
        tokens = torch.cat([
            prompt.to(device=self.device, dtype=torch.int32),
            torch.full((b, gen.gen_length), self.mask_id, dtype=torch.int32,
                       device=self.device)], dim=1)
        # the KV cache carries across blocks; each block's first iteration
        # is a prefill that zeroes and rewrites it
        cache = self._init_cache(b, tokens.shape[1])
        self.iterations = 0
        for blk in range(gen.gen_length // lb):
            self.last_state = self._run_block(tokens, cache, p + blk * lb)
            tokens = self.last_state.tokens
        return tokens

    def make_block_state(self, tokens: torch.Tensor) -> BlockState:
        b, t_total = tokens.shape
        return self._block_state(tokens.to(device=self.device, dtype=torch.int32),
                                 self._init_cache(b, t_total))

    @torch.no_grad()
    def prefill(self, st: BlockState, bs: int) -> BlockState:
        """Cache initialization / prompt refresh as a standalone step."""
        return self._apply_unmask(st, bs, *self._prefill_step(st, bs))

    @torch.no_grad()
    def decode_iteration(self, st: BlockState, bs: int) -> BlockState:
        """One steady-state ES iteration (paper Alg. 1): skip decode."""
        return self._apply_unmask(st, bs, *self._decode_step(st, bs, skip=True))

    # ------------------------------------------------------------------
    # per-block loop
    # ------------------------------------------------------------------
    def _init_cache(self, b: int, t_total: int) -> Optional[KVCache]:
        if self.gen.mode == "vanilla":
            return None
        return self.model.init_cache(b, t_total)

    def _block_state(self, tokens, cache) -> BlockState:
        b, lb, d = tokens.shape[0], self.gen.block_length, self.cfg.d_model
        dev = self.device
        return BlockState(
            tokens=tokens, cache=cache,
            conf=torch.zeros((b, lb), dtype=torch.float32, device=dev),
            pred=torch.zeros((b, lb), dtype=torch.int32, device=dev),
            hidden=tuple(torch.zeros((b, lb, d), dtype=torch.float32, device=dev)
                         for _ in range(self.n_stages)),
            t=0)

    def _run_block(self, tokens, cache, bs: int):
        gen = self.gen
        st = self._block_state(tokens, cache)
        max_steps = gen.resolved_steps() + 1
        while st.t == 0 or (st.t < max_steps and self._any_masked(st, bs)):
            st = self._apply_unmask(st, bs, *self._iteration_outputs(st, bs))
            self.iterations += 1
        return st

    def _any_masked(self, st: BlockState, bs: int) -> bool:
        lb = self.gen.block_length
        return bool((st.tokens[:, bs:bs + lb] == self.mask_id).any().item())

    def _iteration_outputs(self, st: BlockState, bs: int):
        """Branch-dispatched compute for one denoising iteration at phase
        ``st.t``.  Returns ``(cache, conf, pred, hidden)``."""
        if self.gen.mode == "vanilla":
            conf, pred = self._vanilla_compute(st, bs)
            return st.cache, conf, pred, st.hidden
        branch = branch_index(self.gen, st.t)
        if branch == PREFILL:
            return self._prefill_step(st, bs)
        return self._decode_step(st, bs, skip=branch != BLOCK_REFRESH)

    def _apply_unmask(self, st: BlockState, bs: int, cache, conf, pred, hidden) -> BlockState:
        lb = self.gen.block_length
        blk_tok = st.tokens[:, bs:bs + lb]
        sel = smp.select_unmask(conf, blk_tok == self.mask_id, self.gen, self.n_per_step)
        tokens = st.tokens.clone()
        tokens[:, bs:bs + lb] = torch.where(sel, pred, blk_tok)
        return BlockState(tokens, cache, conf, pred, hidden, st.t + 1)

    # ------------------------------------------------------------------
    # branches
    # ------------------------------------------------------------------
    def _positions(self, b: int, n: int) -> torch.Tensor:
        """[B, n] int32 rows of 0..n-1 (positions, cache rows, block rows)."""
        return torch.arange(n, dtype=torch.int32, device=self.device)[None].expand(b, n).contiguous()

    def _prefill_step(self, st: BlockState, bs: int):
        """Full forward over the whole sequence: rebuilds the KV cache and
        the block's confidence/prediction/indicator caches (cache init and
        prompt refresh)."""
        model, lb = self.model, self.gen.block_length
        b, t_total = st.tokens.shape
        st.cache.k.zero_()
        st.cache.v.zero_()
        pos = self._positions(b, t_total)
        ctx = ForwardCtx(pos, "prefill", kv_pos=pos, slot_idx=pos)
        h = model.embed_tokens(st.tokens)
        hidden = []
        for seg in self.segments:
            h = model.run_layers(h, ctx, st.cache, group_lo=seg.group_lo,
                                 group_hi=seg.group_hi)
            if seg.keep_k is not None:
                hidden.append(h[:, bs:bs + lb].float())
        conf, pred = self._confidence(st, bs, model.logits(h[:, bs:bs + lb]))
        return st.cache, conf, pred, tuple(hidden)

    def _decode_step(self, st: BlockState, bs: int, *, skip: bool):
        """One diffusion iteration on the current block (paper Alg. 1).
        ``skip=True`` applies the early-skip schedule; ``skip=False`` is the
        block refresh (all block rows computed)."""
        model, gen = self.model, self.gen
        b, t_total = st.tokens.shape
        lb = gen.block_length
        h = model.embed_tokens(st.tokens[:, bs:bs + lb])
        s_idx = self._positions(b, lb)
        kv_pos = self._positions(b, t_total)
        hidden = list(st.hidden)
        for seg in self.segments:
            rows = bs + s_idx
            ctx = ForwardCtx(rows, "decode", kv_pos=kv_pos, slot_idx=rows)
            h = model.run_layers(h, ctx, st.cache, group_lo=seg.group_lo,
                                 group_hi=seg.group_hi)
            if seg.keep_k is not None:
                i = seg.stage_idx
                hf = h.float()
                scores = ops.importance_score(
                    hf, _row_gather(hidden[i], s_idx), _row_gather(st.conf, s_idx),
                    alpha=gen.alpha)
                hidden[i] = _row_scatter(hidden[i], hf, s_idx)
                if skip:
                    sel = _top_k(scores, seg.keep_k)
                    s_idx = torch.gather(s_idx, 1, sel)
                    h = _row_gather(h, sel)
        conf_new, pred_new = smp.confidence_and_pred(
            model.logits(h), self.cfg.vocab_size, self.mask_id)
        conf = _row_scatter(st.conf, conf_new, s_idx)
        pred = _row_scatter(st.pred, pred_new, s_idx)
        return st.cache, conf, pred, tuple(hidden)

    def _vanilla_compute(self, st: BlockState, bs: int):
        """Full-sequence forward, no caches (the original LLaDA loop)."""
        model, lb = self.model, self.gen.block_length
        b, t_total = st.tokens.shape
        h = model.run_layers(model.embed_tokens(st.tokens),
                             ForwardCtx(self._positions(b, t_total)))
        return self._confidence(st, bs, model.logits(h[:, bs:bs + lb]))

    def _confidence(self, st: BlockState, bs: int, logits_blk: torch.Tensor):
        if self.disallow_eos:
            masked = (st.tokens[:, bs:bs + self.gen.block_length] == self.mask_id).int()
            rev = masked.flip(1).cumsum(1).flip(1)
            logits_blk = smp.disallow_premature_eos(logits_blk, (rev - masked) > 0,
                                                    self.eos_id)
        return smp.confidence_and_pred(logits_blk, self.cfg.vocab_size, self.mask_id)


def _top_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices [B, k] of the k largest scores per row, largest first, ties to
    the lower index -- ``lax.top_k``'s order, which ``torch.topk`` does not
    promise."""
    return torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]


def make_engine(model: Model, gen: GenerationConfig, **kw) -> DiffusionEngine:
    return DiffusionEngine(model, gen, **kw)
