"""The port's model: attention-only stacks with a dense or an MoE FFN (LLaDA,
Dream, Llama-3, Qwen2, ChatGLM3, Gemma-3 with its local:global windows;
OLMoE, Granite-MoE), pure SSM (Mamba-2), the hybrid (Jamba: attention,
SSM and MoE layers in a period of 8) and the encoder-conditioned stacks
with cross-attention layers (Llama-3.2-Vision: one in a period of 5;
SeamlessM4T: every layer, after a 6-layer encoder).

Layers come in *groups* of ``cfg.pattern_period`` (P) layers, as in the
reference, where ``params["layers"][str(j)]`` stacks pattern position j over
the ``G = n_layers / P`` groups; here ``layers[g*P + j]`` is that layer.
``run_layers(h, ctx, cache, group_lo, group_hi)`` runs a *segment* of
groups, so the engine can stop at a skip boundary, shrink the active set and
continue, as the reference's ``lax.scan`` over groups does; here a Python
loop over the layers does.  Cache modes (``ForwardCtx.mode``):

  * ``nocache`` -- the vanilla engine: fresh K/V, the full SSD scan, no cache;
  * ``prefill`` -- write-through: every row scattered into the KV cache,
    which is then attended; an SSM layer captures its state and conv tail
    at the block start, and block rows into ``ssmh`` (below);
  * ``decode``  -- one diffusion iteration: only the active rows scattered,
    the whole cache attended; an SSM layer scatters the active rows into
    ``ssmh``, runs the mixer over that whole block from the cached
    block-start state and gathers the active rows back (the reference's
    dense rejoin).

Every layer of a hybrid has an FFN after its attention or mixer (the experts
where ``cfg.layer_is_moe``); a pure SSM stack's layers have none.  A
cross layer (``cfg.layer_kind(l) == "cross"``) has no self-attention: its
``lnx`` + ``xattn`` attend the encoder output ``ForwardCtx.enc_out``,
scaled by ``tanh(gate_attn)``, then ``ln2`` + the FFN.  ``Model.encode``
makes ``enc_out`` from a request's stub frontend embeddings: the vision
model projects them (``enc_proj``, where ``d_enc != d_model``), SeamlessM4T
runs its ``Encoder`` over them.

The K/V planes cover the attention layers only (``Model.kv_plane[l]`` is
layer l's): ``KVCache(k, v)`` of ``[n_attn, B, S, Hkv, Dh]`` planes, or of
``[n_attn, P, ps, Hkv, Dh]`` page pools shared by every slot and addressed
through ``ForwardCtx.block_tables`` (paged serving), or ``QuantKVCache``
with ``k_scale``/``v_scale`` planes beside int8 codes.  The ``SSMCache``
planes (``state``, ``conv_tail``, ``ssmh``) cover the SSM layers
(``Model.ssm_plane``) and stay per slot when K/V is paged, the reference's
rule.  An attention-only stack's cache is its K/V cache, a pure SSM stack's
its ``SSMCache``, a hybrid's ``HybridCache(kv, ssm)``, a stack with cross
layers ``EncDecCache(kv, cross)``: ``cross`` holds ``[n_cross, B, E, Hkv,
Dh]`` K/V planes over the cross layers (``Model.cross_plane``), per slot
and dense even when K/V is paged, as in the reference; ``kv`` is None on
SeamlessM4T, whose decoder has no self-attention.  A prefill projects each
cross layer's K/V from ``enc_out`` and stores them; a decode reads them.
Every plane is written in place; under a ``scatter_mask`` only the owned
rows are written.

Training (``repro_torch.train``) runs the stack in ``nocache`` mode on the
plain versions of attention and the SSD scan (``ForwardCtx.attn_impl =
"plain"``; the kernels have no backward, as the reference trains on its XLA
lowerings), with ``run_layers(..., with_aux=True)`` summing the MoE layers'
load-balance losses and ``ForwardCtx.remat`` recomputing each group (each
layer where ``P > 1``) in the backward pass.  ``Model.forward`` is one such
pass to logits.

Tensor parallelism (``Model(cfg, mesh=...)``, a ``DeviceMesh`` with a
``model`` axis): each rank holds its shard of every parameter, cut by
``sharding/specs.py``'s serving rules from the full leaf (whole query and KV
heads, whole ``d_ff`` columns, whole experts, whole SSM heads, a slice of
the padded vocab; norms, the router, the mixer's B/C projections and
``enc_proj`` whole).  The attention and cross-attention outputs after
``wo``, the MLP after ``w_down``, the MoE combine and the mixer's output
after ``out_proj`` (and its gated norm's sum of squares) are summed over the
ranks (``sharding/comm.py``), in the encoder's layers too; the embedding is
a masked local lookup, then a sum, and the logits are gathered to the full
vocab, so every rank holds the same hidden states, encoder output, logits
and tokens, and every host decision above the stack reads replicated
values.  The K/V, cross and SSM planes hold the rank's heads.

Training over a mesh (``Model(cfg, mesh=..., mode="train")``) differentiates
through those sums (*g*, ``sharding/comm.py``) and sums the gradient of
each value the ranks hold alike where it enters a rank's own part (*f*:
the normed inputs of attention, the MLP, the experts and the mixer,
``attn_in``, ``mlp_in``, ``moe_in``, ``ssm_in``; the head's input,
``head_in``; a cross layer's query input and ``enc_out``, ``cross_in`` and
``enc_in``; inside the MoE and the mixer, ``moe_gates``, ``ssm_bc`` and
``ssm_rms``).  Its parameters are cut over ``data`` too and gathered as
each layer runs (``sharding/fsdp.py``: ``run_layers`` reads a layer through
``fsdp.view``, inside the layer's checkpoint), and the MoE aux loss is
averaged over the batch axes (``Model.dp``).

Prefill stores each SSM layer's block rows of ``h`` after the mixer's
residual (before a hybrid layer's FFN) in ``ssmh``, while a decode scatters
the layer's *input* rows into it and runs the mixer on that buffer as the
layer's input: the reference does so (``repro/models/model.py:_apply_ssm``),
and the port mirrors it so that its tokens stay equal to the reference's
(ROADMAP.md Queue C).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.attention import (
    Attention,
    KVCache,
    PagedKVCache,
    QuantKVCache,
    _param,
    cross_attention,
    self_attention,
)
from repro_torch.models.common import (
    mlp_apply,
    padded_vocab,
    rms_norm,
    rope_tables,
    row_gather,
    row_scatter,
)
from repro_torch.models.mamba import Mixer, SSMCache, SSMState, mamba_apply, mamba_dims
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.sharding import specs
from repro_torch.sharding.comm import TPGroup, tp_enter, tp_sum
from repro_torch.sharding.fsdp import FSDP, view

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_supported(cfg: ModelConfig) -> None:
    """Raises NotImplementedError for archs outside the port so far."""
    kinds = {cfg.layer_kind(l) for l in range(cfg.n_layers)}
    ssm_family = cfg.ssm is not None and cfg.family in ("ssm", "hybrid")
    if ("ssm" in kinds) != ssm_family or cfg.logit_softcap:
        raise NotImplementedError(
            f"{cfg.name}: the port covers attention-only stacks (dense or MoE FFN, per-layer "
            f"windows), pure SSM stacks, attention/SSM hybrids and stacks with "
            f"cross-attention layers, without logit soft-capping; see ROADMAP.md Queue A")
    for field in ("param_dtype", "compute_dtype"):
        if getattr(cfg, field) not in DTYPES:
            raise NotImplementedError(f"{field}={getattr(cfg, field)!r}: float32 or bfloat16")


def layer_window(cfg: ModelConfig, layer: int, window_override: int = 0) -> int:
    """Layer ``layer``'s local attention window, 0 for none: the reference's
    ``window_meta``, with 0 where it has ``BIG_WINDOW`` (a global layer of a
    local:global interleave, or a stack without windows), which masks the
    same keys below 2**30 positions and keeps the kernels off their options
    path.  A non-zero ``window_override`` caps every layer's."""
    w = cfg.sliding_window if cfg.sliding_window and not cfg.layer_is_global_attn(layer) else 0
    if window_override:
        w = min(w, window_override) if w else window_override
    return w


class HybridCache(NamedTuple):
    """A hybrid stack's caches: the K/V planes or pools over its attention
    layers and the per-slot ``SSMCache`` over its SSM layers."""
    kv: KVCache | QuantKVCache
    ssm: SSMCache


class EncDecCache(NamedTuple):
    """The caches of a stack with cross layers: the K/V planes or pools over
    its self-attention layers (None on a stack without any) and the per-slot
    cross planes ``[n_cross, B, E, Hkv, Dh]`` in the parameter dtype."""
    kv: Optional[KVCache | QuantKVCache]
    cross: KVCache


def split_cache(cache) -> tuple[Optional[KVCache | QuantKVCache], Optional[SSMCache]]:
    """``(K/V planes or None, SSM caches or None)`` of any stack's cache."""
    if cache is None:
        return None, None
    if isinstance(cache, HybridCache):
        return cache.kv, cache.ssm
    if isinstance(cache, EncDecCache):
        return cache.kv, None
    if isinstance(cache, SSMCache):
        return None, cache
    return cache, None


def cross_cache(cache) -> Optional[KVCache]:
    """The cross planes of a stack with cross layers, else None."""
    return cache.cross if isinstance(cache, EncDecCache) else None


def cache_planes(cache) -> tuple[torch.Tensor, ...]:
    """Every tensor of a cache: K/V planes (and scales), SSM planes, then
    cross planes."""
    kv, ssm = split_cache(cache)
    return tuple(kv or ()) + tuple(ssm or ()) + tuple(cross_cache(cache) or ())


@dataclasses.dataclass
class ForwardCtx:
    positions: torch.Tensor                    # [B, K] int32 global positions of rows
    mode: str = "nocache"                      # nocache | prefill | decode
    kv_pos: Optional[torch.Tensor] = None      # [B, S] int32 cache validity (-1 invalid)
    slot_idx: Optional[torch.Tensor] = None    # [B, K] int32 cache rows to scatter
    block_tables: Optional[torch.Tensor] = None   # [B, n_vp] int32 page map: the cache
                                                  # is a pool (its dim 1 is the page size)
    scatter_mask: Optional[torch.Tensor] = None   # [B] bool: rows whose K/V scatters
                                                  # land (mixed-mode cadence)
    refresh_mask: Optional[torch.Tensor] = None   # [B, K] bool: tokens whose K/V
                                                  # scatters land (partial refresh)
    block_idx: Optional[torch.Tensor] = None      # [B, K] int32 block-local rows (SSM
                                                  # decode: the dense rejoin)
    block_start: Optional[torch.Tensor] = None    # [B] int32 block start (SSM prefill:
                                                  # the state capture)
    window_limit: Optional[torch.Tensor] = None   # [B] int32 sliding-window horizon
                                                  # (core.schedule.window_limit): kv
                                                  # positions at or past it are not read
    window_override: int = 0                      # caps every layer's local window
    anchor: int = 0                               # positions below it bypass the window
    bc_start: int = 0                             # block-causal: first generation position
    bc_block: int = 0                             # block-causal block length; 0 = off
    enc_out: Optional[torch.Tensor] = None        # [B, E, d_out] encoder output
                                                  # (Model.encode): a prefill's or a
                                                  # cacheless pass's cross K/V
    attn_impl: str = "kernel"                     # attention and SSD scan: "kernel"
                                                  # (by device) or "plain" (training)
    remat: bool = False                           # recompute groups in the backward
                                                  # (nocache passes only)


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, device, dtype):
        super().__init__()
        self.w_gate = _param((d_model, d_ff), device, dtype)
        self.w_up = _param((d_model, d_ff), device, dtype)
        self.w_down = _param((d_ff, d_model), device, dtype)


class Block(nn.Module):
    """The reference's ``init_one_layer``: ``ln1`` + attention, or ``ln1`` +
    mixer on an SSM layer, or on a cross layer ``lnx`` + cross-attention
    and its f32 scalar ``gate_attn``; then ``ln2`` + the FFN (a gated MLP,
    or the experts where ``cfg.layer_is_moe``) on every layer but those of
    a pure SSM stack."""

    def __init__(self, cfg: ModelConfig, layer: int, device, dtype):
        super().__init__()
        self.kind = cfg.layer_kind(layer)
        if self.kind == "cross":
            self.lnx = _param((cfg.d_model,), device, dtype)
            # the vision model's patch embeddings are projected to d_model
            # before the cross-attention reads them
            kv_width = cfg.d_model if cfg.family == "vlm" else (cfg.d_enc or cfg.d_model)
            self.xattn = Attention(cfg, device, dtype, cross=True, kv_width=kv_width)
            self.gate_attn = _param((), device, torch.float32)
        else:
            self.ln1 = _param((cfg.d_model,), device, dtype)
        if self.kind == "ssm":
            self.mixer = Mixer(cfg, device, dtype)
        elif self.kind == "attn":
            self.attn = Attention(cfg, device, dtype)
        self.moe = cfg.layer_is_moe(layer)
        self.ffn = None
        if self.kind != "ssm" or cfg.family == "hybrid":
            self.ln2 = _param((cfg.d_model,), device, dtype)
            self.ffn = (MoE(cfg, device, dtype) if self.moe
                        else MLP(cfg.d_model, cfg.d_ff, device, dtype))


class Encoder(nn.Module):
    """The modality encoder (SeamlessM4T): ``n_encoder_layers`` blocks of
    ``ln1``, self-attention with RoPE and no bias, ``ln2`` and a gated MLP,
    at width ``d_enc``, then ``final_norm``; non-causal over positions
    ``0..E-1``, with no cache (the reference's ``Model.encode``)."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        # the reference's enc_cfg (width d_enc, no qkv bias), every layer a
        # self-attention layer with a dense MLP
        self.cfg = dataclasses.replace(cfg, d_model=cfg.d_enc, qkv_bias=False, cross_every=0,
                                       moe=None, ssm=None, attn_every=0, family="dense")
        self.layers = nn.ModuleList(Block(self.cfg, l, device, dtype)
                                    for l in range(cfg.n_encoder_layers))
        self.final_norm = _param((cfg.d_enc,), device, dtype)

    def forward(self, h: torch.Tensor, impl: str = "kernel",
                tp: Optional[TPGroup] = None, fsdp: Optional[FSDP] = None) -> torch.Tensor:
        """With ``tp`` each layer holds a rank's heads and ``d_ff`` columns,
        and its attention and MLP outputs are summed over the ranks (their
        inputs' gradients too, ``attn_in`` and ``mlp_in``); with ``fsdp``
        each layer's leaves are gathered as it runs."""
        cfg = self.cfg
        b, e, _ = h.shape
        pos = torch.arange(e, dtype=torch.int32, device=h.device)[None].expand(b, e).contiguous()
        rope = rope_tables(pos, cfg.head_dim, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
        for i, layer in enumerate(self.layers):
            layer = view(layer, f"encoder.layers.{i}.", fsdp)
            x = tp_enter(tp, rms_norm(h, layer.ln1, cfg.rms_eps), "attn_in")
            h = h + tp_sum(tp, self_attention(layer.attn, cfg, x, pos, rope=rope, impl=impl),
                           "attn")
            x = tp_enter(tp, rms_norm(h, layer.ln2, cfg.rms_eps), "mlp_in")
            h = h + tp_sum(tp, mlp_apply(layer.ffn, x, cfg.act), "mlp")
        final_norm = view(self, "encoder.", fsdp).final_norm
        return rms_norm(h, final_norm, cfg.rms_eps)


def _store(dst: torch.Tensor, new: torch.Tensor, row_mask: Optional[torch.Tensor]) -> None:
    """In place ``dst[:] = new`` on the rows of ``row_mask`` (all rows without
    one): a pass leaves the SSM and cross caches of the rows it does not own
    as they were, as the reference's per-row merge of a pass's outputs does."""
    new = new.to(dst.dtype)
    if row_mask is not None:
        new = torch.where(row_mask.view((-1,) + (1,) * (new.dim() - 1)), new, dst)
    dst.copy_(new)


class Model(nn.Module):
    """Parameters are allocated (uninitialised) on ``device``; fill them with
    :meth:`init` or ``load_state_dict(convert.params_from_numpy(...))``."""

    def __init__(self, cfg: ModelConfig, *, device: str | torch.device | None = None,
                 mesh=None, mode: str = "serve"):
        super().__init__()
        cfg.validate()
        check_supported(cfg)
        if mode not in ("serve", "train"):
            raise ValueError(f"mode={mode!r}: 'serve' or 'train'")
        self.cfg = cfg
        self.mode = mode
        self.device = resolve_device(device)
        self.tp = TPGroup.from_mesh(mesh)
        self.dtype = DTYPES[cfg.param_dtype]
        self.compute_dtype = DTYPES[cfg.compute_dtype]
        self.period = cfg.pattern_period
        self.n_groups = cfg.n_layers // self.period
        kinds = [cfg.layer_kind(l) for l in range(cfg.n_layers)]
        self.attn_layers = [l for l, k in enumerate(kinds) if k == "attn"]
        self.ssm_layers = [l for l, k in enumerate(kinds) if k == "ssm"]
        self.cross_layers = [l for l, k in enumerate(kinds) if k == "cross"]
        # layer -> its plane in the K/V, the SSM or the cross caches
        self.kv_plane = {l: i for i, l in enumerate(self.attn_layers)}
        self.ssm_plane = {l: i for i, l in enumerate(self.ssm_layers)}
        self.cross_plane = {l: i for i, l in enumerate(self.cross_layers)}
        self.ssm = bool(self.ssm_layers)       # the stack has SSM layers
        self.cross = bool(self.cross_layers)   # the stack has cross layers
        # a tensor-parallel model is laid out at full size on the meta device
        # and each parameter then replaced by the rank's shard
        dev = torch.device("meta") if self.tp is not None else self.device
        vp = padded_vocab(cfg)
        self.embed = _param((vp, cfg.d_model), dev, self.dtype)
        self.final_norm = _param((cfg.d_model,), dev, self.dtype)
        # tied embeddings: the head is embed.T, there is no lm_head
        self.lm_head = (None if cfg.tie_embeddings
                        else _param((cfg.d_model, vp), dev, self.dtype))
        self.layers = nn.ModuleList(Block(cfg, l, dev, self.dtype) for l in range(cfg.n_layers))
        self.encoder = Encoder(cfg, dev, self.dtype) if cfg.n_encoder_layers else None
        # the vision model's patch projection, only where the widths differ
        self.enc_proj = (_param((cfg.d_enc, cfg.d_model), dev, self.dtype)
                         if cfg.family == "vlm" and cfg.d_enc and cfg.d_enc != cfg.d_model
                         else None)
        # name -> (full shape, spec) of each parameter a rank holds a shard of
        self.shards: dict = {}
        self.fsdp: Optional[FSDP] = None
        # the layer of the batch axes (pod, data) a training loss sums over,
        # None without more than one batch piece
        self.dp: Optional[FSDP] = None
        if self.tp is not None:
            self._shard(mesh)
            self.dp = self.fsdp if self.fsdp.batch_size > 1 else None

    def tp_mesh(self) -> tuple[dict, dict]:
        """``({axis: size}, {axis: coordinate})`` of the axes a rank's
        parameters are cut over: ``model``, and ``data`` in the train mode
        (one rank without a mesh)."""
        if self.fsdp is None:
            return {"model": 1}, {"model": 0}
        return ({a: self.fsdp.sizes.get(a, 1) for a in self._param_axes()},
                {a: self.fsdp.coords.get(a, 0) for a in self._param_axes()})

    def _param_axes(self) -> tuple:
        return ("model", "data") if self.mode == "train" else ("model",)

    def _shard(self, mesh) -> None:
        """Replaces each meta parameter by an uninitialised shard on the
        model's device, cut by ``sharding/specs.py``'s rules of the model's
        mode (the train mode adds ``d`` on ``data``).  A leaf the
        tensor-parallel forward reads as a shard (every one but the norms
        and those it reads whole: the router, the mixer's ``bc_proj`` and
        ``conv_bc``, ``enc_proj``) must have been cut over ``model``: a rule
        that fell back to replication (an indivisible ``d_ff``, experts or
        vocab) raises, where the sums would otherwise count it ``model``
        times."""
        m, sizes = self.tp.size, specs.axis_sizes(mesh)
        sizes = {a: sizes.get(a, 1) for a in self._param_axes()}
        layout = {}
        for name, p in list(self.named_parameters()):
            shape = tuple(p.shape)
            tp_spec = specs.port_param_spec(name, shape, {"model": m}, self.cfg.head_dim,
                                            ssm=self.cfg.ssm)
            whole = name.rsplit(".", 1)[-1] in ("router", "bc_proj", "conv_bc", "enc_proj")
            if not any(tp_spec) and p.dim() >= 2 and not whole:
                raise ValueError(f"{name} {shape} does not divide over model={m}")
            spec = specs.port_param_spec(name, shape, sizes, self.cfg.head_dim, mode=self.mode,
                                         ssm=self.cfg.ssm)
            mod, _, leaf = name.rpartition(".")
            setattr(self.get_submodule(mod) if mod else self, leaf,
                    _param(specs.local_shape(shape, spec, sizes), self.device, p.dtype))
            layout[name] = (shape, spec)
            if any(spec):
                self.shards[name] = (shape, spec)
        self.fsdp = FSDP(mesh, layout)

    def _leaf(self, name: str) -> torch.Tensor:
        """Top-level leaf ``name`` as the forward reads it (gathered over
        ``data`` in the train mode)."""
        return getattr(view(self, "", self.fsdp), name)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Random init with the reference's scheme (normal x 0.02, the
        router too, output projections and each expert's ``w_down``
        0.02/sqrt(2L), the encoder's ``w_down`` with its own depth, norms
        and ``gate_attn`` 1, biases 0; the mixer's conv taps x 0.2,
        ``a_log`` 0, ``dt_bias`` -1, ``d_skip`` 1) but torch's numbers:
        the values differ from ``repro``'s for the same seed.  ``generator``
        lives on the model's device, so a model on the card is initialised
        there."""
        out_scale = 0.02 / max(2.0 * self.cfg.n_layers, 1.0) ** 0.5
        enc_scale = 0.02 / max(2.0 * self.cfg.n_encoder_layers, 1.0) ** 0.5
        sizes, coords = self.tp_mesh()
        for name, shard in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            # a sharded leaf is drawn whole, one at a time, and cut: the
            # rank's shard of the weights a model without a mesh draws
            full_shape, spec = self.shards.get(name, (None, None))
            p = shard if spec is None else torch.empty(full_shape, dtype=shard.dtype,
                                                       device=shard.device)
            if leaf in ("final_norm", "ln1", "ln2", "lnx", "gate_attn", "norm_scale", "d_skip"):
                p.fill_(1.0)
            elif name.startswith("encoder.") and leaf == "w_down":
                p.normal_(0.0, enc_scale, generator=generator)
            elif leaf in ("bq", "bk", "bv", "conv_xb", "conv_bcb", "a_log"):
                p.zero_()
            elif leaf == "dt_bias":
                p.fill_(-1.0)
            else:
                std = {"wo": out_scale, "w_down": out_scale, "out_proj": out_scale,
                       "conv_x": 0.2, "conv_bc": 0.2}.get(leaf, 0.02)
                p.normal_(0.0, std, generator=generator)
            if spec is not None:
                shard.copy_(specs.local_slice(p, spec, sizes, coords))
        return self

    def init_cache(self, batch: int, seq_len: int, *, block_len: int = 0, kv_pages: int = 0,
                   page_size: int = 0, kv_dtype: Optional[str] = None):
        """Zeroed caches.  K/V planes over the attention layers in the
        parameter dtype, ``[n_attn, B, S, Hkv, Dh]``, or with ``kv_pages``
        the page pool ``[n_attn, kv_pages, page_size, Hkv, Dh]`` shared by
        every slot (page 0 is the garbage page); ``kv_dtype="int8"`` makes
        them a ``QuantKVCache``: int8 codes with f32 scale planes
        ``[n_attn, B, S, Hkv]`` (``[n_attn, kv_pages, page_size, Hkv]``).
        The SSM layers' ``SSMCache`` has ``block_len`` rows of ``ssmh`` per
        slot and is per slot whether K/V is paged or not (nothing in it
        grows with the sequence).  The cross planes ``[n_cross, B,
        n_enc_tokens, Hkv, Dh]`` are per slot and dense too, in the
        parameter dtype under the int8 cache as well.  Returns the K/V cache
        of an attention-only stack, the ``SSMCache`` of a pure SSM stack, an
        ``EncDecCache`` of a stack with cross layers and a ``HybridCache``
        otherwise."""
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_cache_dtype={kv_dtype!r}: None or 'int8'")
        cfg = self.cfg
        ssm = kv = None
        # a rank's planes hold its heads (``sharding/specs.py``'s cache rules)
        sizes = {"model": self.tp_mesh()[0]["model"]}

        def zeros(kind: str, full: tuple, dtype, **kw) -> torch.Tensor:
            shape = specs.local_shape(full, specs.cache_leaf_spec(kind, full, sizes, **kw), sizes)
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if self.ssm_layers:
            if block_len <= 0:
                raise ValueError("the SSM caches need block_len > 0")
            s, dims = cfg.ssm, mamba_dims(cfg)
            n = len(self.ssm_layers)
            ssm = SSMCache(
                zeros("ssm", (n, batch, dims["n_heads"], s.d_state, s.headdim), torch.float32),
                zeros("ssm", (n, batch, s.conv_width - 1, dims["conv_ch"]), self.dtype,
                      d_inner=dims["d_inner"]),
                zeros("ssmh", (n, batch, block_len, cfg.d_model), self.dtype))
        if kv_pages and (page_size <= 0 or seq_len % page_size):
            raise ValueError(f"page_size {page_size} must divide the sequence {seq_len}")
        if self.attn_layers:
            n = len(self.attn_layers)
            full = ((n, kv_pages, page_size) if kv_pages else (n, batch, seq_len)) \
                + (cfg.n_kv_heads, cfg.head_dim)
            paged = bool(kv_pages)
            if kv_dtype == "int8":
                kv = QuantKVCache(zeros("kv", full, torch.int8, paged=paged),
                                  zeros("kv", full, torch.int8, paged=paged),
                                  zeros("kv", full[:-1], torch.float32, paged=paged),
                                  zeros("kv", full[:-1], torch.float32, paged=paged))
            else:
                kv = KVCache(zeros("kv", full, self.dtype, paged=paged),
                             zeros("kv", full, self.dtype, paged=paged))
        if self.cross_layers:
            full = (len(self.cross_layers), batch, cfg.n_enc_tokens, cfg.n_kv_heads,
                    cfg.head_dim)
            return EncDecCache(kv, KVCache(*(zeros("cross", full, self.dtype) for _ in "kv")))
        if ssm is None:
            return kv
        return ssm if kv is None else HybridCache(kv, ssm)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return self.embed[tokens.long()].to(self.compute_dtype)
        # the rank's rows of the vocab-sharded embedding, zero elsewhere, summed
        embed = self._leaf("embed")
        n = embed.shape[0]
        local = tokens.long() - self.tp.rank * n
        mine = (local >= 0) & (local < n)
        rows = embed[torch.where(mine, local, 0)].to(self.compute_dtype)
        return self.tp.all_reduce_sum(torch.where(mine[..., None], rows, 0), "embed")

    def encode(self, enc_embeds: torch.Tensor, impl: str = "kernel") -> torch.Tensor:
        """The encoder output ``[B, E, d_out]`` of stub frontend embeddings
        ``[B, E, d_enc]``, in the compute dtype (the reference's
        ``Model.encode``): the vision model's projection to ``d_model`` (or
        the embeddings as they are where the widths agree), SeamlessM4T's
        encoder stack; other stacks return the embeddings unchanged, and no
        layer reads them.  ``impl`` is the encoder attention's."""
        x = enc_embeds.to(device=self.device, dtype=self.compute_dtype)
        if self.cfg.family == "vlm":
            return x if self.enc_proj is None else x @ self._leaf("enc_proj")
        if self.encoder is None:
            return x
        # called as a function, as every other layer of the stack: no module
        # hooks (the dry run's memory tracker hooks every module it sees)
        return self.encoder.forward(x, impl, tp=self.tp, fsdp=self.fsdp)

    def head(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(final_norm, the head [d, Vp])`` as :meth:`logits` reads them:
        ``embed.T`` where the embeddings are tied (gathered over ``data`` in
        the train mode; the chunked CE reads them once for all its
        chunks)."""
        if self.lm_head is None:
            return self._leaf("final_norm"), self._leaf("embed").T
        return self._leaf("final_norm"), self._leaf("lm_head")

    def logits(self, h: torch.Tensor, head: Optional[tuple] = None) -> torch.Tensor:
        """Full-vocab logits of pre-head hidden states; ``head`` is
        :meth:`head`'s, where the caller has it."""
        final_norm, w = self.head() if head is None else head
        h = tp_enter(self.tp, rms_norm(h, final_norm, self.cfg.rms_eps), "head_in")
        out = h @ w.to(h.dtype)
        return out if self.tp is None else self.tp.gather_vocab(out)

    def forward(self, tokens: torch.Tensor, *, enc_embeds: Optional[torch.Tensor] = None,
                impl: str = "plain", remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """One cacheless pass over ``tokens [B, L]`` at positions ``0..L-1``
        -> ``(logits [B, L, Vp], aux)``, aux the MoE layers' summed
        load-balance loss (the reference's ``Model.forward``).  ``impl``
        defaults to the differentiable plain versions, as the reference's
        to its XLA lowerings."""
        b, l = tokens.shape
        h = self.embed_tokens(tokens.to(self.device))
        enc_out = None if enc_embeds is None else self.encode(enc_embeds, impl)
        pos = torch.arange(l, dtype=torch.int32, device=self.device)[None].expand(b, l)
        ctx = ForwardCtx(positions=pos.contiguous(), enc_out=enc_out, attn_impl=impl,
                         remat=remat)
        h, aux = self.run_layers(h, ctx, with_aux=True)
        return self.logits(h), aux

    def run_layers(self, h: torch.Tensor, ctx: ForwardCtx, cache=None, *, group_lo: int = 0,
                   group_hi: Optional[int] = None, with_aux: bool = False):
        """Runs the layers of groups ``[group_lo, group_hi)`` on ``h [B, K,
        d]``; in the prefill/decode modes the caches are updated in place.
        The RoPE tables, the sliding window's clamp of ``kv_pos`` and its
        read view of the block table are made once here for the whole
        segment.  With ``with_aux`` it returns ``(h, aux)``, aux the f32 sum
        of the MoE layers' load-balance losses, in layer order (the
        reference's ``SegmentOut.aux_loss``).  Under ``ctx.remat`` each group
        runs in ``torch.utils.checkpoint``, and each layer in it where ``P >
        1`` (the reference's ``jax.checkpoint`` of its scan body and, on
        Jamba, of each layer): the backward recomputes the activations, and
        no value changes."""
        cfg = self.cfg
        group_hi = self.n_groups if group_hi is None else group_hi
        if not 0 <= group_lo < group_hi <= self.n_groups:
            raise ValueError(f"bad layer segment [{group_lo}, {group_hi})")
        use_cache = ctx.mode in ("prefill", "decode") and cache is not None
        if ctx.remat and use_cache:
            raise ValueError("remat recomputes cacheless passes only")
        kv_cache, ssm_cache = split_cache(cache) if use_cache else (None, None)
        x_cache = cross_cache(cache) if use_cache else None
        rope = kv_pos = read_bt = None
        if self.attn_layers:
            rope = rope_tables(ctx.positions, cfg.head_dim, theta=cfg.rope_theta,
                               fraction=cfg.rope_fraction)
            kv_pos = ctx.kv_pos
            if kv_cache is not None and ctx.window_limit is not None:
                kv_pos = ops.window_kv_clamp(kv_pos, ctx.window_limit)
                if ctx.block_tables is not None:
                    read_bt = ops.window_block_tables(ctx.block_tables, ctx.window_limit,
                                                      kv_cache.k.shape[2])

        def run_layer(l: int, h: torch.Tensor, aux: Optional[torch.Tensor]):
            # in the train mode the layer's leaves are gathered here, inside
            # its checkpoint, so the remat's recompute gathers them again
            layer = view(self.layers[l], f"layers.{l}.", self.fsdp)
            if layer.kind == "ssm":
                h = self._apply_ssm(layer, self.ssm_plane[l], h, ctx, ssm_cache)
            elif layer.kind == "cross":
                h = self._apply_cross(layer, self.cross_plane[l], h, ctx, x_cache)
            else:
                kv = kv_cache.layer(self.kv_plane[l]) if kv_cache is not None else None
                if kv is not None and ctx.block_tables is not None:
                    kv = PagedKVCache(kv, ctx.block_tables, read_bt)
                x = tp_enter(self.tp, rms_norm(h, layer.ln1, cfg.rms_eps), "attn_in")
                h = h + tp_sum(self.tp, self_attention(
                    layer.attn, cfg, x, ctx.positions,
                    cache=kv, slot_idx=ctx.slot_idx, kv_pos=kv_pos, rope=rope,
                    scatter_mask=ctx.scatter_mask, token_mask=ctx.refresh_mask,
                    window=layer_window(cfg, l, ctx.window_override), anchor=ctx.anchor,
                    bc_start=ctx.bc_start, bc_block=ctx.bc_block, impl=ctx.attn_impl), "attn")
            if layer.ffn is not None:
                hn = rms_norm(h, layer.ln2, cfg.rms_eps)
                if not layer.moe:
                    h = h + tp_sum(self.tp, mlp_apply(layer.ffn, tp_enter(self.tp, hn, "mlp_in"),
                                                      cfg.act), "mlp")
                elif aux is None:
                    h = h + moe_apply(layer.ffn, cfg, hn, tp=self.tp)
                else:
                    f, a = moe_apply(layer.ffn, cfg, hn, with_aux=True, tp=self.tp, dp=self.dp)
                    h, aux = h + f, aux + a
            return h, aux

        def run_group(g: int, h: torch.Tensor, aux: Optional[torch.Tensor]):
            for l in range(g * self.period, (g + 1) * self.period):
                if ctx.remat and self.period > 1:
                    h, aux = self._checkpoint(run_layer, l, h, aux)
                else:
                    h, aux = run_layer(l, h, aux)
            return h, aux

        aux = torch.zeros((), dtype=torch.float32, device=h.device) if with_aux else None
        for g in range(group_lo, group_hi):
            if ctx.remat:
                h, aux = self._checkpoint(run_group, g, h, aux)
            else:
                h, aux = run_group(g, h, aux)
        return (h, aux) if with_aux else h

    def _checkpoint(self, fn, *args):
        """``fn(*args)`` in a checkpoint.  With a mesh its recompute runs the
        whole of ``fn`` (no early stop), so every collective of the region
        runs again in it, on every rank: a count that does not hang on where
        the last saved activation falls."""
        if self.tp is None:
            return checkpoint(fn, *args, use_reentrant=False)
        with set_checkpoint_early_stop(False):
            return checkpoint(fn, *args, use_reentrant=False)

    def _apply_cross(self, layer: Block, i: int, h: torch.Tensor, ctx: ForwardCtx,
                     cache: Optional[KVCache]) -> torch.Tensor:
        """One cross-attention on plane ``i`` of the cross caches: a decode
        reads the plane, a prefill projects the K/V from ``ctx.enc_out`` and
        stores them (the owned rows only), a pass without caches projects
        them and keeps nothing."""
        planes = None if cache is None else cache.layer(i)
        enc_out = None if ctx.enc_out is None else tp_enter(self.tp, ctx.enc_out, "enc_in")
        x, (ck, cv) = cross_attention(
            layer.xattn, self.cfg,
            tp_enter(self.tp, rms_norm(h, layer.lnx, self.cfg.rms_eps), "cross_in"),
            enc_out=enc_out, cache=planes if ctx.mode == "decode" else None, impl=ctx.attn_impl)
        if planes is not None and ctx.mode == "prefill":
            _store(planes.k, ck, ctx.scatter_mask)
            _store(planes.v, cv, ctx.scatter_mask)
        return h + tp_sum(self.tp, x, "cross") * torch.tanh(layer.gate_attn).to(x.dtype)

    def _apply_ssm(self, layer: Block, i: int, h: torch.Tensor, ctx: ForwardCtx,
                   cache: Optional[SSMCache]) -> torch.Tensor:
        """One SSM mixer on plane ``i`` of the SSM caches, the reference's
        ``_apply_ssm``: decode rebuilds the block from ``ssmh`` and resumes
        from the block-start state, prefill captures that state and the
        block rows of ``h`` after the mixer's residual."""
        cfg = self.cfg
        if ctx.mode == "decode" and cache is not None:
            if ctx.block_idx is None:
                raise ValueError("an SSM decode needs block_idx")
            full_in = row_scatter(cache.ssmh[i], h, ctx.block_idx)
            y_full, _, _ = mamba_apply(
                layer.mixer, cfg, rms_norm(full_in, layer.ln1, cfg.rms_eps),
                state=SSMState(cache.state[i], cache.conv_tail[i]), impl=ctx.attn_impl,
                tp=self.tp)
            h = h + row_gather(y_full, ctx.block_idx).to(h.dtype)
            _store(cache.ssmh[i], full_in, ctx.scatter_mask)   # the state stays at block start
            return h
        capture = None
        if ctx.mode == "prefill" and cache is not None:
            if ctx.block_start is None:
                raise ValueError("an SSM prefill needs block_start")
            capture = ctx.block_start
        y, _, captured = mamba_apply(layer.mixer, cfg, rms_norm(h, layer.ln1, cfg.rms_eps),
                                     capture_pos=capture, impl=ctx.attn_impl, tp=self.tp)
        h = h + y.to(h.dtype)
        if capture is not None:
            lb = cache.ssmh.shape[2]
            cols = capture[:, None] + torch.arange(lb, dtype=capture.dtype, device=h.device)
            _store(cache.state[i], captured.state, ctx.scatter_mask)
            _store(cache.conv_tail[i], captured.conv_tail, ctx.scatter_mask)
            _store(cache.ssmh[i], row_gather(h, cols), ctx.scatter_mask)
        return h
