"""Masked-diffusion training objective (LLaDA, arXiv:2502.09992), the
reference's ``repro/train/loss.py``.

For each sample draw t ~ U(0, 1), mask every response token independently
with probability t, and minimize the 1/t-weighted cross-entropy of the
original tokens at masked positions:

    L = -E_t E_mask [ 1/t * sum_{i masked} log p_theta(x_i | x_masked) ]

The mask and t come from the reference's threefry stream
(``core/prng.py``), so they are bit-equal to its for the same key.  The
stack runs on the plain attention and SSD scan (the kernels have no
backward; the reference trains on its XLA lowerings), and the
cross-entropy is chunked over the sequence, each chunk in a checkpoint, so
only one ``[B, chunk, Vp]`` f32 logits tile is live at a time in the
forward and in the backward pass.

Over a mesh's batch axes (``Model.dp``) each rank draws the global batch's
mask and keeps its rows, divides its share of the CE by the global batch's
weight, and averages the MoE aux loss's factors over the ranks, so the
ranks' gradients sum to the reference's on the global batch.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import prng
from repro_torch.models.model import ForwardCtx, Model


def sample_diffusion_mask(key: torch.Tensor, tokens: torch.Tensor, loss_region: torch.Tensor,
                          *, rows: Optional[tuple[int, int]] = None
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(masked [B, L] bool, t [B] f32, k2)`` from the raw key ``[2]``: ``k1,
    k2 = split(key)``, ``t = uniform(k1, (B,), 1e-3, 1)``, ``u = uniform(k2,
    (B, L))``, masked where ``u < t`` inside ``loss_region``.  With ``rows =
    (lo, n)`` the tokens are rows ``[lo, lo + B)`` of a global batch of
    ``n``: ``t`` and ``u`` are drawn for the global batch and those rows
    taken, so a data rank's mask is the reference's on its rows, bit for
    bit."""
    k1, k2 = prng.split(key.to(tokens.device))
    b, l = tokens.shape
    lo, n = (0, b) if rows is None else rows
    t = prng.uniform(k1, (n,), minval=1e-3, maxval=1.0)[lo:lo + b]
    u = prng.uniform(k2, (n, l))[lo:lo + b]
    return (u < t[:, None]) & loss_region, t, k2


def _chunk_nll(model: Model, h: torch.Tensor, targets: torch.Tensor,
               weights: torch.Tensor, head: tuple) -> torch.Tensor:
    logits = model.logits(h, head).float()                            # [B, C, Vp]
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.sum((logz - tgt) * weights)


def chunked_masked_ce(model: Model, h_final: torch.Tensor, targets: torch.Tensor,
                      weights: torch.Tensor, *, chunk: int = 256) -> torch.Tensor:
    """``sum(nll * w) / max(sum(w), 1)`` over ``h_final [B, L, d]`` (pre-head
    hidden states), ``targets [B, L]`` and ``weights [B, L]`` f32, one
    checkpointed chunk of ``chunk`` positions at a time, summed in chunk
    order as the reference's scan does.  The head is read (gathered) once
    for every chunk.  Over the batch axes of a mesh (``model.dp``) the rows
    are the rank's, and ``sum(w)`` is the global batch's (no grad, site
    ``loss``): the ranks' terms sum to the reference's CE, and so do their
    gradients."""
    b, l, _ = h_final.shape
    if l % chunk:
        raise ValueError(f"seq {l} must divide by CE chunk {chunk}")
    head = model.head()
    total = torch.zeros((), dtype=torch.float32, device=h_final.device)
    denom = torch.zeros((), dtype=torch.float32, device=h_final.device)
    for lo in range(0, l, chunk):
        w = weights[:, lo:lo + chunk]
        total = total + checkpoint(_chunk_nll, model, h_final[:, lo:lo + chunk],
                                   targets[:, lo:lo + chunk], w, head, use_reentrant=False)
        denom = denom + torch.sum(w)
    if model.dp is not None:
        denom = model.dp.batch_sum(denom, "loss")
    return total / torch.clamp(denom, min=1.0)


def diffusion_loss(model: Model, key: torch.Tensor, tokens: torch.Tensor,
                   loss_region: torch.Tensor, *, enc_embeds: Optional[torch.Tensor] = None,
                   ce_chunk: int = 256, remat: bool = True,
                   rows: Optional[tuple[int, int]] = None) -> tuple[torch.Tensor, dict]:
    """``(objective, {"loss", "ce", "aux", "mask_frac"})`` on clean ``tokens
    [B, L]``: masked positions take the id ``cfg.vocab_size``, ``loss = ce +
    aux``, ``ce`` the 1/t-weighted CE of the masked tokens and ``aux`` the
    MoE layers' load-balance loss.  ``remat`` recomputes each group's
    activations in the backward pass.  The reference also sets ``causal``
    for the ``ssm`` family; that reaches attention layers only, and a pure
    SSM stack has none, so no field carries it here.

    Without batch axes the objective is ``loss``.  Over the batch axes of a
    mesh (``model.dp``) the batch is the global one, of which the rank takes
    its rows, or, with ``rows = (lo, n)``, the rank's rows ``[lo, lo + B)``
    of a global batch of ``n``.  The rank's objective is its share of the CE
    (:func:`chunked_masked_ce`) plus the global aux loss: the ranks'
    gradients sum to the reference's.  The metrics are the global batch's,
    equal on every rank.  A rank's MoE routing groups must be the
    reference's: its ``B * L`` tokens a multiple of ``router_group_size``,
    else ``ValueError``."""
    cfg = model.cfg
    dp = model.dp
    if dp is not None and rows is None:
        n = tokens.shape[0]
        mine = dp.rows(n)
        rows = (mine.start, n)
        tokens, loss_region = tokens[mine], loss_region[mine]
        enc_embeds = None if enc_embeds is None else enc_embeds[mine]
    b, l = tokens.shape
    if dp is not None and cfg.moe is not None and (b * l) % cfg.moe.router_group_size:
        raise ValueError(f"{b} x {l} tokens a data rank: not whole routing groups of "
                         f"{cfg.moe.router_group_size}, so its groups, capacity and drops "
                         f"would not be the reference's")
    masked, t, _ = sample_diffusion_mask(key, tokens, loss_region, rows=rows)
    noisy = torch.where(masked, cfg.vocab_size, tokens)
    h = model.embed_tokens(noisy)
    enc_out = None if enc_embeds is None else model.encode(enc_embeds, impl="plain")
    pos = torch.arange(l, dtype=torch.int32, device=tokens.device)[None].expand(b, l)
    ctx = ForwardCtx(positions=pos.contiguous(), enc_out=enc_out, attn_impl="plain",
                     remat=remat)
    h, aux = model.run_layers(h, ctx, with_aux=True)
    weights = masked.float() / t[:, None]                 # 1/t reweighting
    ce = chunked_masked_ce(model, h, tokens, weights, chunk=ce_chunk)
    objective = ce + aux
    if dp is None:
        metrics = {"loss": objective, "ce": ce, "aux": aux,
                   "mask_frac": torch.mean(masked.float())}
    else:
        ce_all = dp.batch_sum(ce, "loss")
        metrics = {"loss": ce_all + aux.detach(), "ce": ce_all, "aux": aux,
                   "mask_frac": dp.batch_sum(masked.float().sum(), "loss") / (rows[1] * l)}
    return objective, metrics
