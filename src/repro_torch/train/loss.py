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
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import prng
from repro_torch.models.model import ForwardCtx, Model


def sample_diffusion_mask(key: torch.Tensor, tokens: torch.Tensor, loss_region: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(masked [B, L] bool, t [B] f32, k2)`` from the raw key ``[2]``: ``k1,
    k2 = split(key)``, ``t = uniform(k1, (B,), 1e-3, 1)``, ``u = uniform(k2,
    (B, L))``, masked where ``u < t`` inside ``loss_region``."""
    k1, k2 = prng.split(key.to(tokens.device))
    b, l = tokens.shape
    t = prng.uniform(k1, (b,), minval=1e-3, maxval=1.0)
    u = prng.uniform(k2, (b, l))
    return (u < t[:, None]) & loss_region, t, k2


def _chunk_nll(model: Model, h: torch.Tensor, targets: torch.Tensor,
               weights: torch.Tensor) -> torch.Tensor:
    logits = model.logits(h).float()                                  # [B, C, Vp]
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.sum((logz - tgt) * weights)


def chunked_masked_ce(model: Model, h_final: torch.Tensor, targets: torch.Tensor,
                      weights: torch.Tensor, *, chunk: int = 256) -> torch.Tensor:
    """``sum(nll * w) / max(sum(w), 1)`` over ``h_final [B, L, d]`` (pre-head
    hidden states), ``targets [B, L]`` and ``weights [B, L]`` f32, one
    checkpointed chunk of ``chunk`` positions at a time, summed in chunk
    order as the reference's scan does."""
    b, l, _ = h_final.shape
    if l % chunk:
        raise ValueError(f"seq {l} must divide by CE chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=h_final.device)
    denom = torch.zeros((), dtype=torch.float32, device=h_final.device)
    for lo in range(0, l, chunk):
        w = weights[:, lo:lo + chunk]
        total = total + checkpoint(_chunk_nll, model, h_final[:, lo:lo + chunk],
                                   targets[:, lo:lo + chunk], w, use_reentrant=False)
        denom = denom + torch.sum(w)
    return total / torch.clamp(denom, min=1.0)


def diffusion_loss(model: Model, key: torch.Tensor, tokens: torch.Tensor,
                   loss_region: torch.Tensor, *, enc_embeds: Optional[torch.Tensor] = None,
                   ce_chunk: int = 256, remat: bool = True) -> tuple[torch.Tensor, dict]:
    """``(loss, {"ce", "aux", "mask_frac"})`` on clean ``tokens [B, L]``:
    masked positions take the id ``cfg.vocab_size``, ``loss = ce + aux``,
    ``ce`` the 1/t-weighted CE of the masked tokens and ``aux`` the MoE
    layers' load-balance loss.  ``remat`` recomputes each group's
    activations in the backward pass.  The reference also sets ``causal``
    for the ``ssm`` family; that reaches attention layers only, and a pure
    SSM stack has none, so no field carries it here."""
    cfg = model.cfg
    masked, t, _ = sample_diffusion_mask(key, tokens, loss_region)
    noisy = torch.where(masked, cfg.vocab_size, tokens)
    b, l = tokens.shape
    h = model.embed_tokens(noisy)
    enc_out = None if enc_embeds is None else model.encode(enc_embeds, impl="plain")
    pos = torch.arange(l, dtype=torch.int32, device=tokens.device)[None].expand(b, l)
    ctx = ForwardCtx(positions=pos.contiguous(), enc_out=enc_out, attn_impl="plain",
                     remat=remat)
    h, aux = model.run_layers(h, ctx, with_aux=True)
    weights = masked.float() / t[:, None]                 # 1/t reweighting
    ce = chunked_masked_ce(model, h, tokens, weights, chunk=ce_chunk)
    metrics = {"ce": ce, "aux": aux, "mask_frac": torch.mean(masked.float())}
    return ce + aux, metrics
