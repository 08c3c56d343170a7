"""Mixture-of-Experts FFN with GShard-style capacity routing, the port's
counterpart of ``repro/models/moe.py``.

The ``B * K`` rows a pass hands the FFN are flattened b-major and cut into
routing groups of ``min(router_group_size, B * K)`` rows, the last group
zero-padded.  In each group every row makes ``experts_per_token`` choices
in rounds, and each expert takes at most ``capacity`` rows; a pick past it
is dropped.  Which picks drop depends on the order of the rows within the
group, so the engine hands the stack its rows in the reference's order
(``core/engine.py::_top_k``), and pad rows and the rows a mixed-mode pass
does not own take capacity as they do in the reference.

The reference dispatches with dense one-hot einsums over ``[G, S, E, C]``;
the port dispatches by index: each expert's ``C`` capacity slots gather
their rows (an empty slot is a zero row, as in the einsum), the experts run
as one batched matmul per projection over ``[E, G * C, d]`` (plain
``torch.bmm``: XLA computes them in the reference), and each row sums its
kept picks' outputs with their combine weights.  Same drops, same weights.

Under tensor parallelism each rank holds ``E / model`` whole experts (the
reference's rule, experts on ``model``), and the router whole: every rank
routes every row of a group, so capacity and drops are the same on all of
them.  A rank runs its own experts over their capacity slots and combines
their kept picks; the combines are summed over the ranks in f32, then cast.

The Switch load-balance aux loss, which only training reads, is computed
when the caller asks for it (``with_aux``), so an inference pass does no
more work.  A non-finite row stays in its own output here, where the
reference's dense einsum spreads it (``0 * NaN``) over its whole group
(ROADMAP.md, the reference-side faults the port does not mirror).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.attention import _param
from repro_torch.models.common import activation
from repro_torch.sharding.comm import TPGroup, tp_enter, tp_sum


class MoE(nn.Module):
    """The expert FFN of one layer: ``router [d, E]`` in float32 whatever the
    parameter dtype (the reference's ``moe_init`` makes it f32), and the
    experts' stacked gated-MLP weights for ``x @ W``."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        m, d = cfg.moe, cfg.d_model
        self.router = _param((d, m.n_experts), device, torch.float32)
        self.w_gate = _param((m.n_experts, d, m.d_ff_expert), device, dtype)
        self.w_up = _param((m.n_experts, d, m.d_ff_expert), device, dtype)
        self.w_down = _param((m.n_experts, m.d_ff_expert, d), device, dtype)


class Routing(NamedTuple):
    """A group's picks, ``[G, S, k]`` each, in round order: the expert, the
    capacity slot in it, whether the pick fits (``slot < capacity``) and its
    combine weight (0 where it does not fit)."""
    expert: torch.Tensor     # int64
    slot: torch.Tensor       # int64
    kept: torch.Tensor       # bool
    weight: torch.Tensor     # float32


def capacity(m: MoEConfig, group_size: int) -> int:
    """Slots per expert and group, as the reference computes them."""
    c = max(int(group_size * m.experts_per_token / m.n_experts * m.capacity_factor), 1)
    return min(c, group_size)


def routing(probs: torch.Tensor, m: MoEConfig, cap: int) -> Routing:
    """The reference's ``_routing`` on ``probs [G, S, E]`` f32, whose round r
    picks each row's largest remaining probability (the first index on ties)
    and zeroes it by a multiply.  So round r picks the r-th entry of the
    row's stable descending sort while that is above 0; once it is 0 every
    remaining probability is 0 (they have underflowed) and the argmax is
    expert 0, picked again with probability 0, as the reference does.  A
    pick's slot is the number of earlier rows of its group that picked the
    expert in this round plus every pick of it in earlier rounds, dropped
    ones included; picks at or past ``cap`` drop.  The kept picks'
    probabilities are renormalised by their sum (taken in round order),
    clamped at 1e-9."""
    k, e = m.experts_per_token, probs.shape[-1]
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    expert = torch.where(vals > 0, idx, 0)                              # [G, S, k]
    # a comparison, not F.one_hot, whose range check reads the card
    onehot = (expert[..., None] == torch.arange(e, device=probs.device)).long()  # [G, S, k, E]
    per_round = onehot.sum(dim=1, keepdim=True)                         # [G, 1, k, E]
    fill = per_round.cumsum(dim=2) - per_round                          # earlier rounds
    before = onehot.cumsum(dim=1) - onehot + fill                       # + earlier rows
    slot = torch.gather(before, -1, expert[..., None])[..., 0]
    kept = slot < cap
    chosen = torch.where(kept, vals, 0.0)
    denom = torch.clamp(chosen.cumsum(dim=-1)[..., -1:], min=1e-9)
    return Routing(expert, slot, kept, chosen / denom)


def aux_loss(probs: torch.Tensor, r: Routing, m: MoEConfig, dp=None) -> torch.Tensor:
    """The Switch load-balance loss of the reference's ``_routing``, times
    ``aux_loss_coef``: ``E * sum(frac * mean_prob)``, ``frac[e]`` the share
    of a group's ``S`` rows with a kept pick of expert ``e`` (averaged over
    the groups), ``mean_prob`` the router probabilities averaged over every
    row of every group, the zero pad rows of the last group included (their
    probabilities are uniform).  Only ``mean_prob`` carries a gradient.

    With ``dp`` (``Model.dp``: each data rank routes its own groups
    of the global batch) the loss is not linear in the groups, so ``frac``
    and ``mean_prob`` are averaged over the batch axes before the product
    (one *g* all-reduce, site ``aux``): every rank holds the global loss,
    and its gradient reaches the rank's own probabilities only."""
    g, s, e = probs.shape
    hit = ((r.expert[..., None] == torch.arange(e, device=probs.device))
           & r.kept[..., None]).any(dim=2)                               # [G, S, E]
    frac = hit.sum(dim=1).float().mean(dim=0) / s
    mean_prob = probs.mean(dim=(0, 1))
    if dp is not None:
        frac, mean_prob = dp.batch_mean(torch.stack([frac, mean_prob]), "aux").unbind(0)
    return e * torch.sum(frac * mean_prob) * m.aux_loss_coef


def moe_apply(moe: MoE, cfg: ModelConfig, x: torch.Tensor, *, with_aux: bool = False,
              tp: Optional[TPGroup] = None, dp=None):
    """The expert FFN on ``x [B, K, d]`` -> ``[B, K, d]`` in ``x.dtype``, the
    reference's ``moe_apply``; with ``with_aux``, ``(out, aux)`` with the
    f32 scalar :func:`aux_loss` (over the batch axes ``dp``).  With ``tp``,
    ``moe`` holds the rank's experts ``[tp.rank * E_l, (tp.rank + 1) *
    E_l)``: the rows its experts read (``moe_in``) and the gates that weight
    its picks (``moe_gates``) sum their gradients over the ranks, while the
    router's own work, and the aux loss, are the same on every rank."""
    m = cfg.moe
    b, k, d = x.shape
    t = b * k
    gsz = min(m.router_group_size, t)
    xf = F.pad(x.reshape(t, d), (0, 0, 0, (-t) % gsz))
    ng = xf.shape[0] // gsz
    xg = xf.view(ng, gsz, d)
    probs = torch.softmax(xg.float() @ moe.router, dim=-1)                # [G, S, E]
    cap = capacity(m, gsz)
    r = routing(probs, m, cap)
    e = moe.w_gate.shape[0]                                               # local experts
    expert = r.expert - (0 if tp is None else tp.rank * e)
    kept = r.kept if tp is None else r.kept & (expert >= 0) & (expert < e)
    # each (group, expert, slot) takes the row that was given it, or none
    flat = (torch.arange(ng, device=x.device)[:, None, None] * e + expert) * cap + r.slot
    src = torch.full((ng * e * cap + 1,), ng * gsz, dtype=torch.int64, device=x.device)
    rows = torch.arange(ng * gsz, device=x.device).view(ng, gsz, 1).expand_as(flat)
    src.scatter_(0, torch.where(kept, flat, ng * e * cap).reshape(-1), rows.reshape(-1))
    xe = tp_enter(tp, xg, "moe_in")
    xpad = torch.cat([xe.reshape(-1, d), xe.new_zeros((1, d))])          # the empty slot's row
    xd = xpad[src[:-1]].view(ng, e, cap, d).transpose(0, 1).reshape(e, ng * cap, d)
    act = activation(cfg.act)
    hid = act(torch.bmm(xd, moe.w_gate)) * torch.bmm(xd, moe.w_up)
    down = torch.bmm(hid, moe.w_down)                                     # [E, G * C, d]
    down = down.view(e, ng, cap, d).transpose(0, 1).reshape(ng * e * cap, d)
    # the combine in f32, its weights rounded to x's dtype as the reference's
    picked = down[torch.where(kept, flat, 0)].float()                     # [G, S, k, d]
    w = tp_enter(tp, r.weight, "moe_gates").to(x.dtype).float()[..., None]
    out = tp_sum(tp, torch.where(kept[..., None], w * picked, 0.0).sum(dim=2), "moe")
    out = out.to(x.dtype).reshape(-1, d)[:t].view(b, k, d)
    return (out, aux_loss(probs, r, m, dp)) if with_aux else out
