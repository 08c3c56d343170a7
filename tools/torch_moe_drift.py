"""How far the card's MoE routing drifts from the CPU's on reduced OLMoE.

Builds reduced olmoe-1b-7b (4 layers, capacity factor 0.5, so picks drop)
with seeded random weights, weight matrices scaled by each of ``--scales``,
once on the CPU and once on the card, and reports for each scale:

* one ``nocache`` pass of a (2, 40) prompt: per MoE layer, the largest
  difference between the two devices' router probabilities and the rows
  whose picks differ;
* an offline es ``generate`` (gen 16, blocks of 8) on each device: how
  many generated tokens differ, and the smallest non-zero gap between a
  row's top-(k + 1) router probabilities seen on the CPU (a pick flips
  where the devices differ by more than that gap).

Run on a machine with a CUDA card:

    PYTHONPATH=src python tools/torch_moe_drift.py --scales 10 2
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch import configs
from repro_torch.core import make_engine
from repro_torch.models import Model, moe
from repro_torch.models.model import ForwardCtx


def build(scale: float) -> dict:
    cfg = dataclasses.replace(configs.reduced(configs.get_config("olmoe-1b-7b")), n_layers=4)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in cpu.parameters():
            if p.dim() >= 2:
                p.mul_(scale)
    card = Model(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    return {"cpu": cpu, "cuda": card}


def routed(fn):
    """Runs ``fn`` with ``moe.routing`` recording (probs, picks) on the CPU."""
    seen, routing = [], moe.routing

    def recording(probs, m, cap):
        r = routing(probs, m, cap)
        seen.append((probs.cpu(), r.expert.cpu()))
        return r
    moe.routing = recording
    try:
        out = fn()
    finally:
        moe.routing = routing
    return out, seen


def drift(scale: float) -> dict:
    models = build(scale)
    prompt = torch.randint(3, 503, (2, 40), generator=torch.Generator().manual_seed(0))
    passes = {}
    for dev, m in models.items():
        pos = torch.arange(40, dtype=torch.int32, device=m.device)[None].expand(2, 40)
        with torch.no_grad():
            _, passes[dev] = routed(lambda m=m, pos=pos: m.run_layers(
                m.embed_tokens(prompt.to(m.device)), ForwardCtx(positions=pos.contiguous())))
    layers = [dict(max_prob_diff=(pc - pg).abs().max().item(),
                   rows_picks_differ=int((ec != eg).any(-1).sum()))
              for (pc, ec), (pg, eg) in zip(passes["cpu"], passes["cuda"])]
    gen = configs.GenerationConfig(
        mode="es", gen_length=16, block_length=8,
        skip_stages=(configs.SkipStage(1, 0.5), configs.SkipStage(2, 0.5)))
    toks = {}
    toks["cpu"], seen = routed(
        lambda: make_engine(models["cpu"], gen, device="cpu").generate(prompt))
    toks["cuda"] = make_engine(models["cuda"], gen, device="cuda").generate(prompt).cpu()
    k = models["cpu"].cfg.moe.experts_per_token
    gaps = []
    for probs, _ in seen:
        top = torch.sort(probs, dim=-1, descending=True).values[..., :k + 1]
        d = top[..., :-1] - top[..., 1:]
        gaps.append(d[d > 0].min().item())
    return dict(scale=scale, nocache_layers=layers,
                es_tokens_differ=int((toks["cpu"] != toks["cuda"]).sum()),
                es_generated_tokens=int(toks["cpu"][:, 40:].numel()),
                min_nonzero_gap_cpu=min(gaps))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scales", type=float, nargs="+", default=[10.0, 2.0])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_moe_drift: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    for s in args.scales:
        print(json.dumps(drift(s)))


if __name__ == "__main__":
    main()
