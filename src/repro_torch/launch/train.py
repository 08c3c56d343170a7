"""Training launcher of the port, with the reference launcher's flags: real
steps on synthetic data, on the CUDA card by default (``--device cpu`` runs
the same steps on the CPU).  The model starts from seeded random weights
(key 0).

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch qwen2-1.5b \\
      --reduced --steps 50 --batch 4 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
      --arch seamless-m4t-large-v2 --steps 4 --batch 2 --seq 32 --ckpt build/ckpt.npz

It takes no mesh, as the reference's launcher takes none: sharded training
runs through ``Model(cfg, mesh=..., mode="train")`` and ``make_train_step``
(``launch/tp.py::spawn`` starts the ranks), and ``launch/dryrun.py``'s
``train_4k``.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import configs
from repro_torch.core import prng
from repro_torch.models import Model
from repro_torch.train import (
    DataConfig,
    OptimizerConfig,
    SyntheticTextDataset,
    init_train_state,
    make_train_step,
    save_checkpoint,
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llada-8b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg)
    model = Model(cfg, device=args.device)

    opt_cfg = OptimizerConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=max(args.steps // 10, 1))
    ce_chunk = min(256, args.seq)
    step = make_train_step(model, opt_cfg, ce_chunk=ce_chunk)
    state = init_train_state(model, prng.prng_key(0, device=model.device))

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch,
                    n_enc_tokens=cfg.n_enc_tokens if cfg.family in ("audio", "vlm") else 0,
                    d_enc=(cfg.d_enc or cfg.d_model))
    ds = SyntheticTextDataset(dc)

    t0 = time.time()
    for i in range(args.steps):
        state, metrics = step(state, ds.next_batch())
        if i % args.log_every == 0:
            print(f"step {i:4d}  loss {float(metrics['loss']):8.4f}  "
                  f"ce {float(metrics['ce']):8.4f}  "
                  f"gnorm {float(metrics['grad_norm']):7.3f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"({time.time()-t0:6.1f}s)")
    if args.ckpt:
        save_checkpoint(args.ckpt, model, step=args.steps)
        print(f"saved checkpoint to {args.ckpt}")


if __name__ == "__main__":
    main()
