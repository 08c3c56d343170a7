"""Serving launcher of the port, with the reference launcher's flags.

Two runtimes: ``stream`` (the default), continuous batching through
``StreamScheduler``, or with ``--shards > 1`` through
``ShardedStreamScheduler`` (one lane per shard behind a placement policy;
``--paged`` required); and ``batch``, the lock-step ``BatchServer`` of
paper §6.1.  Runs on the CUDA card by default; ``--device cpu`` runs the
kernels' plain PyTorch versions.  The model has random weights from
``--seed`` (reduced size unless ``--full``).

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --requests 8 \\
      --paged --page-size 8 --early-advance --prompt-refresh-period 4 \\
      --cache-prompt-interval 2
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --paged \\
      --page-size 8 --prefix-sharing --dup-prompts --requests 4
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --paged \\
      --page-size 8 --preemption --priority-classes 2 --kv-pages 9 --requests 4
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --paged \\
      --page-size 8 --prefix-sharing --dup-prompts --block-causal --window-blocks 1 \\
      --early-advance --requests 4 --batch 2 --prompt-len 16 --gen-length 32 \\
      --block-length 8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --paged \\
      --page-size 8 --window-blocks 1 --lazy-reserve --early-advance --requests 6 \\
      --batch 2 --prompt-len 16 --gen-length 32 --block-length 8 --kv-pages 11
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch mamba2-370m \\
      --requests 6 --batch 3 --early-advance --gen-length 16 --block-length 8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch jamba-v0.1-52b \\
      --requests 3 --batch 2 --paged --page-size 8 --early-advance --gen-length 16 \\
      --block-length 8 --prompt-len 16
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --runtime batch \\
      --requests 6 --batch 4 --prompt-len 16 --gen-length 16 --block-length 8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --paged --page-size 8 \\
      --shards 2 --placement disagg --decode-prompt-len 8 --requests 6 --batch 4 \\
      --prompt-len 16 --gen-length 16 --block-length 8 --early-advance
  PYTHONPATH=src python -m repro_torch.launch.serve --full --dtype bfloat16 \\
      --paged --early-advance --requests 16 --batch 4 --prompt-len 128 \\
      --gen-length 64 --block-length 32

``validate`` raises ``ConfigError`` before any model is built, for the
argument sets the reference refuses: its launcher, and its engine's
refusals of the adaptive cache and ``--gather-refresh`` on stacks with SSM
layers.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs import GenerationConfig, default_skip_stages
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.runtime import (
    BatchServer,
    ConfigError,
    Request,
    ShardedStreamScheduler,
    StreamScheduler,
)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llada-8b")
    ap.add_argument("--full", action="store_true",
                    help="full config (default: reduced, CPU-runnable)")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                    help="parameter and compute dtype")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the kernels' plain versions)")
    ap.add_argument("--seed", type=int, default=0, help="weights and prompts")
    ap.add_argument("--mode", default="es", choices=["vanilla", "dualcache", "es"])
    ap.add_argument("--runtime", default="stream", choices=["stream", "batch"])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8,
                    help="batch size (lock-step) / slot count (stream)")
    ap.add_argument("--gen-length", type=int, default=32)
    ap.add_argument("--block-length", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--parallel-decoding", action="store_true")
    ap.add_argument("--early-advance", action="store_true",
                    help="per-row cadence: a slot advances its block the moment it "
                         "fully unmasks and admission happens on any iteration")
    ap.add_argument("--stream-print", action="store_true",
                    help="print each request's blocks as they unmask")
    ap.add_argument("--paged", action="store_true", help="paged KV pool + block tables")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="pool pages incl. garbage page (default: dense-equivalent)")
    ap.add_argument("--prompt-refresh-period", type=int, default=64)
    ap.add_argument("--cache-prompt-interval", type=int, default=0,
                    help="adaptive feature cache: every k-th scheduled prompt refresh "
                         "is full, the ones between are partial (<=1 disables)")
    ap.add_argument("--cache-response-interval", type=int, default=4,
                    help="the block-refresh period")
    ap.add_argument("--cache-variation-threshold", type=float, default=0.0)
    ap.add_argument("--priority-classes", type=int, default=1,
                    help="spread requests round-robin over this many admission classes")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request SLO budget from arrival")
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="same-cycle duplicate prompts map the same physical prompt "
                         "pages (requires --paged)")
    ap.add_argument("--dup-prompts", action="store_true",
                    help="submit one prompt duplicated --requests times (the "
                         "prefix-sharing workload)")
    ap.add_argument("--gather-refresh", action="store_true",
                    help="run a prompt refresh of at most half the slots as a half-width "
                         "prefill of the gathered rows (requires --paged)")
    ap.add_argument("--window-blocks", type=int, default=0,
                    help="sliding active window: a row attends its block and this many "
                         "blocks of masked suffix beyond it (0 = no window)")
    ap.add_argument("--lazy-reserve", action="store_true",
                    help="admit with the prompt and one active window of pages, map the "
                         "rest as the window advances (requires --paged and "
                         "--window-blocks > 0)")
    ap.add_argument("--preemption", action="store_true",
                    help="a higher-class arrival short of pages may spill a lower-class "
                         "resident to host memory at its block boundary and resume it "
                         "later (requires --paged)")
    ap.add_argument("--block-causal", action="store_true",
                    help="block-causal attention: prompt K/V depend on the prompt alone, "
                         "full refreshes skip final positions, and with --paged "
                         "--prefix-sharing the prompt pages persist across requests")
    ap.add_argument("--shards", type=int, default=1,
                    help="serving shards, each with its own slots, page ledger and queue; "
                         "a placement policy routes each request to one (requires --paged)")
    ap.add_argument("--placement", default="least_loaded",
                    choices=["least_loaded", "prefix_affinity", "disagg"],
                    help="least_loaded (committed pages, then queue depth), prefix_affinity "
                         "(the shard whose persistent store holds the prompt; needs "
                         "--prefix-sharing) or disagg (long prompts to refresh shards)")
    ap.add_argument("--refresh-shards", type=int, default=1,
                    help="disagg: how many leading shards take the long prompts")
    ap.add_argument("--decode-prompt-len", type=int, default=None,
                    help="disagg: the decode shards' shorter prompt width; longer prompts "
                         "go to the refresh shards")
    return ap.parse_args(argv)


def validate(args: argparse.Namespace) -> None:
    """Raises ConfigError, before any model is built, for bad values and
    combinations."""
    if args.priority_classes < 1:
        raise ConfigError(f"--priority-classes must be >= 1, got {args.priority_classes}")
    if args.deadline_s is not None and args.deadline_s <= 0:
        raise ConfigError(f"--deadline-s must be positive, got {args.deadline_s}")
    if args.runtime == "batch" and (args.preemption or args.priority_classes > 1
                                    or args.deadline_s is not None):
        raise ConfigError("--preemption/--priority-classes/--deadline-s need the stream "
                          "runtime: the lock-step batch server has no admission policy")
    if args.prefix_sharing and not args.paged:
        raise ConfigError("--prefix-sharing requires --paged: it shares pool pages")
    if args.preemption and not args.paged:
        raise ConfigError("--preemption requires --paged: spilling moves pool pages, "
                          "dense KV rows cannot be released")
    arch = configs.get_config(args.arch)
    if (any(arch.layer_kind(l) in ("ssm", "cross") for l in range(arch.n_layers))
            and (args.cache_prompt_interval > 1 or args.gather_refresh)):
        raise ConfigError("the adaptive cache (--cache-prompt-interval > 1) and "
                          "--gather-refresh need an attention-only stack; the reference "
                          "refuses them on stacks with SSM or cross layers too")
    if args.window_blocks < 0:
        raise ConfigError(f"--window-blocks must be >= 0, got {args.window_blocks}")
    if args.preemption and args.prefix_sharing:
        raise ConfigError("--preemption is incompatible with --prefix-sharing: a spill "
                          "releases pages other requests may still map")
    if args.gather_refresh and not args.paged:
        raise ConfigError("--gather-refresh requires --paged: the compacted rows write "
                          "through their block tables into the batch-free pool")
    if args.lazy_reserve and not args.paged:
        raise ConfigError("--lazy-reserve requires --paged: it defers pool pages")
    if args.lazy_reserve and args.window_blocks <= 0:
        raise ConfigError("--lazy-reserve requires --window-blocks > 0: unmapped far-suffix "
                          "pages are sound only when the window masks them")
    if args.preemption and args.lazy_reserve:
        raise ConfigError("--preemption is incompatible with --lazy-reserve: a spill breaks "
                          "the max-deficit window-growth accounting")
    # the sharded topology (the ShardedStreamScheduler constructor checks
    # these again)
    if args.shards < 1:
        raise ConfigError(f"--shards must be >= 1, got {args.shards}")
    if args.shards > 1:
        if args.runtime != "stream":
            raise ConfigError("--shards > 1 needs the stream runtime: the lock-step batch "
                              "server has no page ledger to shard")
        if not args.paged:
            raise ConfigError("--shards > 1 requires --paged: shards own per-shard page "
                              "ledgers")
        if args.batch % args.shards:
            raise ConfigError(f"--shards ({args.shards}) must divide the slot count "
                              f"--batch ({args.batch})")
        if args.kv_pages is not None and args.kv_pages % args.shards:
            raise ConfigError(f"--kv-pages ({args.kv_pages}) must divide evenly across "
                              f"{args.shards} shards")
    if args.placement == "prefix_affinity" and not args.prefix_sharing:
        raise ConfigError("--placement prefix_affinity routes on the persistent prefix "
                          "store: it requires --prefix-sharing (and --block-causal for the "
                          "store to exist)")
    if args.placement == "disagg":
        if args.shards < 2:
            raise ConfigError("--placement disagg needs --shards >= 2 (refresh + decode "
                              "classes)")
        if not (1 <= args.refresh_shards < args.shards):
            raise ConfigError(f"--refresh-shards ({args.refresh_shards}) must satisfy "
                              f"1 <= refresh_shards < shards ({args.shards})")
        if args.decode_prompt_len is not None and args.decode_prompt_len > args.prompt_len:
            raise ConfigError(f"--decode-prompt-len ({args.decode_prompt_len}) must not "
                              f"exceed --prompt-len ({args.prompt_len})")
    elif args.decode_prompt_len is not None:
        raise ConfigError("--decode-prompt-len is a disagg knob; it does nothing under "
                          f"--placement {args.placement} — refusing to drop it silently")
    if args.placement != "least_loaded" and args.shards < 2:
        raise ConfigError(f"--placement {args.placement} needs --shards >= 2 (a single "
                          "shard has nothing to route)")


def main(argv=None) -> list[Request]:
    args = parse_args(argv)
    validate(args)
    device = resolve_device(args.device)
    cfg = configs.get_config(args.arch)
    if not args.full:
        cfg = configs.reduced(cfg)
    cfg = dataclasses.replace(cfg, param_dtype=args.dtype, compute_dtype=args.dtype)
    model = Model(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(args.seed))
    gen = GenerationConfig(
        gen_length=args.gen_length, block_length=args.block_length, mode=args.mode,
        skip_stages=default_skip_stages(cfg.n_layers) if args.mode == "es" else (),
        prompt_refresh_period=args.prompt_refresh_period,
        block_refresh_period=args.cache_response_interval,
        parallel_decoding=args.parallel_decoding,
        window_blocks=args.window_blocks, block_causal=args.block_causal,
        cache_prompt_interval=args.cache_prompt_interval,
        cache_variation_threshold=args.cache_variation_threshold)

    stream_cb = None
    if args.stream_print:
        def stream_cb(req, bi, blk):
            print(f"  [stream] req={req.request_id} block={bi}: {blk.tolist()}")

    stream_kw = dict(max_slots=args.batch, prompt_len=args.prompt_len, stream_cb=stream_cb,
                     paged=args.paged, page_size=args.page_size, kv_pages=args.kv_pages,
                     prefix_sharing=args.prefix_sharing, preemption=args.preemption,
                     lazy_reserve=args.lazy_reserve, early_advance=args.early_advance,
                     gather_refresh=args.gather_refresh, device=device)
    if args.runtime == "batch":
        server = BatchServer(model, gen, batch_size=args.batch, prompt_len=args.prompt_len,
                             device=device)
    elif args.shards > 1:
        server = ShardedStreamScheduler(
            model, gen, shards=args.shards, placement=args.placement,
            refresh_shards=args.refresh_shards, decode_prompt_len=args.decode_prompt_len,
            **stream_kw)
    else:
        server = StreamScheduler(model, gen, **stream_kw)
    rng = np.random.default_rng(args.seed)
    if args.dup_prompts:
        dup_prompt = rng.integers(3, cfg.vocab_size, args.prompt_len).astype(np.int32)
    for i in range(args.requests):
        if args.dup_prompts:
            prompt = dup_prompt.copy()
        else:
            plen = int(rng.integers(8, args.prompt_len + 1))
            prompt = rng.integers(3, cfg.vocab_size, plen).astype(np.int32)
        server.submit(Request(prompt=prompt, priority=i % args.priority_classes,
                              deadline_s=args.deadline_s))

    done = server.drain()
    st = server.stats
    if args.runtime == "batch":
        print(f"served {len(done)} requests  device={device}  runtime=batch  "
              f"mode={args.mode}  TPS={st.tps:.2f}  wall={st.wall_s:.2f}s  "
              f"batches={len(server.batch_wall_s)}")
        if done:
            print("sample output:", done[0].output[:24].tolist())
        return done
    line = (f"served {len(done)} requests  device={device}  mode={args.mode}  "
            f"goodput={st.goodput:.2f} tok/s  wall={st.wall_s:.2f}s  steps={st.steps}  "
            f"p50={st.latency_pct(50):.2f}s  p95={st.latency_pct(95):.2f}s  "
            f"admission_p50={st.admission_wait_p50:.3f}s")
    if args.early_advance:
        line += f"  early_advances={st.early_advances}"
    if gen.adaptive_cache:
        line += (f"  cache_hit={st.cache_hit_fraction:.3f}"
                 f"  refresh_p50={st.tokens_refreshed_p50:.0f}")
    if args.paged:
        line += (f"  peak_pages={st.peak_pages_in_use}/{st.pages_total}"
                 f"  concurrency_peak={st.resident_peak}")
        if args.prefix_sharing:
            line += f"  cow_forks={st.cow_forks}"
        lanes = server.lanes if args.shards > 1 else [server]
        if any(lane.persistent_prefix for lane in lanes):
            line += f"  prefix_hits={st.prefix_hits}  prefix_evictions={st.prefix_evictions}"
        if gen.sparse_attention:
            line += f"  pages_reclaimed={st.pages_reclaimed}"
        if args.lazy_reserve:
            line += f"  pages_deferred={st.pages_deferred}  window_stalls={st.window_stalls}"
        if args.gather_refresh:
            line += f"  compact_prefill={server.engine.compact_prefill}"
    if gen.block_causal:
        line += f"  invariant_tokens_skipped={st.invariant_tokens_skipped}"
    if args.preemption:
        line += (f"  preemptions={st.preemptions}  pages_spilled={st.pages_spilled}"
                 f"  resume_p50={st.resume_p50:.3f}s")
    if args.deadline_s is not None:
        line += f"  deadline_rejects={st.deadline_rejects}"
    if st.poisoned_requests:
        line += f"  poisoned_requests={st.poisoned_requests}"
    print(line)
    if args.shards > 1:
        for g in server.shard_gauges():
            print(f"  shard {g['shard']}: placed={g['placed']}  resident={g['resident']}  "
                  f"queued={g['queued']}  completed={g['completed']}  "
                  f"pages={g['pages_in_use']}/{g['pages_total']}  "
                  f"peak={g['peak_pages_in_use']}  blocks_grown={g['blocks_grown']}")
    ok = [r for r in done if r.output is not None]
    if ok:
        print("sample output:", ok[0].output[:24].tolist())
    return done


if __name__ == "__main__":
    main()
