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
   card, at the main path's shapes, in float32 and bfloat16, with kernel,
   plain and library times and the bound from bytes and operations;
4. cross-device engine check: a reduced LLaDA in float32, ES generation on
   the card (kernels) and on the CPU (plain versions): greedy tokens equal,
   final-block confidences within 1e-4;
5. main path: LLaDA-8B at full width in bfloat16 (random weights from a
   seeded generator on the card), ES generation, with each kernel's
   launches counted over that run.

The second-to-last line is the ``kernels`` JSON record, the last line
``{"ok": true, "device": {...}}``.  Details also go to
``build/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
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
    "scatter_rows": "src/repro/kernels/scatter_kv.py:45",
    "importance": "src/repro/kernels/importance.py:30",
}
SOURCES = {
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "scatter_rows": "src/repro_torch/kernels/csrc/scatter_kv.cu",
    "importance": "src/repro_torch/kernels/csrc/importance.cu",
}


def sh(*cmd: str) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return out.stdout.strip()


def device_ms(fn, n: int = 20) -> tuple[float, float]:
    """(device ms per call from the profiler's kernel records, wall ms per
    call from CUDA events over ``n`` back-to-back calls).  The profiler now
    and then records no kernel at all: after three such tries the CUDA-event
    time stands in for the device time."""
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
                fn()
            torch.cuda.synchronize()
        us = sum(ev.time_range.elapsed_us() for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0.0:
            return us / n / 1e3, wall
    print("device_ms: the profiler recorded no device time; CUDA-event time used",
          file=sys.stderr)
    return wall, wall


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions
# ---------------------------------------------------------------------------
def flash_cases():
    """(label, B, Hq, Hkv, Lq, Lkv, D, pad, dtype, mask kwargs, kv_pos edits).
    pad > 0 takes q/k/v as the first D columns of rows D + pad wide, so their
    strides are not 16-byte multiples; that and D outside {32, 64, 128} take
    the kernel's element-wise K/V staging."""
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for lq, what in ((192, "prefill"), (32, "block"), (16, "skip1"), (8, "skip2")):
            cases.append((f"llada {what} Lq={lq}", 2, 32, 32, lq, 192, 128, 0, dt, {}, False))
        cases.append(("dream gqa masked", 2, 28, 4, 32, 192, 128, 0, dt, {"causal": True}, True))
        cases.append(("dream gqa window+anchor+bc", 2, 28, 4, 32, 192, 128, 0, dt,
                      {"window": 24, "anchor": 16, "bc_start": 128, "bc_block": 32}, True))
        cases.append(("D=80 block", 2, 32, 32, 32, 192, 80, 0, dt, {}, False))
        cases.append(("D=96 gqa masked", 2, 28, 4, 32, 192, 96, 0, dt, {"causal": True}, True))
        cases.append(("llada block unaligned strides", 2, 32, 32, 32, 192, 128, 2, dt, {}, False))
    return cases


def check_flash(ref, flash_attention, gen):
    out = []
    for label, b, hq, hkv, lq, lkv, d, pad, dt, kw, edit in flash_cases():
        # the main path's layouts: q and the cache as [B, L, H, D], viewed [B, H, L, D]
        def rows(n, h):
            x = torch.randn(b, n, h, d + pad, generator=gen, device="cuda").to(dt)
            return x[..., :d].transpose(1, 2)
        q, k, v = rows(lq, hq), rows(lkv, hkv), rows(lkv, hkv)
        q_pos = torch.arange(lkv - lq, lkv, dtype=torch.int32, device="cuda")[None].repeat(b, 1)
        kv_pos = torch.arange(lkv, dtype=torch.int32, device="cuda")[None].repeat(b, 1)
        if edit:
            kv_pos[:, 5:9] = -1          # evicted / unfilled rows
            kv_pos[1, 100:140] = -1
            q_pos[0, 3] = -1             # with causal: a query row with nothing valid
        got = flash_attention(q, k, v, q_pos, kv_pos, **kw)
        want = ref.attention_reference(q, k, v, q_pos, kv_pos, **kw)
        err = (got.float() - want.float()).abs().max().item()
        tol = 1e-4 if dt == torch.float32 else 2e-2
        if not err <= tol:
            raise AssertionError(f"flash_attention {label} {dt}: max abs err {err} > {tol}")
        if edit and kw.get("causal") and got[0, :, 3].abs().max().item() != 0.0:
            raise AssertionError("flash_attention: a fully masked row must be 0")
        ms, wall = device_ms(lambda: flash_attention(q, k, v, q_pos, kv_pos, **kw))
        plain_ms, _ = device_ms(lambda: ref.attention_reference(q, k, v, q_pos, kv_pos, **kw))
        mask = ref.attention_mask(q_pos, kv_pos, **kw)[:, None]
        lib_ms = None                     # SDPA refuses strides that are not 16-byte multiples
        if not pad:
            lib_ms, _ = device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=hq != hkv))
        n_valid = mask.sum().item()       # scored (query, key) pairs of this input
        flops = 4.0 * hq * d * n_valid    # QK^T and PV, 2 flops per multiply-add
        bms, by = bound(nbytes(q, k, v, q_pos, kv_pos, got), flops, dt)
        out.append(dict(kernel="flash_attention", case=label, dtype=str(dt), max_abs_err=err,
                        tol=tol, ms=ms, wall_ms=wall, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=bms, bound_by=by))
    return out


def check_scatter(ref, scatter_rows, gen):
    out = []
    b, s, h, d = 2, 192, 32, 128
    for dt in (torch.float32, torch.bfloat16):
        for kk, what in ((192, "prefill"), (32, "block"), (16, "skip1"), (8, "skip2")):
            label = f"llada {what} K={kk}"
            kc = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dt)
            vc = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dt)
            kn = torch.randn(b, kk, h, d, generator=gen, device="cuda").to(dt)
            vn = torch.randn(b, kk, h, d, generator=gen, device="cuda").to(dt)
            idx = torch.stack([torch.randperm(s, generator=gen, device="cuda")[:kk]
                               for _ in range(b)]).to(torch.int32)
            want_k = ref.scatter_rows_reference(kc.clone(), kn, idx)
            want_v = ref.scatter_rows_reference(vc.clone(), vn, idx)
            got_k, got_v = kc.clone(), vc.clone()
            scatter_rows(((got_k, kn), (got_v, vn)), idx)
            if not (torch.equal(got_k, want_k) and torch.equal(got_v, want_v)):
                raise AssertionError(f"scatter_rows {label} {dt}: not bit-exact")
            ms, wall = device_ms(lambda: scatter_rows(((got_k, kn), (got_v, vn)), idx))
            plain_ms, _ = device_ms(lambda: (ref.scatter_rows_reference(got_k, kn, idx),
                                             ref.scatter_rows_reference(got_v, vn, idx)))
            flat = (idx.long() + torch.arange(b, device="cuda")[:, None] * s).reshape(-1)
            fk, fv = got_k.view(b * s, h, d), got_v.view(b * s, h, d)
            lib_ms, _ = device_ms(lambda: (fk.index_copy_(0, flat, kn.view(b * kk, h, d)),
                                           fv.index_copy_(0, flat, vn.view(b * kk, h, d))))
            # each fresh row read once and written once, plus the indices
            bms, by = bound(2 * nbytes(kn, vn) + nbytes(idx), 0.0, dt)
            out.append(dict(kernel="scatter_rows", case=label, dtype=str(dt), max_abs_err=0.0,
                            tol=0.0, ms=ms, wall_ms=wall, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bms, bound_by=by))
    return out


def check_importance(ref, importance, gen):
    out = []
    b, d = 2, 4096
    for dt in (torch.float32, torch.bfloat16):
        for kk, what in ((32, "stage1"), (16, "stage2")):
            label = f"llada {what} K={kk}"
            hn = torch.randn(b, kk, d, generator=gen, device="cuda").to(dt)
            ho = torch.randn(b, kk, d, generator=gen, device="cuda").to(dt)
            conf = torch.rand(b, kk, generator=gen, device="cuda")
            got = importance(hn, ho, conf, alpha=0.5)
            want = ref.importance_reference(hn, ho, conf, 0.5)
            err = (got - want).abs().max().item()
            rel = ((got - want).abs() / want.abs()).max().item()
            if not rel <= 1e-5:
                raise AssertionError(f"importance {label} {dt}: max rel err {rel} > 1e-5")
            ms, wall = device_ms(lambda: importance(hn, ho, conf, alpha=0.5))
            plain_ms, _ = device_ms(lambda: ref.importance_reference(hn, ho, conf, 0.5))
            flops = 5.0 * hn.numel()      # sub, abs, add; square, add
            bms, by = bound(nbytes(hn, ho, conf, got), flops, torch.float32)
            out.append(dict(kernel="importance", case=label, dtype=str(dt), max_abs_err=err,
                            max_rel_err=rel, tol=1e-5, ms=ms, wall_ms=wall, plain_ms=plain_ms,
                            library_ms=None, bound_ms=bms, bound_by=by))
    return out


# ---------------------------------------------------------------------------
# phase 4 / 5: the engine
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


def main_path(kernel_fns):
    from repro_torch import configs
    from repro_torch.core import make_engine
    from repro_torch.models import Model

    cfg = dataclasses.replace(configs.get_config("llada-8b"),
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    batch, prompt_len = 2, 128
    gen_cfg = configs.GenerationConfig(
        mode="es", gen_length=64, block_length=32,
        skip_stages=configs.default_skip_stages(cfg.n_layers),
        prompt_refresh_period=32, block_refresh_period=4)
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = sum(nbytes(p) for p in model.parameters()) / 1e9
    prompt = torch.randint(3, cfg.vocab_size, (batch, prompt_len), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(SEED + 1))
    engine = make_engine(model, gen_cfg, device="cuda")
    engine.generate(prompt)                       # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    for fn in kernel_fns.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = engine.generate(prompt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernel_fns.items()}
    repeats = [wall]                    # host time varies: the spread of a few runs
    for _ in range(2):
        t0 = time.perf_counter()
        again = engine.generate(prompt)
        torch.cuda.synchronize()
        repeats.append(time.perf_counter() - t0)
        if not torch.equal(again, out):
            raise AssertionError("a repeated greedy generate gave other tokens")
    profile = profile_generate(engine, prompt)
    gen_tok = out[:, prompt_len:]
    if out.shape != (batch, prompt_len + gen_cfg.gen_length):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if (gen_tok == engine.mask_id).any().item():
        raise AssertionError("a [mask] id is left in the output")
    if not ((gen_tok >= 0) & (gen_tok < cfg.vocab_size)).all().item():
        raise AssertionError("generated ids outside the vocabulary")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    return dict(arch=cfg.name, dtype="bfloat16", layers=cfg.n_layers, d_model=cfg.d_model,
                weights_gb=weights_gb, init_s=init_s, batch=batch, prompt_len=prompt_len,
                gen_length=gen_cfg.gen_length, block_length=gen_cfg.block_length,
                segments=[dataclasses.asdict(s) for s in engine.segments],
                iterations=engine.iterations, wall_s=wall, wall_s_repeats=repeats,
                tokens_per_s=batch * gen_cfg.gen_length / wall,
                tokens_per_s_best=batch * gen_cfg.gen_length / min(repeats),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                distinct_ids=len(torch.unique(gen_tok)), launches=launches, profile=profile)


def profile_generate(engine, prompt, top: int = 8) -> dict:
    """Where one generate's time goes on the device: the share of the wall
    time some kernel was running, and the kernels with the most device time."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        engine.generate(prompt)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:                       # union of the kernels' intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            rec = by_name.setdefault(ev.name[:60], [0.0, 0])
            rec[0] += ev.time_range.elapsed_us()
            rec[1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(profiled_wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                device_busy_share=busy / wall_us, kernels_launched=len(spans),
                top=[dict(name=n, ms=us / 1e3, count=c) for n, (us, c) in ranked])


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

    from repro_torch.kernels import build, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.importance import importance
    from repro_torch.kernels.scatter_kv import scatter_rows

    print(sh(build.nvcc(), "--version").splitlines()[-1])
    try:
        import triton
        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton: not importable")
    kernel_fns = {"flash_attention": flash_attention, "scatter_rows": scatter_rows,
                  "importance": importance}

    # phase 2: build
    lib_path, build_s = build.build()
    build.library()
    print(f"build: {lib_path.name} in {build_s:.1f} s")
    ptxas = [ln.strip() for ln in lib_path.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    print("\n".join(ptxas))

    # phase 3: kernels vs plain versions
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = check_flash(ref, flash_attention, gen)
    cases += check_scatter(ref, scatter_rows, gen)
    cases += check_importance(ref, importance, gen)
    for c in cases:
        lib = "-" if c["library_ms"] is None else f"{c['library_ms']:.4f}"
        print(f"{c['kernel']:16s} {c['case']:30s} {c['dtype']:15s} err {c['max_abs_err']:.2e} "
              f"ms {c['ms']:.4f} (wall {c['wall_ms']:.4f}) plain {c['plain_ms']:.4f} "
              f"library {lib} bound {c['bound_ms']:.4f} ({c['bound_by']})")

    # phase 4: cross-device engine check
    cross = cross_device_check()
    print(f"cross-device: {json.dumps(cross)}")

    # phase 5: the main path at full width
    run = main_path(kernel_fns)
    print(f"main path: {json.dumps(run)}")

    # phase 6: the kernels record, at a decode shape and dtype the main path
    # gives each kernel: bf16 attention and K/V, f32 hidden states
    headline = {"flash_attention": ("llada block Lq=32", torch.bfloat16),
                "scatter_rows": ("llada block K=32", torch.bfloat16),
                "importance": ("llada stage1 K=32", torch.float32)}
    kernels = []
    for name, (case, dt) in headline.items():
        c = next(c for c in cases if c["kernel"] == name and c["case"] == case
                 and c["dtype"] == str(dt))
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=run["launches"][name],
            max_abs_err=max(x["max_abs_err"] for x in cases if x["kernel"] == name),
            ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"]))
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        dict(card=smi, torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
             ptxas=ptxas, cases=cases, cross_device=cross, main_path=run, kernels=kernels),
        indent=1))
    print(smi.splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
