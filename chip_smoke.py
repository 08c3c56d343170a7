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
   card, at the offline and serving paths' shapes, in float32 and bfloat16,
   with kernel, plain and library times and the bound from bytes and
   operations;
4. cross-device checks on a reduced LLaDA in float32, the card (kernels)
   against the CPU (plain versions): offline ES generation (greedy tokens
   equal, final-block confidences within 1e-4), and a staggered request
   trace through the paged ``StreamScheduler`` with early advance, parallel
   decoding (so blocks fill early and rows advance before their phase wrap)
   and the adaptive cache (every request's tokens equal);
5. offline path: LLaDA-8B at full width in bfloat16 (random weights from a
   seeded generator on the card), ES generation, with each kernel's
   launches counted over that run;
6. serving path: the same model through the paged ``StreamScheduler``
   (early advance, adaptive cache) with staggered requests, launches
   counted over that run.

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
    "paged_flash_attention": "src/repro/kernels/flash_attention.py:208",
    "scatter_rows": "src/repro/kernels/scatter_kv.py:45",
    "scatter_rows_paged": "src/repro/kernels/scatter_kv.py:78",
    "importance": "src/repro/kernels/importance.py:30",
    "variation": "src/repro/kernels/importance.py:66",
}
SOURCES = {
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "paged_flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "scatter_rows": "src/repro_torch/kernels/csrc/scatter_kv.cu",
    "scatter_rows_paged": "src/repro_torch/kernels/csrc/scatter_kv.cu",
    "importance": "src/repro_torch/kernels/csrc/importance.cu",
    "variation": "src/repro_torch/kernels/csrc/importance.cu",
}
# the serving path's shapes: 4 slots of prompt 128 + gen 64 tokens, blocks of
# 32, partial refreshes of ceil(0.25 * (192 - 32)) = 40 tokens
SLOTS, PROMPT, GEN, BLOCK = 4, 128, 64, 32
T_TOTAL = PROMPT + GEN


def sh(*cmd: str) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return out.stdout.strip()


_FLUSH: list = []


def flush_l2() -> None:
    """Rewrites a 256 MB buffer (five times the H100's 50 MB L2), so the next
    call reads its inputs from HBM, as on the paths, where the rest of a
    layer's work passes through the L2 between two launches of a kernel (the
    L2 is left dirty, as by the ``zero_`` of Triton's ``do_bench``).  The
    flush is ``bitwise_not_`` on bytes, a kernel nothing timed here uses."""
    if not _FLUSH:
        _FLUSH.append(torch.zeros(256 << 20, dtype=torch.uint8, device="cuda"))
    _FLUSH[0].bitwise_not_()


TIMER_FALLBACKS: list = []     # (flushes, other kernels) of each incomplete trace
EVENT_TIMED: list = []         # calls of device_ms timed by CUDA events instead


def _is_flush(ev) -> bool:
    return "bitwise_not" in ev.name


def device_ms(fn, n: int = 20) -> tuple[float, float]:
    """(device ms per call, wall ms per call).  Device: the profiler's kernel
    records over ``n`` calls, each after an L2 flush, the flushes left out.
    Wall: CUDA events over ``n`` back-to-back calls with no flush, host
    launches included.  The profiler now and then loses kernel records; a
    trace counts only if it holds all ``n`` flushes and a multiple of ``n``
    other kernels.  After three traces that do not, CUDA events around each
    call stand in, with a spin kernel ahead of the start event so that the
    host has queued the call before the card reaches it."""
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
                flush_l2()
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
        flushes = sum(map(_is_flush, evs))
        timed = [ev.time_range.elapsed_us() for ev in evs if not _is_flush(ev)]
        if flushes == n and timed and len(timed) % n == 0:
            return sum(timed) / n / 1e3, wall
        TIMER_FALLBACKS.append((flushes, len(timed)))
    EVENT_TIMED.append(len(TIMER_FALLBACKS))
    total = 0.0
    for _ in range(n):
        flush_l2()
        torch.cuda._sleep(2_000_000)            # about 1 ms of spinning
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / n, wall


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
        # the paged kernel's serving shape (4 slots), read densely
        cases.append(("llada block Lq=32 B=4", 4, 32, 32, 32, 192, 128, 0, dt, {}, False))
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
    d = 4096
    for dt in (torch.float32, torch.bfloat16):
        for b, kk, what in ((2, 32, "stage1"), (2, 16, "stage2"),
                            (SLOTS, 32, "stage1"), (SLOTS, 16, "stage2")):
            # the offline path's batch of 2, the serving path's slots
            label = f"llada {what} K={kk}" + (f" B={b}" if b == SLOTS else "")
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


def serving_layout(gen, ps):
    """Block tables and kv_pos of the serving path: 4 slots with prompts of
    128, 96, 64 and 32 tokens (pad-only pages unmapped), slot 2 asking for
    one block only (its last pages unmapped), physical pages shuffled."""
    n_vp = T_TOTAL // ps
    perm = torch.randperm(SLOTS * n_vp, generator=gen, device="cuda") + 1
    bt = perm.view(SLOTS, n_vp).to(torch.int32)
    pstart = torch.tensor([0, 32, 64, 96], dtype=torch.int32, device="cuda")
    vp = torch.arange(n_vp, device="cuda")[None]
    unmapped = vp < (pstart[:, None] // ps)
    unmapped[2] |= vp[0] >= -(-(PROMPT + BLOCK) // ps)
    bt = torch.where(unmapped, -1, bt).contiguous()
    pos = torch.arange(T_TOTAL, dtype=torch.int32, device="cuda")[None]
    kv_pos = torch.where(pos >= pstart[:, None], pos, -1).contiguous()
    return bt, kv_pos, SLOTS * n_vp + 1


def check_paged_flash(ref, paged_flash_attention, gen):
    out = []
    for dt in (torch.float32, torch.bfloat16):
        for arch, hq, hkv in (("llada", 32, 32), ("dream gqa", 28, 4)):
            for ps in (16, 8):
                for lq, what in ((32, "block"), (8, "skip2"), (40, "partial"), (192, "prefill")):
                    if arch != "llada" and what in ("skip2", "partial"):
                        continue
                    label = f"{arch} {what} Lq={lq} ps={ps}"
                    bt, kv_pos, n_pages = serving_layout(gen, ps)
                    kp = torch.randn(n_pages, ps, hkv, 128, generator=gen, device="cuda").to(dt)
                    vp = torch.randn(n_pages, ps, hkv, 128, generator=gen, device="cuda").to(dt)
                    q = torch.randn(SLOTS, lq, hq, 128, generator=gen,
                                    device="cuda").to(dt).transpose(1, 2)
                    # the block's positions, or every position for a prefill
                    first = PROMPT if lq < T_TOTAL else 0
                    q_pos = torch.arange(first, first + lq, dtype=torch.int32, device="cuda")
                    q_pos = q_pos[None].repeat(SLOTS, 1)
                    args = (q, kp, vp, q_pos, kv_pos, bt)
                    got = paged_flash_attention(*args)
                    want = ref.paged_attention_reference(*args)
                    err = (got.float() - want.float()).abs().max().item()
                    tol = 1e-4 if dt == torch.float32 else 2e-2
                    if not err <= tol:
                        raise AssertionError(f"paged_flash_attention {label} {dt}: max abs "
                                             f"err {err} > {tol}")
                    if not torch.isfinite(got).all():
                        raise AssertionError(f"paged_flash_attention {label}: non-finite output")
                    ms, wall = device_ms(lambda: paged_flash_attention(*args))
                    plain_ms, _ = device_ms(lambda: ref.paged_attention_reference(*args))
                    mkv = ref.paged_kv_mask(bt, kv_pos, ps)
                    mask = ref.attention_mask(q_pos, mkv)[:, None]

                    def library():            # two calls: gather the pages, then SDPA
                        k = ref.gather_pages(kp, bt).transpose(1, 2)
                        v = ref.gather_pages(vp, bt).transpose(1, 2)
                        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                              enable_gqa=hq != hkv)
                    lib_ms, _ = device_ms(library)
                    n_mapped = int((bt >= 0).sum().item())
                    page_bytes = ps * hkv * 128 * kp.element_size()
                    flops = 4.0 * hq * 128 * mask.sum().item()
                    bms, by = bound(nbytes(q, q_pos, kv_pos, bt, got) + 2 * n_mapped * page_bytes,
                                    flops, dt)
                    out.append(dict(kernel="paged_flash_attention", case=label, dtype=str(dt),
                                    max_abs_err=err, tol=tol, ms=ms, wall_ms=wall,
                                    plain_ms=plain_ms, library_ms=lib_ms,
                                    library="gather_pages + scaled_dot_product_attention",
                                    bound_ms=bms, bound_by=by, mapped_pages=n_mapped))
    return out


def check_paged_scatter(ref, scatter_rows_paged, gen):
    out = []
    h, d = 32, 128
    for dt in (torch.float32, torch.bfloat16):
        for ps in (16, 8):
            for kk, what in ((32, "block"), (40, "partial"), (192, "prefill")):
                for masks in ("none", "row", "token"):
                    if what != "block" and masks != "none":
                        continue
                    label = f"llada {what} K={kk} ps={ps} mask={masks}"
                    bt, _, n_pages = serving_layout(gen, ps)
                    kc = torch.randn(n_pages, ps, h, d, generator=gen, device="cuda").to(dt)
                    vc = torch.randn(n_pages, ps, h, d, generator=gen, device="cuda").to(dt)
                    kn = torch.randn(SLOTS, kk, h, d, generator=gen, device="cuda").to(dt)
                    vn = torch.randn(SLOTS, kk, h, d, generator=gen, device="cuda").to(dt)
                    if kk == T_TOTAL:
                        idx = torch.arange(T_TOTAL, dtype=torch.int32, device="cuda")
                        idx = idx[None].repeat(SLOTS, 1)
                    else:
                        idx = torch.stack([torch.randperm(T_TOTAL, generator=gen,
                                                          device="cuda")[:kk]
                                           for _ in range(SLOTS)]).to(torch.int32)
                    keep = None
                    if masks == "row":
                        keep = torch.tensor([True, False, True, False], device="cuda")[:, None]
                        keep = keep.expand(SLOTS, kk).contiguous()
                    elif masks == "token":
                        keep = torch.rand(SLOTS, kk, generator=gen, device="cuda") < 0.5
                    want_k = ref.scatter_rows_paged_reference(kc.clone(), kn, idx, bt, keep)
                    want_v = ref.scatter_rows_paged_reference(vc.clone(), vn, idx, bt, keep)
                    got_k, got_v = kc.clone(), vc.clone()
                    scatter_rows_paged(((got_k, kn), (got_v, vn)), idx, bt, keep)
                    # page 0 takes every row of an unmapped page: garbage, never read
                    if not (torch.equal(got_k[1:], want_k[1:])
                            and torch.equal(got_v[1:], want_v[1:])):
                        raise AssertionError(f"scatter_rows_paged {label} {dt}: not bit-exact")
                    ms, wall = device_ms(lambda: scatter_rows_paged(((got_k, kn), (got_v, vn)),
                                                                    idx, bt, keep))
                    plain_ms, _ = device_ms(lambda: (
                        ref.scatter_rows_paged_reference(got_k, kn, idx, bt, keep),
                        ref.scatter_rows_paged_reference(got_v, vn, idx, bt, keep)))
                    sel = torch.ones_like(idx, dtype=torch.bool) if keep is None else keep
                    page = torch.gather(bt.long(), 1, idx.long() // ps).clamp(min=0)
                    dest = (page * ps + idx.long() % ps)[sel]
                    fk, fv = got_k.view(-1, h, d), got_v.view(-1, h, d)
                    sk, sv = kn[sel], vn[sel]
                    lib_ms, _ = device_ms(lambda: (fk.index_copy_(0, dest, sk),
                                                   fv.index_copy_(0, dest, sv)))
                    n_rows = int(sel.sum().item())
                    row_bytes = h * d * kn.element_size()
                    # each kept fresh row read once and written once (K and V),
                    # plus the indices, the table and the mask
                    moved = 2 * 2 * n_rows * row_bytes + nbytes(idx, bt) + (
                        0 if keep is None else nbytes(keep))
                    bms, by = bound(moved, 0.0, dt)
                    out.append(dict(kernel="scatter_rows_paged", case=label, dtype=str(dt),
                                    max_abs_err=0.0, tol=0.0, ms=ms, wall_ms=wall,
                                    plain_ms=plain_ms, library_ms=lib_ms,
                                    library="index_copy_ (K and V)", bound_ms=bms,
                                    bound_by=by, rows_written=n_rows))
    return out


def check_variation(ref, variation, gen):
    out = []
    d = 4096
    for dt in (torch.float32, torch.bfloat16):
        label = f"llada partial [{SLOTS}, {T_TOTAL}, {d}]"
        hn = torch.randn(SLOTS, T_TOTAL, d, generator=gen, device="cuda").to(dt)
        ho = torch.randn(SLOTS, T_TOTAL, d, generator=gen, device="cuda").to(dt)
        ho[1, 7] = 0.0                       # a cold cached row scores a*c + (1-a)
        conf = torch.rand(SLOTS, T_TOTAL, generator=gen, device="cuda")
        got = variation(hn, ho, conf, alpha=0.5)
        want = ref.variation_reference(hn, ho, conf, 0.5)
        err = (got - want).abs().max().item()
        rel = ((got - want).abs() / want.abs()).max().item()
        if not rel <= 1e-5:
            raise AssertionError(f"variation {label} {dt}: max rel err {rel} > 1e-5")
        if abs(got[1, 7].item() - (0.5 * conf[1, 7].item() + 0.5)) > 1e-6:
            raise AssertionError("variation: a zero cached row must score a*c + (1-a)")
        ms, wall = device_ms(lambda: variation(hn, ho, conf, alpha=0.5))
        plain_ms, _ = device_ms(lambda: ref.variation_reference(hn, ho, conf, 0.5))
        flops = 6.0 * hn.numel()              # three multiply-adds per element pair
        bms, by = bound(nbytes(hn, ho, conf, got), flops, torch.float32)
        out.append(dict(kernel="variation", case=label, dtype=str(dt), max_abs_err=err,
                        max_rel_err=rel, tol=1e-5, ms=ms, wall_ms=wall, plain_ms=plain_ms,
                        library_ms=None, bound_ms=bms, bound_by=by))
    return out


# ---------------------------------------------------------------------------
# phases 4-6: the engine and the scheduler
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


def serve_trace(sched, prompts, max_new, every: int):
    """Submits request i at scheduler step i * every, drains, and returns the
    requests in submission order."""
    from repro_torch.runtime import Request

    reqs = [Request(prompt=p.copy(), max_new_tokens=m) for p, m in zip(prompts, max_new)]
    step = 0
    while step <= every * (len(reqs) - 1) or sched.has_work():
        if step % every == 0 and step // every < len(reqs):
            sched.submit(reqs[step // every])
        sched.step()
        step += 1
    return reqs


def cross_device_serving():
    """The same staggered trace through the paged scheduler with early
    advance, parallel decoding and the adaptive cache, on the card and on the
    CPU.  Parallel decoding lets a block fill before its last step, so rows
    advance early (a block advance before the phase wrap, with its jump of
    the iteration counter)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.models import Model
    from repro_torch.runtime import StreamScheduler

    cfg = dataclasses.replace(configs.reduced(configs.get_config("llada-8b")), n_layers=4)
    gen_cfg = configs.GenerationConfig(
        mode="es", gen_length=16, block_length=8,
        skip_stages=(configs.SkipStage(1, 0.5), configs.SkipStage(2, 0.5)),
        prompt_refresh_period=4, block_refresh_period=3, cache_prompt_interval=2,
        parallel_decoding=True, pd_threshold=0.5)
    cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        for p in cpu.parameters():
            if p.dim() >= 2:
                p.mul_(10.0)
    card = Model(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(SEED)
    lens, max_new = (16, 5, 12, 9, 16, 3), (None, 8, None, None, 8, None)
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32) for n in lens]
    outs = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        sched = StreamScheduler(model, gen_cfg, device=dev, max_slots=3, prompt_len=16,
                                paged=True, page_size=8, early_advance=True)
        outs[dev] = (serve_trace(sched, prompts, max_new, every=2), sched)
    for a, b in zip(outs["cpu"][0], outs["cuda"][0]):
        if a.output is None or not np.array_equal(a.output, b.output):
            raise AssertionError(f"cross-device serving tokens differ:\n{a.output}\n{b.output}")
    card_sched = outs["cuda"][1]
    if card_sched.engine.pass_counts["partial"] == 0:
        raise AssertionError("cross-device serving ran no partial refresh")
    if card_sched.stats.early_advances == 0:
        raise AssertionError("cross-device serving made no early advance")
    return dict(requests=len(prompts), tokens_equal=True,
                early_advances=card_sched.stats.early_advances,
                early_advances_cpu=outs["cpu"][1].stats.early_advances,
                passes=card_sched.engine.pass_counts,
                distinct_ids=len({int(t) for r in outs["cpu"][0] for t in r.output}))


def llada_8b():
    """LLaDA-8B at full width in bf16, random weights from a seeded generator
    on the card."""
    from repro_torch import configs
    from repro_torch.models import Model

    cfg = dataclasses.replace(configs.get_config("llada-8b"),
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def main_path(model, init_s, kernel_fns):
    from repro_torch import configs
    from repro_torch.core import make_engine

    cfg = model.cfg
    batch, prompt_len = 2, 128
    gen_cfg = configs.GenerationConfig(
        mode="es", gen_length=64, block_length=32,
        skip_stages=configs.default_skip_stages(cfg.n_layers),
        prompt_refresh_period=32, block_refresh_period=4)
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
    profile = profile_run(lambda: engine.generate(prompt))
    gen_tok = out[:, prompt_len:]
    if out.shape != (batch, prompt_len + gen_cfg.gen_length):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if (gen_tok == engine.mask_id).any().item():
        raise AssertionError("a [mask] id is left in the output")
    if not ((gen_tok >= 0) & (gen_tok < cfg.vocab_size)).all().item():
        raise AssertionError("generated ids outside the vocabulary")
    for name in ("flash_attention", "scatter_rows", "importance"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the offline path")
    return dict(arch=cfg.name, dtype="bfloat16", layers=cfg.n_layers, d_model=cfg.d_model,
                weights_gb=weights_gb, init_s=init_s, batch=batch, prompt_len=prompt_len,
                gen_length=gen_cfg.gen_length, block_length=gen_cfg.block_length,
                segments=[dataclasses.asdict(s) for s in engine.segments],
                iterations=engine.iterations, wall_s=wall, wall_s_repeats=repeats,
                tokens_per_s=batch * gen_cfg.gen_length / wall,
                tokens_per_s_best=batch * gen_cfg.gen_length / min(repeats),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                distinct_ids=len(torch.unique(gen_tok)), launches=launches, profile=profile)


def serving_path(model, kernel_fns):
    """The paged scheduler at full width: 8 requests (prompts of 32, 64, 96
    and 128 tokens, two each; 32 or 64 new tokens), one submitted every 5
    steps, so rows sit at different phases and one step runs several
    passes.  Phases 8 and 24 of each 32-step block are partial refreshes."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.runtime import StreamScheduler

    cfg = model.cfg
    gen_cfg = configs.GenerationConfig(
        mode="es", gen_length=GEN, block_length=BLOCK,
        skip_stages=configs.default_skip_stages(cfg.n_layers),
        prompt_refresh_period=8, block_refresh_period=4, cache_prompt_interval=2)
    rng = np.random.default_rng(SEED)
    lens = (32, 64, 96, 128, 32, 64, 96, 128)
    max_new = (64, 32, 64, 32, 32, 64, 32, 64)
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32) for n in lens]

    def make():
        return StreamScheduler(model, gen_cfg, device="cuda", max_slots=SLOTS,
                               prompt_len=PROMPT, paged=True, page_size=16,
                               early_advance=True)
    serve_trace(make(), prompts[:2], max_new[:2], every=5)     # warm-up
    torch.cuda.synchronize()
    sched = make()
    for fn in kernel_fns.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reqs = serve_trace(sched, prompts, max_new, every=5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernel_fns.items()}
    peak_mem = torch.cuda.max_memory_allocated() / 1e9
    for r, n in zip(reqs, max_new):
        if r.output is None or r.output.shape != (n,):
            raise AssertionError(f"request {r.request_id}: output {r.output}")
        if (r.output == sched.engine.mask_id).any():
            raise AssertionError(f"request {r.request_id}: a [mask] id is left in the output")
    if sched.allocator.free_pages != sched.allocator.num_pages - 1 or sched.stats.pages_in_use:
        raise AssertionError("the pool did not get every page back after the drain")
    for name in ("paged_flash_attention", "scatter_rows_paged", "variation", "importance"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the serving path")
    again: list = []
    profile = profile_run(lambda: again.extend(serve_trace(make(), prompts, max_new, every=5)))
    for a, b in zip(reqs, again):
        if not np.array_equal(a.output, b.output):
            raise AssertionError("a repeated greedy serving run gave other tokens")
    st = sched.stats
    tokens = sum(max_new)
    return dict(arch=cfg.name, dtype="bfloat16", slots=SLOTS, prompt_len=PROMPT,
                page_size=16, gen_length=GEN, block_length=BLOCK, requests=len(reqs),
                prompt_lens=list(lens), max_new_tokens=list(max_new), submit_every=5,
                steps=st.steps, wall_s=wall, serve_wall_s=st.wall_s,
                tokens_per_s=tokens / wall, ms_per_step=wall / st.steps * 1e3,
                latency_p50_s=st.latency_pct(50), latency_p95_s=st.latency_pct(95),
                pages_total=st.pages_total, peak_pages_in_use=st.peak_pages_in_use,
                resident_peak=st.resident_peak, early_advances=st.early_advances,
                cache_hit_fraction=st.cache_hit_fraction, peak_mem_gb=peak_mem,
                passes=dict(sched.engine.pass_counts), launches=launches, profile=profile)


def profile_run(fn, top: int = 8) -> dict:
    """Where one run's time goes on the device: the share of the wall time
    some kernel was running, and the kernels with the most device time."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
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
    from repro_torch.kernels.flash_attention import flash_attention, paged_flash_attention
    from repro_torch.kernels.importance import importance, variation
    from repro_torch.kernels.scatter_kv import scatter_rows, scatter_rows_paged

    print(sh(build.nvcc(), "--version").splitlines()[-1])
    try:
        import triton
        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton: not importable")
    kernel_fns = {"flash_attention": flash_attention,
                  "paged_flash_attention": paged_flash_attention,
                  "scatter_rows": scatter_rows, "scatter_rows_paged": scatter_rows_paged,
                  "importance": importance, "variation": variation}

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
    cases += check_paged_flash(ref, paged_flash_attention, gen)
    cases += check_paged_scatter(ref, scatter_rows_paged, gen)
    cases += check_variation(ref, variation, gen)
    print(f"timer: {len(TIMER_FALLBACKS)} incomplete profiler traces {TIMER_FALLBACKS[:20]}, "
          f"{len(EVENT_TIMED)} measurements timed by CUDA events")
    for c in cases:           # below the bound, the timer and not the kernel is at fault
        if c["ms"] < c["bound_ms"]:
            raise AssertionError(f"{c['kernel']} {c['case']} {c['dtype']}: {c['ms']} ms is "
                                 f"below its bound {c['bound_ms']} ms")
    for c in cases:
        lib = "-" if c["library_ms"] is None else f"{c['library_ms']:.4f}"
        if "+" in c.get("library", ""):
            lib += " (2 calls)"
        print(f"{c['kernel']:21s} {c['case']:34s} {c['dtype']:15s} err {c['max_abs_err']:.2e} "
              f"ms {c['ms']:.4f} (wall {c['wall_ms']:.4f}) plain {c['plain_ms']:.4f} "
              f"library {lib} bound {c['bound_ms']:.4f} ({c['bound_by']})")

    # phase 4: cross-device engine and scheduler checks
    cross = cross_device_check()
    print(f"cross-device: {json.dumps(cross)}")
    cross_serving = cross_device_serving()
    print(f"cross-device serving: {json.dumps(cross_serving)}")

    # phases 5 and 6: the offline and serving paths at full width, one model
    model, init_s = llada_8b()
    run = main_path(model, init_s, kernel_fns)
    print(f"offline path: {json.dumps(run)}")
    serving = serving_path(model, kernel_fns)
    print(f"serving path: {json.dumps(serving)}")

    # the kernels record, at a decode shape and dtype each path gives each
    # kernel: bf16 attention and K/V, f32 hidden states; launches from the
    # path that runs the kernel (the serving path for importance, which both run)
    headline = {"flash_attention": ("llada block Lq=32", torch.bfloat16),
                "paged_flash_attention": ("llada block Lq=32 ps=16", torch.bfloat16),
                "scatter_rows": ("llada block K=32", torch.bfloat16),
                "scatter_rows_paged": ("llada block K=32 ps=16 mask=none", torch.bfloat16),
                "importance": (f"llada stage1 K=32 B={SLOTS}", torch.float32),
                "variation": (f"llada partial [{SLOTS}, {T_TOTAL}, 4096]", torch.float32)}
    kernels = []
    for name, (case, dt) in headline.items():
        c = next(c for c in cases if c["kernel"] == name and c["case"] == case
                 and c["dtype"] == str(dt))
        path = serving if serving["launches"][name] else run
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=path["launches"][name],
            max_abs_err=max(x["max_abs_err"] for x in cases if x["kernel"] == name),
            ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"]))
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        dict(card=smi, torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
             ptxas=ptxas, timer_fallbacks=TIMER_FALLBACKS, event_timed=len(EVENT_TIMED),
             cases=cases, cross_device=cross, cross_device_serving=cross_serving,
             offline_path=run, serving_path=serving, kernels=kernels),
        indent=1))
    print(smi.splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
