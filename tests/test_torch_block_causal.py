"""Block-causal ES-dLLM and the persistent prefix store in the port, on the CPU.

* ``core.schedule.invariant_limit`` equals the reference's on ints, numpy
  arrays and tensors;
* ``ref.paged_attention_reference`` with every mask option equals the
  reference's ``ops.paged_attention`` (XLA and Pallas in interpret mode)
  within 1e-5, on shuffled pages with unmapped ones, MHA and GQA;
* offline ``generate`` with ``block_causal`` gives the JAX engine's greedy
  tokens on reduced LLaDA and Dream (es, dualcache, vanilla; dense and
  paged), and, with weights x2, the final block's confidences within
  1e-4;
* the full-refresh exemption is a value no-op: the caches stay within 1e-6
  of a run that rewrites every position;
* a served trace through ``StreamScheduler`` with the persistent store, the
  sliding window and the adaptive cache (whose partial refreshes may only
  touch positions past the block) gives the JAX scheduler's tokens and its
  ``prefix_hits``, ``prefix_evictions`` and ``invariant_tokens_skipped``,
  and no refresh changes a store-shared prompt page;
* the allocator's store, and the launcher with ``--block-causal``.

The three reference tests that compare two XLA calls bit for bit
(``test_bc_rows_bit_equal_prefix_masked_bidirectional`` and its two
neighbours) are not mirrored: the port is held to the tolerances above.

Reduced models (4 layers, weights x10) from ``test_torch_engine``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_engine as jmake
from repro.core.schedule import invariant_limit as jinvariant_limit
from repro.kernels import ops as jops
from repro.runtime import PageAllocator as JAllocator
from repro.runtime import Request as JRequest
from repro.runtime import StreamScheduler as JScheduler
from repro_torch.core import make_engine as tmake
from repro_torch.core import schedule as tschedule
from repro_torch.kernels import ref
from repro_torch.launch import serve
from repro_torch.runtime import (
    ConfigError,
    LedgerError,
    PageAllocator,
    Request,
    StreamScheduler,
)
from test_torch_engine import MODES, PROMPT_LEN, gen_configs, models, prompt_for

PS = 8
BC = dict(block_causal=True, prompt_refresh_period=2, block_refresh_period=3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The reduced models' ops are tiny: one intra-op thread runs them as
    fast as eight alone, and keeps them fast when several test workers
    share the CPU (each op's parallel region would wait on busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gens(mode="es", **kw):
    """Block-causal configs of 4 blocks of 4 (16 new tokens), so that the
    exemption runs at three block entries and a one-block window cuts."""
    jgen, tgen = gen_configs(**{**MODES[mode], **BC, **kw})
    return (dataclasses.replace(jgen, block_length=4), dataclasses.replace(tgen, block_length=4))


# ---------------------------------------------------------------------------
# the horizon and the paged kernel's plain version
# ---------------------------------------------------------------------------
def test_invariant_limit_matches_reference():
    jgen, tgen = _gens()
    bs = np.array([16, 24, 32, 16], np.int32)
    iters = np.array([0, 5, 9, 3], np.int32)
    want = np.asarray(jinvariant_limit(jgen, jnp.asarray(bs), jnp.asarray(iters), 16))
    np.testing.assert_array_equal(tschedule.invariant_limit(tgen, bs, iters, 16), want)
    got = tschedule.invariant_limit(tgen, torch.from_numpy(bs), torch.from_numpy(iters), 16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert [tschedule.invariant_limit(tgen, int(b), int(i), 16)
            for b, i in zip(bs, iters)] == want.tolist()
    assert tschedule.invariant_limit(gen_configs(**MODES["es"])[1], bs, iters, 16) is None


OPTIONS = [
    dict(),
    dict(causal=True),
    dict(bc_start=16, bc_block=8),
    dict(window=5, anchor=0),
    dict(window=5, anchor=6),
    dict(window=7, anchor=4, bc_start=16, bc_block=8),
]


@pytest.mark.parametrize("opts", OPTIONS, ids=lambda o: "-".join(o) or "none")
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_paged_reference_options_match_reference(opts, hq, hkv, impl):
    rng = np.random.default_rng(len(opts) + hkv)
    b, n_vp = 3, 5
    bt = rng.permutation(np.arange(1, 17))[: b * n_vp].astype(np.int32).reshape(b, n_vp)
    bt[0, 0], bt[1, 4] = -1, -1
    t_total = n_vp * PS
    pos = np.tile(np.arange(t_total, dtype=np.int32), (b, 1))
    kv_pos = np.where(pos >= np.array([[3], [PS + 2], [0]]), pos, -1).astype(np.int32)
    pool_k, pool_v = (rng.standard_normal((17, PS, hkv, 32), np.float32) for _ in "kv")
    q = rng.standard_normal((b, hq, 8, 32), np.float32)
    q_pos = rng.integers(0, t_total, (b, 8)).astype(np.int32)
    want = np.asarray(jops.paged_attention(
        *(jnp.asarray(a) for a in (q, pool_k, pool_v, q_pos, kv_pos, bt)),
        page_size=PS, impl=impl, **opts))
    got = ref.paged_attention_reference(
        *(torch.from_numpy(a) for a in (q, pool_k, pool_v, q_pos, kv_pos, bt)), **opts)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# offline generation
# ---------------------------------------------------------------------------
def _jax_generate_with_conf(jeng, params, prompt):
    """The reference's ``generate`` loop with its last block run step by
    step, so the final block's confidences can be read: (tokens, conf)."""
    gen = jeng.gen
    b, p = prompt.shape
    lb, spb = gen.block_length, gen.resolved_steps()
    tokens = jnp.concatenate([jnp.asarray(prompt),
                              jnp.full((b, gen.gen_length), jeng.mask_id, jnp.int32)], 1)
    t_total = p + gen.gen_length
    key, seeds = jax.random.PRNGKey(0), jnp.arange(b, dtype=jnp.int32)
    pstart = jnp.zeros((b,), jnp.int32)
    kv_valid, caches = jnp.ones((b, t_total), bool), jeng._init_caches(b, t_total)
    n_blocks = gen.gen_length // lb
    for blk in range(n_blocks - 1):
        bs = jnp.full((b,), p + blk * lb, jnp.int32)
        iters0 = jnp.full((b,), blk * spb, jnp.int32)
        tokens, kv_valid, _, _, caches = jeng._jit_run_block(
            params, tokens, kv_valid, None, None, caches, key, bs, iters0, seeds, pstart, None)
    bs = jnp.full((b,), p + (n_blocks - 1) * lb, jnp.int32)
    iters0 = jnp.full((b,), (n_blocks - 1) * spb, jnp.int32)
    st = jeng.make_block_state(tokens, key)._replace(kv_valid=kv_valid, caches=caches)

    @jax.jit
    def body(st):
        outs = jeng._iteration_outputs(params, st, bs, None, iters=iters0 + st.t, seeds=seeds,
                                       prompt_start=pstart, block_tables=None)
        return jeng._apply_unmask(st, bs, *outs)

    blk_cols = slice(p + (n_blocks - 1) * lb, p + n_blocks * lb)
    while int(st.t) == 0 or (int(st.t) < spb + 1
                             and bool((st.tokens[:, blk_cols] == jeng.mask_id).any())):
        st = body(st)
    return np.asarray(st.tokens), np.asarray(st.conf)


@pytest.mark.parametrize("arch", ["llada-8b", "dream-7b"])
@pytest.mark.parametrize("mode", ["es", "dualcache", "vanilla"])
def test_generate_tokens_match_reference(arch, mode):
    jm, params, tm = models(arch)
    jgen, tgen = _gens(mode)
    prompt = prompt_for(tm.cfg)
    want = np.asarray(jmake(jm, jgen, attn_impl="xla", importance_impl="xla")
                      .generate(params, jnp.asarray(prompt), jax.random.PRNGKey(0)))
    assert len(np.unique(want[:, PROMPT_LEN:])) >= 10, "degenerate reference output"
    engine = tmake(tm, tgen, device="cpu")
    np.testing.assert_array_equal(engine.generate(torch.from_numpy(prompt)).numpy(), want)
    if mode != "vanilla":           # dense equals paged
        paged = tmake(tm, tgen, device="cpu", paged=True, page_size=PS)
        np.testing.assert_array_equal(paged.generate(torch.from_numpy(prompt)).numpy(), want)


@pytest.mark.parametrize("arch", ["llada-8b", "dream-7b"])
def test_final_block_confidences_match_reference(arch):
    """The final block's confidences of an es run, block-causal and windowed,
    within 1e-4, with weights x2: x10 pushes the hidden states past 1e3,
    where one float32 ulp already moves a confidence by more, and at the
    init scale Dream's skip-stage scores tie, so the kept rows may differ."""
    jm, params, tm = models(arch, scale=2.0)
    jgen, tgen = _gens(window_blocks=1)
    prompt = prompt_for(tm.cfg, seed=4)
    want, want_conf = _jax_generate_with_conf(
        jmake(jm, jgen, attn_impl="xla", importance_impl="xla"), params, prompt)
    engine = tmake(tm, tgen, device="cpu")
    np.testing.assert_array_equal(engine.generate(torch.from_numpy(prompt)).numpy(), want)
    np.testing.assert_allclose(engine.last_state.conf.numpy(), want_conf, atol=1e-4, rtol=0)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_invariant_exemption_is_value_noop(paged, monkeypatch):
    """Forcing every full refresh to rewrite every position changes the
    tokens in nothing and the caches by at most 1e-6: the exempt positions'
    K/V are final under block-causal masking."""
    _, _, tm = models("llada-8b")
    _, tgen = _gens()
    prompt = torch.from_numpy(prompt_for(tm.cfg, seed=9))
    ekw = dict(paged=True, page_size=PS) if paged else {}
    exempt = tmake(tm, tgen, device="cpu", **ekw)
    tok_exempt = exempt.generate(prompt)
    monkeypatch.setattr("repro_torch.core.engine.invariant_limit",
                        lambda gen, bs, iters, gen_start: None)
    full = tmake(tm, tgen, device="cpu", **ekw)
    tok_full = full.generate(prompt)
    np.testing.assert_array_equal(tok_exempt.numpy(), tok_full.numpy())
    lo = 1 if paged else 0          # page 0 is the garbage page
    for a, b in zip(exempt.last_state.cache, full.last_state.cache):
        np.testing.assert_allclose(a[:, lo:].numpy(), b[:, lo:].numpy(), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the persistent prefix store
# ---------------------------------------------------------------------------
def test_allocator_persistent_store_unit():
    for al in (PageAllocator(8, persistent=True), JAllocator(8, persistent=True)):
        g1, g2 = al.alloc(3), al.alloc(2)
        al.register_prefix("k1", (0, [(0, g1[0]), (1, g1[1])]))
        al.register_prefix("k2", (1, [(0, g2[0])]))
        al.release(g1)
        al.release(g2)                   # every slot claim dies
        assert al.used_pages == 3 and al.reclaimable_pages == 3
        assert al.lookup_prefix("k1") is not None      # LRU touch: k1 is now the newest
        got = al.alloc(6)                # pool pressure: evicts k2, then k1
        assert got is not None and len(got) == 6 and al.prefix_evictions == 2
        assert al.lookup_prefix("k1") is None and al.lookup_prefix("k2") is None
        al.release(got)
        assert al.free_pages == al.num_pages - 1
    al = PageAllocator(8, persistent=True)
    hot = al.alloc(2)
    al.register_prefix("hot", (0, [(0, hot[0]), (1, hot[1])]))
    assert al.reclaimable_pages == 0 and al.alloc(6) is None, \
        "an entry whose pages a live slot maps frees nothing and is not evicted"
    assert al.prefix_evictions == 0 and al.lookup_prefix("hot") is not None
    assert al.drop_prefix_entries({hot[0]}) == 1 and al.refcount(hot[0]) == 1
    al.register_prefix("x", (0, [(0, hot[1])]))
    with pytest.raises(LedgerError, match="re-registering"):
        al.register_prefix("x", (0, [(0, hot[1])]))


def test_persistent_store_requires_block_causal():
    _, _, tm = models("llada-8b")
    kw = dict(device="cpu", prompt_len=PROMPT_LEN, paged=True, page_size=PS,
              prefix_sharing=True)
    bidi = StreamScheduler(tm, gen_configs(**MODES["es"])[1], **kw)
    assert not bidi.persistent_prefix and not bidi.allocator.persistent
    bc = StreamScheduler(tm, _gens()[1], **kw)
    assert bc.persistent_prefix and bc.allocator.persistent


# (arrival step, prompt id, max_new_tokens): prompt 0 comes back after its
# first request retired (a store hit in a later cycle), prompt 1 twice in
# one cycle, and the pool is one request short, so admissions evict
TRACE = [(0, 0, None), (0, 1, None), (1, 1, 8), (4, 2, None), (9, 0, None),
         (10, 3, 8), (14, 0, 8)]
SERVE = dict(window_blocks=1, cache_prompt_interval=2)


def _serve(make_sched, make_req, vocab, check=None):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, vocab, n).astype(np.int32) for n in (16, 14, 16, 11)]
    sched = make_sched()
    reqs = [make_req(prompt=prompts[i].copy(), max_new_tokens=m, sample_seed=100 + j)
            for j, (_, i, m) in enumerate(TRACE)]
    step = 0
    while step <= TRACE[-1][0] or sched.has_work():
        for (at, _, _), r in zip(TRACE, reqs):
            if at == step:
                sched.submit(r)
        sched.step()
        if check is not None:
            check(sched)
        step += 1
    return reqs, sched


class _StorePagesUnchanged:
    """After every step: the bytes of each store entry's prompt pages equal
    what they held at the end of the step that registered the entry."""

    def __init__(self):
        self.snap, self.checked = {}, 0

    def __call__(self, sched):
        st = sched.state
        live = {}
        for key, (_, page_map) in sched.allocator._prefix.items():
            for _, pg in page_map:
                live[(key, pg)] = (st.cache.k[:, pg].clone(), st.cache.v[:, pg].clone())
        for k, (kb, vb) in live.items():
            if k in self.snap:
                assert torch.equal(kb, self.snap[k][0]) and torch.equal(vb, self.snap[k][1]), \
                    f"a refresh wrote store-shared page {k[1]}"
                self.checked += 1
        self.snap = {k: self.snap.get(k, v) for k, v in live.items()}


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_served_trace_matches_reference_scheduler(sampled):
    jm, params, tm = models("llada-8b")
    extra = dict(temperature=0.8) if sampled else {}
    jgen, tgen = _gens(**SERVE, **extra)
    n_vp = (PROMPT_LEN + tgen.gen_length) // PS
    kw = dict(max_slots=2, prompt_len=PROMPT_LEN, paged=True, page_size=PS,
              kv_pages=2 * n_vp + 1, prefix_sharing=True, early_advance=True)
    jreqs, jsched = _serve(lambda: JScheduler(jm, params, jgen, attn_impl="xla", **kw),
                           JRequest, tm.cfg.vocab_size)
    check = _StorePagesUnchanged()
    reqs, sched = _serve(lambda: StreamScheduler(tm, tgen, device="cpu", **kw), Request,
                         tm.cfg.vocab_size, check)
    for r, jr in zip(reqs, jreqs):
        assert r.error is None and r.output is not None
        np.testing.assert_array_equal(r.output, jr.output)
    for name in ("prefix_hits", "prefix_evictions", "invariant_tokens_skipped"):
        assert getattr(sched.stats, name) == getattr(jsched.stats, name), name
    assert sched.stats.prefix_hits > 0 and sched.stats.prefix_evictions > 0
    assert sched.stats.invariant_tokens_skipped > 0 and sched.stats.cow_forks == 0
    assert check.checked > 0
    assert sched.stats.gauges()["prefix_hits"] == sched.stats.prefix_hits
    # every slot claim is gone; only the store's remain
    assert sched.allocator.used_pages == sched.allocator.reclaimable_pages


def test_serve_launcher_block_causal_window_and_store(capsys):
    done = serve.main(["--device", "cpu", "--paged", "--page-size", "8", "--prefix-sharing",
                       "--dup-prompts", "--block-causal", "--window-blocks", "1",
                       "--early-advance", "--requests", "3", "--batch", "2",
                       "--prompt-len", "16", "--gen-length", "24", "--block-length", "8"])
    assert len(done) == 3 and all(r.error is None and r.output.shape == (24,) for r in done)
    out = capsys.readouterr().out
    assert "prefix_hits=2" in out and "invariant_tokens_skipped=" in out
    with pytest.raises(ConfigError, match="window-blocks"):
        serve.main(["--device", "cpu", "--window-blocks", "-1"])
