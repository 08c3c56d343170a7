"""Sparse-dLLM eviction and page-aligned reclaim in the port, on the CPU.

* offline ``es+sparse`` (two skip stages) and ``sparse_only`` (one
  zero-ratio probe stage), dense and paged, on reduced LLaDA and Dream: the
  greedy tokens and the retained set of every refresh equal the JAX
  engine's, and a row evicted outside the current block never comes back;
* sparse attention with the adaptive cache, and with a one-block window,
  dense and paged: tokens equal the JAX engine's;
* ``dead_page_report`` equals the reference's on random states;
* paged serving at retention 0.3 reclaims pages (``pages_reclaimed`` equal
  to the JAX scheduler's and > 0) and gives the tokens of dense serving and
  of the JAX scheduler;
* a short request admitted only out of the pages an eviction returned;
* the reduced counterpart of the card's served trace: lazy reservation, a
  one-block window, the adaptive cache and sparse retention 0.5 together;
* the engine refuses sparse attention without a skip stage (``ValueError``)
  and on a pure SSM stack (``ValueError``, as the reference fails there);
* at x10 weights, on the inputs of each refresh, the two packages' retained
  sets differ only at rows whose pooled score lies within ``ULP_GAP`` ulp
  of the row's threshold.

Reduced models (4 layers) from ``test_torch_engine`` with weight matrices
x2, not x10: at x10 the probe's attention scores spread over +-2,000, its
softmax underflows to zeros and denormals, and the retained set's threshold
falls among values one ulp apart, which the two packages' summation orders
round differently.  At x2 the scores spread under 16 (no underflow) and the
tokens are still far from degenerate.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_engine as jmake
from repro.runtime import Request as JRequest
from repro.runtime import StreamScheduler as JScheduler
from repro_torch import configs as tconfigs
from repro_torch.core import make_engine as tmake
from repro_torch.models import Model
from repro_torch.runtime import Request, StreamScheduler
from test_torch_engine import gen_configs, models, prompt_for

SCALE = 2.0
PROMPT_LEN, PS = 16, 8
STAGES = {"es_sparse": ((1, 0.5), (2, 0.5)), "sparse_only": ((2, 0.0),)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The reduced models' ops are tiny: one intra-op thread runs them as
    fast as eight alone, and keeps them fast when several test workers
    share the CPU (each op's parallel region would wait on busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gens(stages="es_sparse", gen_length=16, block_length=4, **kw):
    """Sparse retention 0.5 (kernel 3), a prompt refresh every 2 iterations."""
    kw = {"prompt_refresh_period": 2, "block_refresh_period": 3, "sparse_retention": 0.5,
          **kw}
    jgen, tgen = gen_configs(mode="es", skip_stages=STAGES[stages], sparse_attention=True,
                             **kw)
    over = dict(gen_length=gen_length, block_length=block_length)
    return dataclasses.replace(jgen, **over), dataclasses.replace(tgen, **over)


def _jax_keeps(jeng):
    """Records the retained set of every ``_sparse_evict`` call of a JAX
    engine (in call order) through a debug callback."""
    keeps, evict = [], jeng._sparse_evict

    def wrapped(*args, **kwargs):
        keep = evict(*args, **kwargs)
        jax.debug.callback(lambda k: keeps.append(np.asarray(k)), keep, ordered=True)
        return keep
    jeng._sparse_evict = wrapped
    return keeps


def _torch_keeps(teng):
    """Records ``(retained set, block start, kv_valid after the refresh)`` of
    every sparse refresh of a port engine."""
    keeps, evict, prefill = [], teng._sparse_evict, teng._prefill_step

    def wrapped_evict(*args, **kwargs):
        keep = evict(*args, **kwargs)
        keeps.append([keep.clone()])
        return keep

    def wrapped_prefill(st, bs, *args, **kwargs):
        out = prefill(st, bs, *args, **kwargs)
        keeps[-1] += [bs.clone(), out[4].clone()]
        return out
    teng._sparse_evict, teng._prefill_step = wrapped_evict, wrapped_prefill
    return keeps


def _sticky(records, block_length):
    """A row evicted outside the current block stays evicted: every later
    refresh's kv_valid is False there unless the position is in that
    refresh's block."""
    dead = None
    for _, bs, kv_valid in records:
        if dead is not None:
            col = torch.arange(kv_valid.shape[1])[None]
            in_block = (col >= bs[:, None]) & (col < bs[:, None] + block_length)
            assert not (kv_valid & dead & ~in_block).any(), "an evicted row came back"
        dead = ~kv_valid


CASES = [("llada-8b", "es_sparse"), ("llada-8b", "sparse_only"), ("dream-7b", "es_sparse"),
         ("dream-7b", "sparse_only")]


@pytest.mark.parametrize("arch,stages", CASES, ids=[f"{a}-{s}" for a, s in CASES])
def test_generate_tokens_and_retained_sets_match_reference(arch, stages):
    jm, params, tm = models(arch, SCALE)
    jgen, tgen = _gens(stages)
    prompt = prompt_for(tm.cfg, seed=2)
    jeng = jmake(jm, jgen, attn_impl="xla", importance_impl="xla")
    jkeeps = _jax_keeps(jeng)
    want = np.asarray(jeng.generate(params, jnp.asarray(prompt), jax.random.PRNGKey(0)))
    assert len(np.unique(want[:, PROMPT_LEN:])) >= 10, "degenerate reference output"
    for ekw in ({}, dict(paged=True, page_size=PS)):
        teng = tmake(tm, tgen, device="cpu", **ekw)
        records = _torch_keeps(teng)
        got = teng.generate(torch.from_numpy(prompt)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(ekw))
        assert len(records) == len(jkeeps) > 4
        for i, (rec, jk) in enumerate(zip(records, jkeeps)):
            np.testing.assert_array_equal(rec[0].numpy(), jk, err_msg=f"refresh {i} {ekw}")
        # eviction really cut: each refresh kept about half the past rows
        assert not records[-1][2].all()
        _sticky(records, tgen.block_length)
        np.testing.assert_array_equal(teng.last_state.kv_valid.numpy(),
                                      records[-1][2].numpy())


# the largest distance, in float32 ulp (steps between bit patterns), of a
# pooled probe score from its row's retention threshold where the two
# packages' retained sets differ at x10 weights.  Measured on these inputs:
# one differing row, 1 ulp from its threshold (LLaDA sparse_only); none in
# the other three cases
ULP_GAP = 2


def _ulp(a, b) -> np.ndarray:
    """|a - b| in float32 ulp: the distance of their bit patterns (order
    preserving for the non-negative scores, denormals and 0 included)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


@pytest.mark.parametrize("arch,stages", CASES, ids=[f"{a}-{s}" for a, s in CASES])
def test_retained_sets_at_x10_differ_only_at_the_threshold(arch, stages, monkeypatch):
    """At x10 weights the probe's softmax underflows: its scores are zeros
    and denormals, and the threshold falls among values an ulp apart.  On
    the inputs of every refresh of the port's es+sparse run, both packages'
    probes are called; where their retained sets differ, the pooled score
    (each package's own) lies within ``ULP_GAP`` ulp of that row's
    threshold.  Nothing else is checked about those rows."""
    from repro.models.attention import KVCache as JKVCache

    jm, params, tm = models(arch, 10.0)
    jgen, tgen = _gens(stages)
    teng = tmake(tm, tgen, device="cpu")
    calls, evict = [], teng._sparse_evict

    def record(cache, hidden, bs, prompt_start, bt, kv_valid):
        calls.append((cache.k.clone(), [h.clone() for h in hidden], bs.clone(),
                      prompt_start.clone(), kv_valid.clone()))
        return evict(cache, hidden, bs, prompt_start, bt, kv_valid)
    teng._sparse_evict = record
    prompt = prompt_for(tm.cfg, seed=2)
    teng.generate(torch.from_numpy(prompt))
    assert len(calls) > 4
    jeng = jmake(jm, jgen, attn_impl="xla", importance_impl="xla")
    jcands = []
    sort = jnp.sort

    def recording_sort(a, *args, **kwargs):
        jcands.append(np.asarray(a))
        return sort(a, *args, **kwargs)
    monkeypatch.setattr(jnp, "sort", recording_sort)
    n_diff = worst = 0
    for k, hidden, bs, start, kv_valid in calls:
        b, t_total = kv_valid.shape
        jkeep = np.asarray(jeng._sparse_evict(
            params, {"kv": {"0": JKVCache(jnp.asarray(k.numpy()), jnp.asarray(k.numpy()))}},
            [jnp.asarray(h.numpy()) for h in hidden], jnp.asarray(bs.numpy()),
            jnp.zeros((b, t_total), jnp.int32), prompt_start=jnp.asarray(start.numpy()),
            kv_valid=jnp.asarray(kv_valid.numpy())))
        cand, in_block, n_keep = teng._sparse_candidates(
            tm.init_cache(b, t_total)._replace(k=k), hidden, bs, start, None, kv_valid)
        tkeep = ((cand >= torch.sort(cand, dim=-1).values[:, -n_keep][:, None])
                 | in_block).numpy()
        jcand = jcands[-1]
        for c in (cand.numpy(), jcand):
            kth = np.sort(c, axis=-1)[:, -n_keep]
            rows, cols = np.nonzero(tkeep != jkeep)
            gap = _ulp(c[rows, cols], kth[rows])
            assert (gap <= ULP_GAP).all(), (arch, stages, gap.max())
            worst = max(worst, int(gap.max(initial=0)))
        n_diff += int((tkeep != jkeep).sum())
    print(f"{arch} {stages}: {n_diff} differing rows over {len(calls)} refreshes, "
          f"worst {worst} ulp from the threshold")


@pytest.mark.parametrize("extra", [dict(cache_prompt_interval=2), dict(window_blocks=1)],
                         ids=["adaptive_cache", "window"])
def test_sparse_with_adaptive_cache_and_window_match_reference(extra):
    jm, params, tm = models("llada-8b", SCALE)
    jgen, tgen = _gens(**extra)
    prompt = prompt_for(tm.cfg, seed=4)
    want = np.asarray(jmake(jm, jgen, attn_impl="xla", importance_impl="xla")
                      .generate(params, jnp.asarray(prompt), jax.random.PRNGKey(0)))
    assert len(np.unique(want[:, PROMPT_LEN:])) >= 10, "degenerate reference output"
    for ekw in ({}, dict(paged=True, page_size=PS)):
        teng = tmake(tm, tgen, device="cpu", **ekw)
        got = teng.generate(torch.from_numpy(prompt)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(ekw))
        if "cache_prompt_interval" in extra:
            assert teng.pass_counts["partial"] > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dead_page_report_matches_reference(seed):
    jm, _, tm = models("llada-8b", SCALE)
    jgen, tgen = _gens()
    b, n_vp = 4, (PROMPT_LEN + 16) // PS
    rng = np.random.default_rng(seed)
    kv_valid = rng.random((b, n_vp * PS)) < 0.4
    kv_valid[:, rng.integers(0, n_vp * PS, 6)] = False
    kv_valid[1, :PS] = False                                # a wholly evicted page
    bt = rng.permutation(np.arange(1, b * n_vp + 1)).reshape(b, n_vp).astype(np.int32)
    bt[rng.random(bt.shape) < 0.2] = -1
    bt[:2, 0] = (1, 2)                  # slot 0's pad-only page and slot 1's evicted one
    fields = dict(kv_valid=kv_valid, bs=rng.choice([16, 20, 24, 28], b).astype(np.int32),
                  prompt_start=np.array([8, 0, 4, 0], np.int32), block_tables=bt,
                  active=np.array([True, True, False, True]))
    jst = jmake(jm, jgen, paged=True, page_size=PS).init_engine_state(
        b, PROMPT_LEN, jax.random.PRNGKey(0))
    jst = jst._replace(**{k: jnp.asarray(v) for k, v in fields.items()})
    teng = tmake(tm, tgen, device="cpu", paged=True, page_size=PS)
    tst = teng.init_engine_state(b, PROMPT_LEN)._replace(
        **{k: torch.from_numpy(v) for k, v in fields.items()})
    want = np.asarray(jmake(jm, jgen, paged=True, page_size=PS).dead_page_report(jst))
    got = teng.dead_page_report(tst)
    assert got.dtype == bool and want.any()
    np.testing.assert_array_equal(got, want)


def _serve(sched, make_req, prompts, req_kw):
    reqs = [make_req(prompt=p.copy(), **kw) for p, kw in zip(prompts, req_kw)]
    for r in reqs:
        sched.submit(r)
    for _ in range(2000):
        if not sched.has_work():
            break
        sched.step()
    assert not sched.has_work(), "the trace did not drain"
    assert all(r.error is None and r.output is not None for r in reqs)
    return [r.output for r in reqs]


def _serve_both(jgen, tgen, prompts, req_kw=None, **skw):
    """The same requests through the JAX scheduler and the port's: tokens and
    the page gauges equal; returns the port's outputs and scheduler."""
    jm, params, tm = models("llada-8b", SCALE)
    req_kw = req_kw or [{}] * len(prompts)
    jsched = JScheduler(jm, params, jgen, attn_impl="xla", prompt_len=PROMPT_LEN, **skw)
    tsched = StreamScheduler(tm, tgen, device="cpu", prompt_len=PROMPT_LEN, **skw)
    want = _serve(jsched, JRequest, prompts, req_kw)
    got = _serve(tsched, Request, prompts, req_kw)
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    names = ("pages_reclaimed", "pages_deferred", "blocks_grown", "window_stalls",
             "pages_in_use", "completed")
    jg, tg = jsched.stats.gauges(), tsched.stats.gauges()
    assert {n: tg[n] for n in names if n in jg} == {n: jg[n] for n in names if n in jg}
    return got, tsched


def test_reclaim_matches_reference_and_dense_serving():
    jgen, tgen = _gens(sparse_retention=0.3, gen_length=16, block_length=8)
    rng = np.random.default_rng(3)
    _, _, tm = models("llada-8b", SCALE)
    prompts = [rng.integers(3, tm.cfg.vocab_size, PROMPT_LEN).astype(np.int32)
               for _ in range(4)]
    got, sched = _serve_both(jgen, tgen, prompts, max_slots=2, paged=True, page_size=PS)
    assert sched.stats.pages_reclaimed > 0 and sched.stats.pages_in_use == 0
    assert sched.allocator.free_pages == sched.allocator.num_pages - 1
    dense = _serve(StreamScheduler(tm, tgen, device="cpu", prompt_len=PROMPT_LEN,
                                   max_slots=2), Request, prompts, [{}] * 4)
    for g, d in zip(got, dense):
        np.testing.assert_array_equal(g, d, err_msg="reclaim changed a request's tokens")
    assert len(np.unique(np.concatenate(got))) >= 10, "degenerate outputs"


def test_short_request_admitted_from_reclaimed_pages():
    """The pool has no room for the second request until the first one's
    eviction returns pages mid-flight."""
    jgen, tgen = _gens(sparse_retention=0.2, gen_length=32, block_length=8)
    rng = np.random.default_rng(5)
    _, _, tm = models("llada-8b", SCALE)
    prompts = [rng.integers(3, tm.cfg.vocab_size, n).astype(np.int32) for n in (PROMPT_LEN, 8)]
    n_vp_long = (PROMPT_LEN + 32) // PS
    got, sched = _serve_both(jgen, tgen, prompts, [{}, dict(max_new_tokens=8)], max_slots=2,
                             paged=True, page_size=PS, kv_pages=n_vp_long + 2)
    assert sched.stats.completed == 2 and sched.stats.pages_reclaimed > 0
    assert got[1].shape == (8,) and sched.stats.pages_in_use == 0


def test_lazy_windowed_sparse_adaptive_serving_matches_reference():
    """The card's served trace at reduced size: lazy reservation, a one-block
    window, the adaptive cache and sparse retention 0.5, staggered prompt
    lengths, half the requests allowed to grow their extent."""
    jgen, tgen = _gens(gen_length=32, block_length=8, window_blocks=1,
                       cache_prompt_interval=2, prompt_refresh_period=4)
    rng = np.random.default_rng(7)
    _, _, tm = models("llada-8b", SCALE)
    lens = (16, 9, 12, 16)
    prompts = [rng.integers(3, tm.cfg.vocab_size, n).astype(np.int32) for n in lens]
    req_kw = [dict(max_new_tokens=16, max_blocks=4), {}, dict(max_new_tokens=16, max_blocks=4),
              {}]
    got, sched = _serve_both(jgen, tgen, prompts, req_kw, max_slots=3, paged=True,
                             page_size=PS, early_advance=True, lazy_reserve=True, kv_pages=16)
    st = sched.stats
    assert st.pages_deferred > 0 and st.pages_reclaimed > 0 and st.blocks_grown > 0
    assert sched.engine.pass_counts["partial"] > 0


def test_sparse_refusals():
    _, _, tm = models("llada-8b", SCALE)
    gen = tconfigs.GenerationConfig(gen_length=16, block_length=8, sparse_attention=True)
    with pytest.raises(ValueError, match="skip stage"):
        tmake(tm, gen, device="cpu")
    mcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config("mamba2-370m")),
                               n_layers=4)
    mamba = Model(mcfg, device="cpu")
    gen = dataclasses.replace(_gens()[1], gen_length=16, block_length=8)
    with pytest.raises(ValueError, match="sparse attention.*reference"):
        tmake(mamba, gen, device="cpu")
