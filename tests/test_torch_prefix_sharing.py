"""Prefix page sharing and its copy-on-write fork in the port, on the CPU.

* ``ops.fork_pages`` (the plain version here) copies pages exactly as the
  reference's ``ops.fork_pages`` does, Pallas (interpret) and XLA, with
  ``(0, 0)`` pads, and refuses aliased or out-of-range page lists;
* the refcounted ``PageAllocator`` and its typed ledger guards;
* greedy duplicates admitted in one cycle share their full prompt pages
  for life and decode exactly as offline;
* sampled duplicates fork their shared pages before their first refresh
  and decode exactly as the port's unshared run and as the reference's
  ``StreamScheduler``; a reserve no fork consumes is released.

Reduced LLaDA-8B (4 layers, weights x10) from ``test_torch_engine``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.runtime import Request as JRequest
from repro.runtime import StreamScheduler as JScheduler
from repro_torch.core import make_engine as tmake
from repro_torch.kernels import ops
from repro_torch.runtime import (
    ConfigError,
    LedgerError,
    PageAllocator,
    Request,
    SchedulerError,
    StreamScheduler,
)
from test_torch_engine import gen_configs, models

PL, PS = 16, 8
N_VP = (PL + 16) // PS              # pages of a full-length request
N_PROMPT_VP = PL // PS              # full prompt pages a duplicate shares
ES = dict(mode="es", skip_stages=((1, 0.5),), prompt_refresh_period=8, block_refresh_period=4)
SAMPLED = dict(mode="dualcache", temperature=0.8, prompt_refresh_period=0,
               block_refresh_period=1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The reduced models' ops are tiny: one intra-op thread runs them as
    fast as eight alone, and keeps them fast when several test workers
    share the CPU (each op's parallel region would wait on busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dups(vocab, n, seed, **kw):
    prompt = np.random.default_rng(seed).integers(3, vocab, PL).astype(np.int32)
    return [Request(prompt=prompt.copy(), **kw) for _ in range(n)]


def _paged(tm, tgen, **kw):
    kw.setdefault("max_slots", 4)
    return StreamScheduler(tm, tgen, device="cpu", prompt_len=PL, paged=True, page_size=PS,
                           **kw)


# ---------------------------------------------------------------------------
# the fork op
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("shape", [(2, 9, PS, 4, 128), (3, 9, PS, 2, 32)], ids=["llada", "gqa"])
def test_fork_pages_matches_reference(impl, shape):
    rng = np.random.default_rng(0)
    pools = [rng.standard_normal(shape).astype(np.float32) for _ in "kv"]
    src = np.array([1, 0, 3, 0, 0, 7, 0, 0], np.int32)     # (0, 0) pads among the pairs
    dst = np.array([4, 0, 5, 0, 0, 8, 0, 0], np.int32)
    got = [torch.from_numpy(p.copy()) for p in pools]
    ptrs = [t.data_ptr() for t in got]
    ops.fork_pages(*got, src, dst)
    assert [t.data_ptr() for t in got] == ptrs, "the fork must be in place"
    for pool, t in zip(pools, got):
        want = np.asarray(jops.fork_pages(jnp.asarray(pool), jnp.asarray(src), jnp.asarray(dst),
                                          impl=impl))
        # page 0 is the garbage page: compare the real ones
        np.testing.assert_array_equal(t.numpy()[:, 1:], want[:, 1:])
        np.testing.assert_array_equal(t.numpy()[:, [4, 5, 8]], pool[:, [1, 3, 7]])


@pytest.mark.parametrize("src,dst,why", [
    ([1, 4], [4, 5], "also sources"),           # a destination read by another pair
    ([1, 2], [5, 5], "twice"),
    ([1], [9], "outside"),
    ([-1], [3], "outside"),
    ([1, 2], [3], "destinations"),
], ids=["aliased", "duplicate", "past_end", "negative", "lengths"])
def test_fork_pages_refuses_racy_or_bad_lists(src, dst, why):
    pool = torch.zeros(2, 9, PS, 2, 32)
    with pytest.raises(ValueError, match=why):
        ops.fork_pages(pool, pool.clone(), src, dst)


# ---------------------------------------------------------------------------
# the allocator
# ---------------------------------------------------------------------------
def test_allocator_refcounts_and_prefix_index():
    al = PageAllocator(8)
    pages = al.alloc(3)
    assert al.used_pages == 3 and al.free_pages == 4
    al.share(pages[:2])
    assert al.shared_mappings == 2 and al.refcount(pages[0]) == 2
    assert al.used_pages == 3, "a shared page counts once"
    assert al.release(pages[:2]) == 0           # the shared claims free nothing
    assert al.used_pages == 3 and al.shared_mappings == 0
    assert al.release(pages) == 3
    assert al.used_pages == 0 and al.free_pages == 7
    al.register_prefix("k", (0, [(1, 5)]))
    al.register_prefix("j", (1, [(1, 6)]))
    assert al.lookup_prefix("k") == (0, [(1, 5)])
    assert al.drop_prefix_entries({6}) == 1 and al.lookup_prefix("j") is None
    al.clear_prefix_index()
    assert al.lookup_prefix("k") is None


def test_allocator_ledger_guards_raise_typed_errors():
    assert issubclass(LedgerError, SchedulerError) and not issubclass(LedgerError, AssertionError)
    al = PageAllocator(8)
    pages = al.alloc(2)
    al.release(pages)
    with pytest.raises(LedgerError, match=f"double release of page {pages[0]}"):
        al.release([pages[0]])
    with pytest.raises(LedgerError, match=f"share-after-free on page {pages[1]}"):
        al.share([pages[1]])
    p = PageAllocator(8)
    page = p.alloc(1)[0]
    p._refcount[page] = -1                      # corrupted bookkeeping
    with pytest.raises(LedgerError, match=f"negative refcount -1 on page {page}"):
        p.release([page])
    with pytest.raises(ConfigError):
        PageAllocator(1)


def test_sharing_needs_the_paged_pool():
    _, _, tm = models("llada-8b")
    with pytest.raises(ConfigError, match="paged"):
        StreamScheduler(tm, gen_configs(**ES)[1], device="cpu", prompt_len=PL,
                        prefix_sharing=True)


# ---------------------------------------------------------------------------
# greedy cohorts: share for life
# ---------------------------------------------------------------------------
def test_greedy_duplicates_share_pages_and_match_offline():
    _, _, tm = models("llada-8b")
    _, tgen = gen_configs(**ES)
    reqs = _dups(tm.cfg.vocab_size, 3, seed=0)
    sched = _paged(tm, tgen, prefix_sharing=True)
    for r in reqs:
        sched.submit(r)
    sched.step()                                 # the admission cycle's prefill
    assert sched.stats.pages_in_use == N_VP + 2 * (N_VP - N_PROMPT_VP)
    assert sched.stats.shared_mappings == 2 * N_PROMPT_VP
    assert len(sched.cohorts) == 1
    done = sched.drain()
    assert len(done) == 3 and sched.stats.cow_forks == 0, "greedy cohorts never fork"
    assert sched.stats.pages_in_use == 0 and sched.stats.shared_mappings == 0
    assert not sched.cohorts and sched.allocator.free_pages == sched.allocator.num_pages - 1
    offline = tmake(tm, tgen, device="cpu", paged=True, page_size=PS)
    ref = offline.generate(torch.from_numpy(np.stack([r.prompt for r in reqs]))).numpy()
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(r.output, ref[i, PL:])


def test_sharing_admits_more_concurrent_requests():
    """At equal pool size, a duplicate-prompt burst runs more requests at
    once with sharing on: one-block requests map 3 pages each, 2 of them
    the shared prompt, and the pool has 8."""
    _, _, tm = models("llada-8b")
    _, tgen = gen_configs(**ES)
    peaks = {}
    for sharing in (False, True):
        sched = _paged(tm, tgen, max_slots=4, kv_pages=9, prefix_sharing=sharing)
        for r in _dups(tm.cfg.vocab_size, 4, seed=1, max_new_tokens=8):
            sched.submit(r)
        assert len(sched.drain()) == 4 and sched.stats.pages_in_use == 0
        peaks[sharing] = sched.stats.resident_peak
    assert peaks[False] == 2 and peaks[True] == 4


# ---------------------------------------------------------------------------
# sampled cohorts: copy-on-write fork
# ---------------------------------------------------------------------------
SAMPLED_CASES = {"dualcache": SAMPLED,
                 "es": dict(ES, temperature=0.8, prompt_refresh_period=4, block_refresh_period=3,
                            skip_stages=((1, 0.5), (2, 0.5)))}


@pytest.mark.parametrize("case", list(SAMPLED_CASES))
def test_cow_fork_matches_unshared_replay_and_reference(case):
    """Two cohorts (3 and 2 duplicates, the second on a 12-token prompt with
    one full page) and a lone request, all admitted in one cycle."""
    jm, params, tm = models("llada-8b")
    jgen, tgen = gen_configs(**SAMPLED_CASES[case])
    rng = np.random.default_rng(2)
    a, b, c = (rng.integers(3, tm.cfg.vocab_size, n).astype(np.int32) for n in (16, 12, 9))
    prompts = [a, a, a, b, b, c]

    def run(make_sched, make_req):
        sched = make_sched()
        reqs = [make_req(prompt=p.copy(), sample_seed=100 + i) for i, p in enumerate(prompts)]
        for r in reqs:
            sched.submit(r)
        sched.drain()
        assert all(r.error is None for r in reqs)
        return [r.output for r in reqs], sched

    shared, sched = run(lambda: _paged(tm, tgen, max_slots=6, prefix_sharing=True), Request)
    assert sched.stats.cow_forks == 2 * N_PROMPT_VP + 1, "every follower forks every page once"
    assert sched.stats.pages_in_use == 0 and sched.stats.shared_mappings == 0
    assert not sched.cohorts
    assert len({o.tobytes() for o in shared[:3]}) == 3, "the seeds must diverge"
    unshared, _ = run(lambda: _paged(tm, tgen, max_slots=6), Request)
    reference, jsched = run(lambda: JScheduler(jm, params, jgen, attn_impl="xla", max_slots=6,
                                               prompt_len=PL, paged=True, page_size=PS,
                                               prefix_sharing=True), JRequest)
    assert jsched.stats.cow_forks == sched.stats.cow_forks
    for i, (x, y, z) in enumerate(zip(shared, unshared, reference)):
        np.testing.assert_array_equal(x, y, err_msg=f"request {i}: shared != unshared")
        np.testing.assert_array_equal(x, z, err_msg=f"request {i}: port != reference")


def test_unforked_cow_reserve_is_released_not_leaked():
    """A one-block sampled cohort never refreshes after its first draw, so
    the follower's reserve is never used: it must go back at retirement."""
    _, _, tm = models("llada-8b")
    _, tgen = gen_configs(**SAMPLED)
    reqs = _dups(tm.cfg.vocab_size, 2, seed=4, max_new_tokens=8)
    for i, r in enumerate(reqs):
        r.sample_seed = 7 + i
    sched = _paged(tm, tgen, max_slots=2, prefix_sharing=True)
    for r in reqs:
        sched.submit(r)
    sched.step()
    assert sum(len(v) for c in sched.cohorts for v in c["reserve"].values()) == N_PROMPT_VP
    assert len(sched.drain()) == 2 and sched.stats.cow_forks == 0
    assert sched.stats.pages_in_use == 0 and not sched.cohorts
    assert sched.allocator.free_pages == sched.allocator.num_pages - 1


def test_fork_repoints_only_the_follower():
    """After the fork the owner keeps the original prompt pages, the
    follower maps its former reserve, and no page is shared any more."""
    _, _, tm = models("llada-8b")
    _, tgen = gen_configs(**dict(SAMPLED, prompt_refresh_period=3))
    reqs = _dups(tm.cfg.vocab_size, 2, seed=5)
    sched = _paged(tm, tgen, max_slots=2, prefix_sharing=True)
    for r in reqs:
        sched.submit(r)
    sched.step()
    bt0 = sched.state.block_tables.clone()
    assert torch.equal(bt0[0, :N_PROMPT_VP], bt0[1, :N_PROMPT_VP])
    reserve = sched.cohorts[0]["reserve"][1]
    while sched.stats.cow_forks == 0:
        sched.step()
    bt1 = sched.state.block_tables
    assert torch.equal(bt1[0], bt0[0])
    assert bt1[1, :N_PROMPT_VP].tolist() == reserve
    assert torch.equal(bt1[1, N_PROMPT_VP:], bt0[1, N_PROMPT_VP:])
    assert sched.allocator.shared_mappings == 0 and not sched.cohorts
    sched.drain()
