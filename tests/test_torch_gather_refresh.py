"""The gathered-subset prompt refresh (``gather_refresh``) in the port, on
the CPU.

When at most half the slots take a prompt refresh in a step, the
refreshing rows (and filler after them) run the prefill as a half-width
batch and its outputs scatter back; the paged pool takes their writes
through their gathered block tables.  It changes the execution plan, not
the result:

* staggered early-advance serving on two slots, the adaptive cache off,
  and on with the int8 cache: tokens equal the JAX scheduler's with
  ``gather_refresh`` and the port's without it (the reference's
  ``tests/test_feature_cache.py`` case), and the compact branch ran
  (``engine.compact_prefill``);
* a step where more than half the slots refresh runs the full-width pass;
* the launcher takes ``--paged --gather-refresh``.

The refusals (no paged pool, an SSM stack) are in ``test_torch_engine``.
Reduced LLaDA-8B (4 layers, weights x10) from ``test_torch_engine``; torch
on one intra-op thread (module fixture).
"""
import numpy as np
import pytest
import torch

from repro.runtime import Request as JRequest
from repro.runtime import StreamScheduler as JScheduler
from repro_torch.launch import serve
from repro_torch.runtime import Request, StreamScheduler
from test_torch_engine import PROMPT_LEN, gen_configs, models

PS = 8
# (GenerationConfig options, engine options): the adaptive cache off, and on
# with the int8 KV cache
CASES = {"cache_off": ({}, {}),
         "cache_on_int8": (dict(cache_prompt_interval=2), dict(kv_cache_dtype="int8"))}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(3, vocab, int(rng.integers(4, PROMPT_LEN + 1))).astype(np.int32)
            for _ in range(5)]


def _serve(sched, make_req, prompts):
    reqs = [make_req(prompt=p.copy(), sample_seed=i) for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    done = sched.drain()
    assert all(r.error is None for r in done)
    return [r.output for r in reqs]


@pytest.mark.parametrize("case", list(CASES))
def test_gather_refresh_served_matches_reference_and_plain(case):
    gen_kw, engine_kw = CASES[case]
    jm, params, tm = models("llada-8b")
    jgen, tgen = gen_configs(mode="es", skip_stages=((1, 0.5),), prompt_refresh_period=2,
                             block_refresh_period=4, **gen_kw)
    prompts = _prompts(tm.cfg.vocab_size)
    kw = dict(max_slots=2, prompt_len=PROMPT_LEN, paged=True, page_size=PS, early_advance=True,
              **engine_kw)
    sched = StreamScheduler(tm, tgen, device="cpu", gather_refresh=True, **kw)
    compact = _serve(sched, Request, prompts)
    assert sched.engine.compact_prefill > 0, "no prompt refresh ran compacted"
    assert sched.engine.compact_prefill <= sched.engine.pass_counts["prefill"]
    assert sched.stats.pages_in_use == 0
    plain = _serve(StreamScheduler(tm, tgen, device="cpu", **kw), Request, prompts)
    want = _serve(JScheduler(jm, params, jgen, attn_impl="xla", gather_refresh=True, **kw),
                  JRequest, prompts)
    assert len({int(t) for o in want for t in o}) >= 10, "degenerate reference output"
    for i, (x, y, z) in enumerate(zip(compact, plain, want)):
        np.testing.assert_array_equal(x, y, err_msg=f"request {i}: compact != plain")
        np.testing.assert_array_equal(x, z, err_msg=f"request {i}: port != reference")


def test_refresh_of_more_than_half_the_slots_runs_full_width():
    """Four slots admitted together refresh together: 4 > max(1, 4 // 2), so
    their prompt refreshes take the full-width pass; later, rows at other
    phases refresh alone and compact."""
    _, _, tm = models("llada-8b")
    tgen = gen_configs(mode="es", skip_stages=((1, 0.5),), prompt_refresh_period=2,
                       block_refresh_period=4)[1]
    prompts = _prompts(tm.cfg.vocab_size)[:4]
    sched = StreamScheduler(tm, tgen, device="cpu", max_slots=4, prompt_len=PROMPT_LEN,
                            paged=True, page_size=PS, gather_refresh=True)
    calls = []
    compact, full = sched.engine._compact_prefill, sched.engine._prefill_step
    sched.engine._compact_prefill = lambda *a, **k: calls.append("compact") or compact(*a, **k)
    sched.engine._prefill_step = lambda st, *a, **k: (calls.append(st.tokens.shape[0])
                                                      or full(st, *a, **k))
    for p in prompts:
        sched.submit(Request(prompt=p.copy()))
    sched.step()
    assert calls == [4], "the admission refresh of 4 rows runs at full width"
    assert sched.engine.compact_prefill == 0


def test_launcher_serves_with_gather_refresh(capsys):
    """Three requests on two slots: the third runs alone, so its prompt
    refreshes (one row of two) run compacted."""
    serve.main(["--device", "cpu", "--paged", "--page-size", "8", "--gather-refresh",
                "--requests", "3", "--batch", "2", "--prompt-len", "16", "--gen-length", "16",
                "--block-length", "8", "--early-advance", "--prompt-refresh-period", "2"])
    printed = capsys.readouterr().out
    assert "served 3 requests" in printed
    n = int(printed.split("compact_prefill=")[1].split()[0])
    assert n > 0
