"""The port's encoder-conditioned archs served, against the JAX reference's
scheduler, on the CPU.

Reduced Llama-3.2-Vision and SeamlessM4T at x10 weights (as in
``test_torch_cross``); every request carries its own ``enc_embeds``.  One
jitted reference engine serves every scheduler of a gen config and pool:

* the reference's own encoder-family case (``tests/test_scheduler.py``:
  SeamlessM4T at the init scale, dualcache, 3 requests on 2 dense slots)
  gets the reference's tokens, and both refuse a request without
  ``enc_embeds`` afterwards;
* a staggered trace on dense slots, then on the paged pool with early
  advance (the vision model sampled, whose paged pool holds its
  self-attention K/V; SeamlessM4T greedy, whose pool has no K/V plane, with
  its cross planes after the trace equal to the reference's): the
  reference's tokens.  Sampled SeamlessM4T is held to the port's own
  offline replay instead: its decoder has no self-attention, so its
  block's [mask] rows tie, and the reference's confidences of one tie
  differ by an ulp between pass shapes while the port's do not;
* preemption on one slot and a tight pool spills the resident, which is
  encoded again when it resumes (``Model.encode`` counted): the reference's
  tokens, and each request's uninterrupted run;
* the modality checks at submit, both ways, in both packages;
* prefix sharing maps no page on an encoder arch, whatever the prompts;
* both launchers fail alike on ``--arch seamless-m4t-large-v2``: they make
  no ``enc_embeds``, so the first submit raises.
"""
import functools
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import make_engine as jmake
from repro.launch import serve as jserve
from repro.models import build_model as jbuild
from repro.runtime import Request as JRequest
from repro.runtime import StreamScheduler as JScheduler
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import make_engine as tmake
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.runtime import Request, StreamScheduler
from test_torch_cross import AUDIO, VLM, models, stages

PL, PS = 16, 8
N_VP = (PL + 16) // PS
# 8 steps a block: prompt refreshes at phases 0 and 4, block refreshes at 3
# and 6, skip decodes between
SERVE = dict(mode="es", gen_length=16, block_length=8, prompt_refresh_period=4,
             block_refresh_period=3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the reduced models' ops are tiny, and several
    test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gen_configs(arch, **kw):
    st = stages(models(arch)[2].cfg)
    return tuple(c.GenerationConfig(skip_stages=tuple(c.SkipStage(*s) for s in st),
                                    **dict(SERVE, **kw)) for c in (jconfigs, tconfigs))


@functools.lru_cache(maxsize=None)
def engines(arch, temperature=0.0, paged=True, pool=None, slots=3):
    """(reference engine, reference gen, port gen): one jitted reference
    step for every scheduler of a gen config and pool."""
    jgen, tgen = gen_configs(arch, temperature=temperature)
    pkw = dict(paged=True, page_size=PS, kv_pages=pool or slots * N_VP + 1,
               early_advance=True) if paged else {}
    return jmake(models(arch)[0], jgen, importance_impl="pallas", **pkw), jgen, tgen


def _schedulers(arch, temperature=0.0, paged=True, slots=3, pool=None, **kw):
    jm, params, tm, _ = models(arch)
    jeng, jgen, tgen = engines(arch, temperature, paged, pool, slots)
    skw = dict(max_slots=slots, prompt_len=PL, **kw)
    if paged:
        skw.update(paged=True, page_size=PS, kv_pages=pool or slots * N_VP + 1,
                   early_advance=True)
    return (JScheduler(jm, params, jgen, engine=jeng, **skw),
            StreamScheduler(tm, tgen, device="cpu", **skw))


def _requests(cfg, lens, seed, **kw):
    """(prompt, enc_embeds) pairs, one per prompt length."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(3, cfg.vocab_size, n).astype(np.int32),
             rng.normal(size=(cfg.n_enc_tokens, cfg.d_enc)).astype(np.float32)) for n in lens]


def _drive(sched, reqs, arrivals):
    step = 0
    while step <= max(arrivals) or sched.has_work():
        for at, r in zip(arrivals, reqs):
            if at == step:
                sched.submit(r)
        sched.step()
        step += 1
    assert all(r.error is None and r.output is not None for r in reqs)
    return [r.output for r in reqs]


def _both(arch, pairs, arrivals, scheds, **req_kw):
    """Drives the same requests through the reference's and the port's
    scheduler: (reference outputs, port outputs)."""
    outs = []
    for make_req, sched in zip((JRequest, Request), scheds):
        reqs = [make_req(prompt=p.copy(), enc_embeds=e.copy(), sample_seed=100 + i,
                         **{k: v[i] for k, v in req_kw.items()})
                for i, (p, e) in enumerate(pairs)]
        outs.append(_drive(sched, reqs, arrivals))
    return outs


def test_reference_encoder_family_case():
    """The reference's ``test_encoder_family_streams``: SeamlessM4T at the
    init scale, dualcache with one block of 8, 3 requests of 6-token
    prompts on 2 dense slots; then a request without ``enc_embeds`` is
    refused by both."""
    jm, params, tm, _ = models(AUDIO, 1.0)
    cfg = tm.cfg
    gens = [c.GenerationConfig(gen_length=8, block_length=8, mode="dualcache",
                               prompt_refresh_period=0, block_refresh_period=1)
            for c in (jconfigs, tconfigs)]
    scheds = (JScheduler(jm, params, gens[0], max_slots=2, prompt_len=8),
              StreamScheduler(tm, gens[1], max_slots=2, prompt_len=8, device="cpu"))
    outs = []
    for make_req, sched in zip((JRequest, Request), scheds):
        rng = np.random.default_rng(0)
        reqs = [make_req(prompt=rng.integers(3, cfg.vocab_size, 6).astype(np.int32),
                         enc_embeds=rng.normal(size=(cfg.n_enc_tokens, cfg.d_enc)
                                               ).astype(np.float32)) for _ in range(3)]
        for r in reqs:
            sched.submit(r)
        done = sched.drain()
        assert len(done) == 3 and all((r.output < cfg.vocab_size).all() for r in done)
        outs.append([r.output for r in reqs])
        with pytest.raises(ValueError, match="modality"):
            sched.submit(make_req(prompt=np.arange(3, 9, dtype=np.int32)))
    for i, (x, y) in enumerate(zip(*outs)):
        np.testing.assert_array_equal(y, x, err_msg=f"request {i}")


# (step at which it arrives, prompt length, max_new_tokens)
TRACE = [(0, 16, None), (0, 5, 8), (0, 12, None), (2, 9, None), (5, 16, 8), (6, 3, None)]


@pytest.mark.parametrize("arch,paged,temperature", [(VLM, False, 0.0), (VLM, True, 0.8),
                                                    (AUDIO, True, 0.0)],
                         ids=["vlm-dense", "vlm-paged-sampled", "audio-paged"])
def test_trace_matches_reference(arch, paged, temperature):
    """Six staggered requests on 3 slots: every request's tokens equal the
    reference scheduler's.  On the paged pool with early advance, the
    pool's pages all return; SeamlessM4T's cross planes after the trace
    equal the reference's within 1e-4 of their largest value (each slot
    holds its last request's)."""
    jsched, sched = _schedulers(arch, temperature, paged)
    cfg = sched.engine.model.cfg
    pairs = _requests(cfg, [n for _, n, _ in TRACE], seed=11)
    want, got = _both(arch, pairs, [at for at, _, _ in TRACE], (jsched, sched),
                      max_new_tokens=[m for _, _, m in TRACE])
    for i, (x, y) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(x, y, err_msg=f"request {i}")
    assert sched.stats.shared_mappings == 0
    if arch == VLM:
        assert len({len(np.unique(o)) for o in got}) > 1
        assert all(sched.engine.pass_counts[k] for k in ("skip", "noskip", "prefill"))
    if paged:
        assert sched.allocator.free_pages == sched.allocator.num_pages - 1
    if arch == AUDIO:
        assert sched.engine.model.attn_layers == [] and sched.engine._pools(sched.state) == ()
        # x10 weights: the planes reach about 10, so 1e-4 of their largest
        # value (float32 sums in another order)
        jc = jsched.state.caches["cross"]["0"]
        for name in ("k", "v"):
            want_plane = np.asarray(getattr(jc, name))
            np.testing.assert_allclose(getattr(sched.state.cache.cross, name).numpy(),
                                       want_plane, rtol=0,
                                       atol=1e-4 * np.abs(want_plane).max())


def _replay(tm, tgen, prompt, enc, seed, max_new=None, **kw):
    """A served request's uninterrupted run: offline at batch 1 with its
    seed, its pad rows masked as the paged scheduler masks them."""
    row = np.zeros((1, PL), np.int32)
    row[0, PL - len(prompt):] = prompt
    out = tmake(tm, tgen, device="cpu", **kw).generate(
        torch.from_numpy(row), torch.tensor([PL - len(prompt)], dtype=torch.int32),
        enc_embeds=torch.from_numpy(enc[None]), sample_seeds=torch.tensor([seed]))
    return out.numpy()[0, PL:PL + (max_new or tgen.gen_length)]


def test_sampled_audio_trace_replays_offline():
    """SeamlessM4T sampled on the paged pool: each request's tokens equal
    its own offline run with its seed, whatever shared its slots' passes."""
    tm = models(AUDIO)[2]
    _, tgen = gen_configs(AUDIO, temperature=0.8)
    sched = StreamScheduler(tm, tgen, max_slots=3, prompt_len=PL, paged=True, page_size=PS,
                            early_advance=True, device="cpu")
    pairs = _requests(tm.cfg, [n for _, n, _ in TRACE], seed=11)
    reqs = [Request(prompt=p.copy(), enc_embeds=e.copy(), sample_seed=100 + i,
                    max_new_tokens=m) for i, ((p, e), (_, _, m)) in enumerate(zip(pairs, TRACE))]
    got = _drive(sched, reqs, [at for at, _, _ in TRACE])
    assert sched.engine.pass_counts["skip"] > 0 and len({o.tobytes() for o in got}) > 1
    for i, ((p, e), (_, _, m)) in enumerate(zip(pairs, TRACE)):
        np.testing.assert_array_equal(got[i], _replay(tm, tgen, p, e, 100 + i, m, paged=True,
                                                      page_size=PS), err_msg=f"request {i}")


def test_preemption_reencodes_and_matches_reference(monkeypatch):
    """One slot and a pool of one full-length request: a class-1 arrival
    spills the class-0 resident at its block boundary, which resumes at
    phase 0 and is encoded again (its cross planes are rebuilt from the
    encoder plane); tokens equal the reference scheduler's and each
    request's uninterrupted run."""
    tm = models(VLM)[2]
    encodes = []
    encode = tm.encode
    monkeypatch.setattr(tm, "encode", lambda x: encodes.append(x.shape) or encode(x))
    pairs = _requests(tm.cfg, [PL, PL], seed=7)
    scheds = _schedulers(VLM, slots=1, pool=N_VP + 1, preemption=True)
    want, got = _both(VLM, pairs, [0, 3], scheds, priority=[0, 1])
    for sched in scheds:
        assert sched.stats.preemptions >= 1
    sched = scheds[1]
    assert len(encodes) == 2 + sched.stats.preemptions, "a resumed request is encoded again"
    _, tgen = gen_configs(VLM)
    for i, (p, e) in enumerate(pairs):
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"request {i} vs reference")
        np.testing.assert_array_equal(got[i], _replay(tm, tgen, p, e, 100 + i),
                                      err_msg=f"request {i} vs uninterrupted")


def test_modality_checks_at_submit_both_ways():
    """An encoder arch refuses a request without ``enc_embeds``, an arch
    without an encoder one with them, in both packages, and nothing is
    queued."""
    llada = "llada-8b"
    jcfg, tcfg = (c.reduced(c.get_config(llada)) for c in (jconfigs, tconfigs))
    jm = jbuild(jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(params_from_numpy(tree, tcfg, "cpu"))
    jgen, tgen = (c.GenerationConfig(gen_length=16, block_length=8) for c in (jconfigs, tconfigs))
    cases = [(JScheduler(jm, jax.tree_util.tree_map(jnp.asarray, tree), jgen, max_slots=2,
                         prompt_len=PL), JRequest, np.zeros((4, 8), np.float32), "supplied"),
             (StreamScheduler(tm, tgen, max_slots=2, prompt_len=PL, device="cpu"), Request,
              np.zeros((4, 8), np.float32), "supplied")]
    for make_req, sched in zip((JRequest, Request), _schedulers(VLM, paged=False)):
        cases.append((sched, make_req, None, "omitted"))
    for sched, make_req, enc, word in cases:
        with pytest.raises(ValueError, match=f"modality mismatch.*{word}"):
            sched.submit(make_req(prompt=np.arange(3, 9, dtype=np.int32), enc_embeds=enc))
        assert not sched.queue


def test_no_prefix_sharing_on_an_encoder_arch():
    """Three requests with one prompt in one admission cycle, prefix sharing
    on: an encoder arch's prompt K/V depend on the encoder tokens, so no
    page is shared, in either package, and the tokens agree."""
    cfg = models(VLM)[2].cfg
    prompt = np.random.default_rng(3).integers(3, cfg.vocab_size, PL).astype(np.int32)
    pairs = [(prompt, e) for _, e in _requests(cfg, [PL] * 3, seed=4)]
    scheds = _schedulers(VLM, prefix_sharing=True)
    want, got = _both(VLM, pairs, [0, 0, 0], scheds)
    for sched in scheds:
        assert sched.stats.shared_mappings == 0
    for i, (x, y) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(x, y, err_msg=f"request {i}")


def test_launchers_fail_alike_on_an_encoder_arch(monkeypatch):
    """Neither launcher makes ``enc_embeds``: on SeamlessM4T the first submit
    raises the same modality error in both (request ids aside)."""
    argv = ["--arch", AUDIO, "--requests", "2", "--batch", "2", "--gen-length", "16",
            "--block-length", "8", "--prompt-len", "16"]
    errors = []
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)     # the reference parses sys.argv
    for run in (jserve.main, lambda: serve.main(argv + ["--device", "cpu"])):
        with pytest.raises(ValueError, match="modality mismatch") as exc:
            run()
        errors.append(re.sub(r"request \d+", "request", str(exc.value)))
    assert errors[0] == errors[1]
