"""The port's lock-step ``BatchServer`` against the reference's, on the CPU.

* ``prng.split`` equals ``jax.random.split`` bit for bit (the server's key
  chain: ``key, sub = split(key)`` a batch);
* 6 requests of mixed prompt lengths through batches of 4 with prompt 16,
  so the second batch is padded by repeating its last request, greedy and
  at temperature 0.7: every request's tokens equal the reference server's,
  and so do ``stats.requests`` and ``stats.tokens_generated`` (only the
  real requests count);
* both servers group a mixed queue by ``enc_embeds`` presence into
  modality-homogeneous batches, with equal tokens;
* the launcher's ``--runtime batch`` runs end to end.

Reduced LLaDA-8B (4 layers, weight matrices x10) from ``test_torch_engine``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.runtime import BatchServer as JBatchServer
from repro.runtime import Request as JRequest
from repro_torch.core import prng
from repro_torch.launch import serve
from repro_torch.runtime import BatchServer, Request, pad_and_stack
from test_torch_engine import gen_configs, models

PL, BATCH = 16, 4
PROMPT_LENS = (16, 5, 12, 9, 16, 3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The reduced models' ops are tiny: one intra-op thread runs them as
    fast as eight alone, and keeps them fast when several test workers
    share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [0, 1, 7, 42])
@pytest.mark.parametrize("num", [2, 3])
def test_split_equals_jax(seed, num):
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num)).astype(np.int64)
    np.testing.assert_array_equal(prng.split(prng.prng_key(seed), num).numpy(), want)


def test_split_chain_equals_jax():
    """Three links of the server's ``key, sub = split(key)`` chain."""
    jkey, tkey = jax.random.PRNGKey(5), prng.prng_key(5)
    for _ in range(3):
        jkey, jsub = jax.random.split(jkey)
        tkey, tsub = prng.split(tkey)
        np.testing.assert_array_equal(tkey.numpy(), np.asarray(jkey).astype(np.int64))
        np.testing.assert_array_equal(tsub.numpy(), np.asarray(jsub).astype(np.int64))


def _serve(server, make_req, vocab):
    rng = np.random.default_rng(9)
    reqs = [make_req(prompt=rng.integers(3, vocab, n).astype(np.int32)) for n in PROMPT_LENS]
    for r in reqs:
        server.submit(r)
    done = server.drain()
    assert [r.request_id for r in done] == [r.request_id for r in reqs]
    return reqs


@pytest.mark.parametrize("temperature", [0.0, 0.7], ids=["greedy", "t0.7"])
def test_batch_server_matches_reference(temperature):
    jm, params, tm = models("llada-8b")
    jgen, tgen = gen_configs(mode="es", skip_stages=((1, 0.5), (2, 0.5)),
                             temperature=temperature)
    jserver = JBatchServer(jm, params, jgen, batch_size=BATCH, prompt_len=PL, seed=3)
    jreqs = _serve(jserver, JRequest, tm.cfg.vocab_size)
    server = BatchServer(tm, tgen, batch_size=BATCH, prompt_len=PL, seed=3, device="cpu")
    reqs = _serve(server, Request, tm.cfg.vocab_size)
    for r, jr in zip(reqs, jreqs):
        assert r.output.shape == (tgen.gen_length,)
        np.testing.assert_array_equal(r.output, np.asarray(jr.output))
    assert len({tuple(r.output) for r in reqs}) > 1
    assert server.stats.requests == len(PROMPT_LENS)
    assert server.stats.tokens_generated == len(PROMPT_LENS) * tgen.gen_length
    assert server.stats.requests == jserver.stats.requests
    assert server.stats.tokens_generated == jserver.stats.tokens_generated
    assert len(server.batch_wall_s) == 2 and server.stats.tps > 0


def test_first_batch_equals_generate_with_the_chain_key():
    """The first batch is one ``engine.generate`` of the stacked prompts with
    the second half of ``split(prng_key(seed))`` and row-index seeds."""
    _, _, tm = models("llada-8b")
    _, tgen = gen_configs(mode="es", skip_stages=((1, 0.5),), temperature=0.7)
    server = BatchServer(tm, tgen, batch_size=BATCH, prompt_len=PL, seed=11, device="cpu")
    reqs = _serve(server, Request, tm.cfg.vocab_size)
    prompts = torch.from_numpy(pad_and_stack(reqs[:BATCH], 0, PL))
    want = server.engine.generate(prompts, key=prng.split(prng.prng_key(11))[1]).numpy()
    for i, r in enumerate(reqs[:BATCH]):
        np.testing.assert_array_equal(r.output, want[i, PL:])


def test_enc_embeds_refused_at_submit():
    """A mixed queue: the port's server groups requests by ``enc_embeds``
    presence, as the reference's does (its ``tests/test_scheduler.py``
    case): 5 requests, every second one with zero embeddings, which LLaDA
    has no layer to read, through batches of 4.  Nothing is refused at
    submit; the first batch takes requests 0, 2 and 4, the second 1 and 3,
    and every request's tokens equal the reference server's."""
    jm, params, tm = models("llada-8b")
    jgen, tgen = gen_configs(mode="es", skip_stages=((1, 0.5),))
    outs = []
    for server, make_req in ((JBatchServer(jm, params, jgen, batch_size=BATCH, prompt_len=PL,
                                           seed=5), JRequest),
                             (BatchServer(tm, tgen, batch_size=BATCH, prompt_len=PL, seed=5,
                                          device="cpu"), Request)):
        rng = np.random.default_rng(2)
        reqs = [make_req(prompt=rng.integers(3, tm.cfg.vocab_size, 8).astype(np.int32),
                         enc_embeds=np.zeros((4, tm.cfg.d_model), np.float32) if i % 2 else None)
                for i in range(5)]
        for r in reqs:
            server.submit(r)
        first = server.step()
        assert [r.request_id for r in first] == [reqs[i].request_id for i in (0, 2, 4)]
        assert [r.request_id for r in server.drain()] == [reqs[i].request_id for i in (1, 3)]
        assert all(r.output is not None and (r.output < tm.cfg.vocab_size).all() for r in reqs)
        outs.append([r.output for r in reqs])
    for i, (x, y) in enumerate(zip(*outs)):
        np.testing.assert_array_equal(y, np.asarray(x), err_msg=f"request {i}")


def test_launcher_batch_runtime(capsys):
    done = serve.main(["--device", "cpu", "--runtime", "batch", "--requests", "6",
                       "--batch", "4", "--prompt-len", "16", "--gen-length", "16",
                       "--block-length", "8"])
    assert len(done) == 6 and all(r.output.shape == (16,) for r in done)
    out = capsys.readouterr().out
    assert "runtime=batch" in out and "TPS=" in out and "batches=2" in out
