"""The port's sampling key chain and sampled decoding against JAX's, on the CPU.

``repro_torch.core.prng`` recomputes ``jax.random``'s threefry bits (with
``jax_threefry_partitionable`` on, the installed JAX's default) in PyTorch:
keys, ``fold_in``, ``bits`` and ``uniform`` must be bit-exact; Gumbel noise
goes through two ``log`` calls: the port's is the correctly rounded value
of JAX's uniform (float64 logs, one rounding), JAX's comes from float32
logs, and the two are held to 2 ulp at the scale ``max(|g|, 1)``.  On top of
it the sampled confidence (temperature, top-k, top-p) and whole sampled
``generate`` runs must give JAX's tokens, on reduced LLaDA and Dream.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_engine as jmake
from repro.core import sampler as jsampler
from repro_torch.core import make_engine as tmake
from repro_torch.core import prng
from repro_torch.core import sampler as tsampler
from test_torch_engine import MODES, PROMPT_LEN, gen_configs, models, prompt_for

SEEDS = [0, 1, 12345, 2**31 - 1]
SHAPES = [(3,), (5, 7), (2, 3, 511)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The reduced models' ops are tiny: one intra-op thread runs them as
    fast as eight alone, and keeps them fast when several test workers
    share the CPU (each op's parallel region would wait on busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tkey(jkey) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def _chain(seed, data):
    return (jax.random.fold_in(jax.random.PRNGKey(seed), data),
            prng.fold_in(prng.prng_key(seed), data))


def test_threefry_known_answer():
    """Random123's test vector, which JAX's threefry gives too."""
    words = [torch.tensor(w) for w in (0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3)]
    assert tuple(int(x) for x in prng.threefry2x32(*words)) == (0xC4923A9C, 0x483DF7A0)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 17, 2**31 + 5])
def test_prng_key_and_fold_in_match_jax(seed, data):
    assert prng.prng_key(seed).tolist() == np.asarray(jax.random.PRNGKey(seed)).tolist()
    jkey, tkey = _chain(seed, data)
    assert tkey.tolist() == np.asarray(jkey).tolist()
    # the engine's per-row chain, batched over rows
    seeds, iters = np.array([3, 0, 7], np.int32), np.array([0, 9, 40], np.int32)
    want = [np.asarray(jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), s), i))
            for s, i in zip(seeds, iters)]
    got = prng.row_keys(prng.prng_key(seed), torch.from_numpy(seeds), torch.from_numpy(iters))
    assert got.tolist() == np.stack(want).tolist()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_random_bits_and_uniform_match_jax(seed, shape):
    jkey, tkey = _chain(seed, 17)
    np.testing.assert_array_equal(prng.random_bits(tkey, shape).numpy(),
                                  np.asarray(jax.random.bits(jkey, shape)).astype(np.int64))
    np.testing.assert_array_equal(prng.uniform(tkey, shape).numpy(),
                                  np.asarray(jax.random.uniform(jkey, shape)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("iteration", [0, 5, 123])
def test_gumbel_within_two_ulp(seed, iteration):
    """Units are ulps at the scale ``max(|g|, 1)``.  The error of
    ``-log(-log(u))`` composes: with ``y = -log(u)`` computed to a relative
    error ``d1`` and the outer log to ``d2`` of its result, ``g`` moves by
    ``d1 + |g| d2`` to first order; for float32 logs within one ulp that is
    at most ``2**-23 (1 + |g|)``, up to 4 units, since an ulp at
    ``max(|g|, 1)`` is at least ``2**-24 max(|g|, 1)``.  The port computes
    both logs in float64 and rounds once, so it must lie within half a unit
    of the exact Gumbel of JAX's (bit-exact) uniform; JAX's float32 logs
    lie within 1.35 units of it at these seeds, so the two stay within 2.
    Each assertion's message gives both sides' distance from the exact
    value, so a failure says whether the port's or JAX's logs drifted."""
    jkey = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), 3), iteration)
    want = np.asarray(jax.random.gumbel(jkey, (8, 512)))
    u = np.asarray(jax.random.uniform(jkey, (8, 512), minval=np.finfo(np.float32).tiny,
                                      maxval=1.0)).astype(np.float64)
    exact = -np.log(-np.log(u))
    got = prng.gumbel(_tkey(jkey), (8, 512)).numpy()
    scale = np.spacing(np.maximum(np.abs(exact), 1.0).astype(np.float32)).astype(np.float64)
    sides = (f"port {(np.abs(got - exact) / scale).max()} units from exact, "
             f"JAX {(np.abs(want - exact) / scale).max()}")
    assert (np.abs(got - exact) / scale).max() <= 0.5 + 1e-6, sides
    ulps = np.abs(got - want) / np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert ulps.max() <= 2.0, f"{ulps.max()} units apart; {sides}"


def test_categorical_matches_jax_per_row_keys():
    rng = np.random.default_rng(0)
    keys = jnp.stack([jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), s), 3)
                      for s in range(4)])
    logits = (rng.standard_normal((4, 8, 512)) * 3).astype(np.float32)
    want = jax.vmap(lambda k, lg: jax.random.categorical(k, lg, axis=-1))(
        keys, jnp.asarray(logits))
    got = prng.categorical(_tkey(keys), torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


SAMPLING = [dict(temperature=0.8), dict(temperature=0.5, top_k=20),
            dict(temperature=0.7, top_p=0.9), dict(temperature=1.3, top_k=50, top_p=0.8)]


@pytest.mark.parametrize("sampling", SAMPLING, ids=lambda s: "-".join(f"{k}{v}" for k, v in
                                                                      s.items()))
def test_sampled_confidence_matches_jax(sampling):
    """Tokens equal, confidences within 1e-6 (both softmax the same f32
    logits, summing in other orders)."""
    jgen, tgen = gen_configs(**sampling)
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 8, 512)) * 4).astype(np.float32)
    keys = jnp.stack([jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(2), s), 11)
                      for s in (5, 6, 7)])
    jconf, jpred = jsampler.confidence_and_pred(keys, jnp.asarray(logits), jgen, 503, 503)
    tconf, tpred = tsampler.confidence_and_pred(_tkey(keys), torch.from_numpy(logits), tgen,
                                                503, 503)
    np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))
    np.testing.assert_allclose(tconf.numpy(), np.asarray(jconf), atol=1e-6, rtol=0)
    assert (tpred < 503).all()


@pytest.mark.parametrize("arch", ["llada-8b", "dream-7b"])
@pytest.mark.parametrize("mode", ["dualcache", "es"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_sampled_generate_matches_jax(arch, mode, paged):
    """Dream decodes with top-p, LLaDA with plain temperature; the base key
    and per-row seeds are the caller's."""
    sampling = dict(temperature=0.7, top_p=0.9) if arch == "dream-7b" else dict(temperature=0.8)
    jm, params, tm = models(arch)
    jgen, tgen = gen_configs(**MODES[mode], **sampling)
    prompt = prompt_for(tm.cfg)
    kw = dict(paged=True, page_size=8) if paged else {}
    want = np.asarray(jmake(jm, jgen, attn_impl="xla", **kw).generate(
        params, jnp.asarray(prompt), jax.random.PRNGKey(3), sample_seeds=jnp.asarray([5, 9])))
    assert len(np.unique(want[:, PROMPT_LEN:])) >= 10, "degenerate reference output"
    got = tmake(tm, tgen, device="cpu", **kw).generate(
        torch.from_numpy(prompt), key=prng.prng_key(3), sample_seeds=torch.tensor([5, 9]))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_default_seeds_are_the_row_index():
    """Two equal prompts sample different completions under the default
    seeds, and the same ones as with explicit seeds 0 and 1."""
    _, _, tm = models("llada-8b")
    _, tgen = gen_configs(**MODES["es"], temperature=0.8)
    prompt = np.repeat(prompt_for(tm.cfg)[:1], 2, axis=0)
    eng = tmake(tm, tgen, device="cpu")
    default = eng.generate(torch.from_numpy(prompt))
    assert not torch.equal(default[0], default[1])
    explicit = eng.generate(torch.from_numpy(prompt), sample_seeds=torch.tensor([0, 1]))
    assert torch.equal(default, explicit)
