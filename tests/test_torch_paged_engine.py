"""The port's offline paged KV and adaptive feature cache against the JAX
reference's, on the CPU.

Reduced LLaDA-8B and Dream-7B (4 layers, weight matrices x10 for
non-degenerate tokens, as in ``test_torch_engine``).  The reference runs its
Pallas kernels in interpret mode.  Greedy tokens must be identical to the
reference's, and the port's dense and paged runs identical to each other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_engine as jmake
from repro_torch.core import make_engine as tmake
from test_torch_engine import ARCHS, PROMPT_LEN, gen_configs, models, prompt_for

STAGES = ((1, 0.5), (2, 0.5))
# prompt refresh every 4 iterations of an 8-step block: phase 0 is a full
# refresh, phase 4 a partial one (every 2nd scheduled refresh is full)
CACHED = dict(cache_prompt_interval=2, prompt_refresh_period=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The reduced models' ops are tiny: one intra-op thread runs them as
    fast as eight alone, and keeps them fast when several test workers
    share the CPU (each op's parallel region would wait on busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _generate(arch, gen_kw, engine_kw):
    jm, params, tm = models(arch)
    jgen, tgen = gen_configs(mode="es", skip_stages=STAGES, **gen_kw)
    prompt = prompt_for(tm.cfg)
    want = np.asarray(jmake(jm, jgen, attn_impl="pallas", importance_impl="pallas",
                            **engine_kw)
                      .generate(params, jnp.asarray(prompt), jax.random.PRNGKey(0)))
    assert len(np.unique(want[:, PROMPT_LEN:])) >= 10, "degenerate reference output"
    runs = {}
    for paged in (False, True):
        eng = tmake(tm, tgen, device="cpu", **(engine_kw if paged else {}))
        runs[paged] = (eng.generate(torch.from_numpy(prompt)).numpy(), eng)
    return want, runs


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("page_size", [8, 16])
def test_paged_generate_matches_reference_and_dense(arch, page_size):
    want, runs = _generate(arch, {}, dict(paged=True, page_size=page_size))
    np.testing.assert_array_equal(runs[True][0], want)
    np.testing.assert_array_equal(runs[False][0], want)


@pytest.mark.parametrize("arch", ARCHS)
def test_adaptive_cache_generate_matches_reference(arch):
    want, runs = _generate(arch, CACHED, dict(paged=True, page_size=8))
    for paged, (got, eng) in runs.items():
        np.testing.assert_array_equal(got, want, err_msg=f"paged={paged}")
        assert eng.pass_counts["partial"] > 0 and eng.pass_counts["prefill"] > 0
    # the cache changes the decode: the same config without it differs
    plain, _ = _generate(arch, {"prompt_refresh_period": 4}, {})
    assert not np.array_equal(plain, want)


def test_identity_block_tables_and_pool_sizing():
    _, _, tm = models("llada-8b")
    _, tgen = gen_configs(mode="es", skip_stages=STAGES)
    eng = tmake(tm, tgen, device="cpu", paged=True, page_size=8)
    bt = eng._identity_block_tables(2, 32)
    assert bt.tolist() == [[1, 2, 3, 4], [5, 6, 7, 8]]
    cache = eng.make_block_state(torch.zeros(2, 32, dtype=torch.int32)).cache
    assert cache.k.shape == (4, 9, 8, tm.cfg.n_kv_heads, tm.cfg.head_dim)
    small = tmake(tm, tgen, device="cpu", paged=True, page_size=8, kv_pages=8)
    with pytest.raises(ValueError, match="kv_pages"):
        small.generate(torch.zeros(2, 16, dtype=torch.int32))
