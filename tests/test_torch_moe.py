"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX reference's
``repro.models.moe``, on the CPU.

``routing`` against ``_routing`` on the same seeded probabilities: the dense
dispatch built from the port's picks equals the reference's, and the
combine weights agree within 1e-6, where picks really drop
(``capacity_factor`` 0.25 and 0.5), on a padded last group, on uniform rows
(ties), and where the remaining probabilities underflow to 0 (the
reference picks expert 0 again).  ``moe_apply`` against the reference's at
f32 within 1e-5, reduced OLMoE and Granite-MoE with converted weights.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.models import moe as tmoe

ARCHS = ["olmoe-1b-7b", "granite-moe-1b-a400m"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the reduced ops are tiny, and several test
    workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def moe_cfg(arch, capacity_factor):
    """The reduced config of both packages with ``capacity_factor``."""
    out = []
    for c in (jconfigs, tconfigs):
        cfg = dataclasses.replace(c.reduced(c.get_config(arch)), n_layers=4)
        out.append(dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor)))
    return out


def dense(r: tmoe.Routing, n_experts: int, cap: int):
    """The port's picks as the reference's ``[G, S, E, C]`` dispatch and combine."""
    g, s, k = r.expert.shape
    dispatch = np.zeros((g, s, n_experts, cap), bool)
    combine = np.zeros((g, s, n_experts, cap), np.float32)
    for gi, si, ki in zip(*np.nonzero(r.kept.numpy())):
        e, c = int(r.expert[gi, si, ki]), int(r.slot[gi, si, ki])
        assert not dispatch[gi, si, e, c], "two picks in one slot"
        dispatch[gi, si, e, c] = True
        combine[gi, si, e, c] = float(r.weight[gi, si, ki])
    return dispatch, combine


def probs_case(name, rng, g, s, e):
    if name == "random":
        logits = rng.standard_normal((g, s, e)).astype(np.float32) * 2.0
    elif name == "uniform":          # every row ties on every expert (zero pad rows)
        logits = np.zeros((g, s, e), np.float32)
    elif name == "mixed_ties":       # a few rows tie, the others do not
        logits = rng.standard_normal((g, s, e)).astype(np.float32)
        logits[:, ::3] = 0.0
    else:                            # "underflow": one expert takes all the mass
        logits = rng.standard_normal((g, s, e)).astype(np.float32)
        logits[:, :, 3] = 200.0
    return np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))


@pytest.mark.parametrize("capacity_factor", [0.25, 0.5, 2.0])
@pytest.mark.parametrize("case", ["random", "uniform", "mixed_ties", "underflow"])
def test_routing_matches_reference(case, capacity_factor):
    jcfg, tcfg = moe_cfg("olmoe-1b-7b", capacity_factor)
    m_j = dataclasses.replace(jcfg.moe, n_experts=8, experts_per_token=3)
    m_t = dataclasses.replace(tcfg.moe, n_experts=8, experts_per_token=3)
    probs = probs_case(case, np.random.default_rng(7), 3, 24, 8)
    if case == "underflow":
        assert (probs == 0).sum(-1).min() >= 7, "the case must underflow"
    cap = tmoe.capacity(m_t, 24)
    assert cap == max(int(24 * 3 / 8 * capacity_factor), 1)
    want_d, want_c, _ = jmoe._routing(jnp.asarray(probs), m_j, cap)
    r = tmoe.routing(torch.from_numpy(probs), m_t, cap)
    got_d, got_c = dense(r, 8, cap)
    np.testing.assert_array_equal(got_d, np.asarray(want_d))
    np.testing.assert_allclose(got_c, np.asarray(want_c), atol=1e-6, rtol=0)
    if capacity_factor < 1:
        assert not r.kept.all(), "no pick dropped"
    if case == "underflow":      # expert 0 is picked again with probability 0
        assert ((r.expert == 0).sum(-1) >= 2).any()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("rows", [(2, 40), (1, 64), (3, 7)], ids=["padded", "one_group", "small"])
def test_moe_apply_matches_reference(arch, rows):
    """(2, 40): 80 rows in groups of 64, the second zero-padded; (1, 64):
    one whole group; (3, 7): one group of 21 rows.  Capacity factor 0.5, so
    picks drop in every group."""
    jcfg, tcfg = moe_cfg(arch, 0.5)
    params = jax.tree_util.tree_map(
        np.asarray, jmoe.moe_init(jax.random.PRNGKey(3), jcfg, dtype=jnp.float32))
    moe = tmoe.MoE(tcfg, "cpu", torch.float32)
    moe.load_state_dict({n: torch.from_numpy(a * (1.0 if n == "router" else 10.0))
                         for n, a in params.items()})
    params["w_gate"], params["w_up"], params["w_down"] = (
        params[n] * 10.0 for n in ("w_gate", "w_up", "w_down"))
    x = np.random.default_rng(5).standard_normal((*rows, tcfg.d_model)).astype(np.float32)
    want, _ = jmoe.moe_apply({n: jnp.asarray(a) for n, a in params.items()}, jcfg,
                             jnp.asarray(x))
    got = tmoe.moe_apply(moe, tcfg, torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert np.abs(np.asarray(want)).max() > 1e-2, "degenerate output"


def test_moe_apply_drops_change_the_output():
    """The drops are real: capacity factor 0.5 and 2.0 give different outputs
    on the same rows and weights."""
    out = []
    for cf in (0.5, 2.0):
        _, tcfg = moe_cfg("olmoe-1b-7b", cf)
        moe = tmoe.MoE(tcfg, "cpu", torch.float32)
        gen = torch.Generator().manual_seed(0)
        for p in moe.parameters():
            p.normal_(0.0, 0.5, generator=gen)
        x = torch.randn((2, 40, tcfg.d_model), generator=gen)
        out.append(tmoe.moe_apply(moe, tcfg, x))
    assert (out[0] - out[1]).abs().max() > 1e-3


@pytest.mark.parametrize("rows", [(2, 40), (3, 7)], ids=["padded", "small"])
@pytest.mark.parametrize("capacity_factor", [0.5, 2.0])
def test_aux_loss_matches_reference(rows, capacity_factor):
    """``moe_apply(..., with_aux=True)``'s load-balance loss against the
    reference's, with drops (0.5) and without (2.0), on a zero-padded last
    group (whose pad rows count in ``mean_prob``) and on one small group;
    the output is the one without ``with_aux``."""
    jcfg, tcfg = moe_cfg("olmoe-1b-7b", capacity_factor)
    params = jax.tree_util.tree_map(
        np.asarray, jmoe.moe_init(jax.random.PRNGKey(4), jcfg, dtype=jnp.float32))
    params["router"] = params["router"] * 20.0          # routing far from uniform
    moe = tmoe.MoE(tcfg, "cpu", torch.float32)
    moe.load_state_dict({n: torch.tensor(a) for n, a in params.items()})
    x = np.random.default_rng(6).standard_normal((*rows, tcfg.d_model)).astype(np.float32)
    _, want = jmoe.moe_apply({n: jnp.asarray(a) for n, a in params.items()}, jcfg,
                             jnp.asarray(x))
    out, aux = tmoe.moe_apply(moe, tcfg, torch.from_numpy(x), with_aux=True)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    np.testing.assert_allclose(float(aux), float(want), rtol=1e-6)
    assert float(aux) != pytest.approx(tcfg.moe.aux_loss_coef, rel=1e-3), "uniform routing"
    assert torch.equal(out, tmoe.moe_apply(moe, tcfg, torch.from_numpy(x)))


def _poison_reference(sched, slot, ps):
    """NaN into the reference scheduler's slot's private current-block page
    (its cache is functional: the state is replaced)."""
    st = sched.state
    page = int(np.asarray(st.block_tables)[slot, int(np.asarray(st.bs)[slot]) // ps])
    assert page > 0 and sched.allocator.refcount(page) == 1
    caches = dict(st.caches)
    caches["kv"] = jax.tree_util.tree_map(
        lambda a: a.at[:, page].set(jnp.nan) if jnp.issubdtype(a.dtype, jnp.floating) else a,
        caches["kv"])
    sched.state = st._replace(caches=caches)


def test_quarantine_on_moe_retires_the_group_in_the_reference_only():
    """A reference-side fault the port does not mirror (ROADMAP.md): three
    requests share a paged pass of reduced OLMoE (every row in one routing
    group), and slot 0's page goes NaN.  The reference dispatches with a
    dense einsum, so ``0 * NaN`` spreads the row over every expert slot of
    the group and back to every row of it: it retires all three requests.
    The port dispatches by index, so the NaN stays in its row: it retires
    the victim alone, and the two bystanders decode exactly what they decode
    in the same trace unpoisoned (capacity factor 2.0: no pick drops, so the
    rows of a pass do not couple)."""
    from repro import configs as jconfigs
    from repro.models import build_model as jbuild
    from repro.runtime import PoisonedRequest as JPoisoned
    from repro.runtime import Request as JRequest
    from repro.runtime import StreamScheduler as JScheduler
    from repro_torch import configs as tconfigs
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import Model
    from repro_torch.runtime import PoisonedRequest, Request, StreamScheduler
    from test_torch_fault_tolerance import PL, PS, _poison_until_caught

    jcfg, tcfg = moe_cfg("olmoe-1b-7b", 2.0)
    jm = jbuild(jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a) * (10.0 if a.ndim >= 2 else 1.0),
                                  jm.init(jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(params_from_numpy(tree, tcfg, "cpu"))
    gen = dict(mode="es", gen_length=16, block_length=8, prompt_refresh_period=8,
               block_refresh_period=4)
    jgen = jconfigs.GenerationConfig(skip_stages=(jconfigs.SkipStage(1, 0.5),), **gen)
    tgen = tconfigs.GenerationConfig(skip_stages=(tconfigs.SkipStage(1, 0.5),), **gen)
    kw = dict(max_slots=3, prompt_len=PL, paged=True, page_size=PS)
    prompts = [np.random.default_rng(s).integers(3, tcfg.vocab_size, PL).astype(np.int32)
               for s in range(3)]

    def serve(sched, make, poison):
        reqs = [make(prompt=p.copy()) for p in prompts]
        for r in reqs:
            sched.submit(r)
        sched.step()
        if poison:
            poison(sched)
        sched.drain()
        return reqs

    def poison_reference(sched):
        for _ in range(60):
            if sched.stats.poisoned_requests:
                return
            _poison_reference(sched, 0, PS)
            sched.step()
        raise AssertionError("the reference's detector never fired")

    jreqs = serve(JScheduler(jm, params, jgen, attn_impl="xla", **kw), JRequest,
                  poison_reference)
    assert all(isinstance(r.error, JPoisoned) and r.output is None for r in jreqs)
    clean = serve(StreamScheduler(tm, tgen, device="cpu", **kw), Request, None)
    reqs = serve(StreamScheduler(tm, tgen, device="cpu", **kw), Request, _poison_until_caught)
    assert isinstance(reqs[0].error, PoisonedRequest) and reqs[0].output is None
    for r, c in zip(reqs[1:], clean[1:]):
        assert r.error is None and c.error is None
        np.testing.assert_array_equal(r.output, c.output)
    assert len(np.unique(np.concatenate([c.output for c in clean]))) >= 8
