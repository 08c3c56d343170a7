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
