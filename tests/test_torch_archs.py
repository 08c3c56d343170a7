"""The MoE and remaining dense decoder archs of the port against the JAX
reference, on the CPU: OLMoE-1B-7B and Granite-MoE-1B-A400M (MoE FFN),
Gemma-3-1B (GeGLU, local:global windows), Llama-3-8B, Qwen2-1.5B (qkv bias)
and ChatGLM3-6B (qkv bias, rotary on half the head dims).

Each at its reduced size with 4 layers; the MoE archs at capacity factor
0.5, so picks drop at capacity; Gemma-3 with the reduced window 16 and
``global_every`` 2 (layers 1 and 3 global) and a prompt long enough that
the local layers mask keys.  The same numpy tree goes to both packages:

* ``nocache`` logits within 1e-4 at the init scale;
* offline es greedy tokens equal at x10 weights (as ``test_torch_engine``);
  the reference runs its Pallas kernels in interpret mode, and Gemma-3 its
  XLA lowering, since the reference's Pallas path asserts on the traced
  per-layer window (ROADMAP.md Queue C);
* one paged served trace (3 requests, the adaptive cache) with tokens
  equal, for Gemma-3 and OLMoE;
* the per-layer windows equal the reference's ``window_meta`` (0 for its
  ``BIG_WINDOW``);
* ``check_supported`` accepts the vision model and SeamlessM4T
  (cross-attention), built from copies of the reference's configs, and
  both are registered in the port.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import make_engine as jmake
from repro.models import build_model as jbuild
from repro.models.common import BIG_WINDOW
from repro.runtime import Request as JRequest
from repro.runtime import StreamScheduler as JScheduler
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import make_engine as tmake
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.models.model import ForwardCtx, check_supported, layer_window
from repro_torch.runtime import Request, StreamScheduler

ARCHS = ["olmoe-1b-7b", "granite-moe-1b-a400m", "gemma3-1b", "llama3-8b", "qwen2-1.5b",
         "chatglm3-6b"]
PL, PS = 32, 8
BASE = dict(gen_length=16, block_length=8)
ES = dict(mode="es", skip_stages=((1, 0.5), (2, 0.5)))
SERVE = dict(ES, cache_prompt_interval=2, prompt_refresh_period=4, block_refresh_period=3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the reduced models' ops are tiny, and several
    test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reduced_cfg(c, arch):
    """``c`` is either package's ``configs``: the reduced config at 4 layers,
    MoE at capacity factor 0.5."""
    cfg = dataclasses.replace(c.reduced(c.get_config(arch)), n_layers=4)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    return cfg


@functools.lru_cache(maxsize=None)
def models(arch, scale=10.0):
    """(reference model, reference params, port model), weight matrices x ``scale``."""
    jcfg, tcfg = reduced_cfg(jconfigs, arch), reduced_cfg(tconfigs, arch)
    jm = jbuild(jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a) * (scale if a.ndim >= 2 else 1.0),
                                  jm.init(jax.random.PRNGKey(0)))
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(params_from_numpy(tree, tcfg, "cpu"))
    return jm, jax.tree_util.tree_map(jnp.asarray, tree), tm


def gen_configs(**kw):
    stages = kw.pop("skip_stages", ())
    return tuple(c.GenerationConfig(skip_stages=tuple(c.SkipStage(*s) for s in stages),
                                    **BASE, **kw) for c in (jconfigs, tconfigs))


def prompts(cfg, seed=1):
    return np.random.default_rng(seed).integers(3, cfg.vocab_size, (2, PL)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_nocache_logits_match_reference(arch):
    jm, params, tm = models(arch, scale=1.0)
    toks = prompts(tm.cfg, seed=2)
    want, _ = jm.forward(params, jnp.asarray(toks))
    pos = torch.arange(PL, dtype=torch.int32)[None].expand(2, PL).contiguous()
    got = tm.logits(tm.run_layers(tm.embed_tokens(torch.from_numpy(toks)),
                                  ForwardCtx(positions=pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_es_tokens_match_reference(arch):
    jm, params, tm = models(arch)
    jgen, tgen = gen_configs(**ES)
    impl = "xla" if tm.cfg.sliding_window else "pallas"
    prompt = prompts(tm.cfg)
    want = np.asarray(jmake(jm, jgen, attn_impl=impl, importance_impl=impl)
                      .generate(params, jnp.asarray(prompt), jax.random.PRNGKey(0)))
    assert len(np.unique(want[:, PL:])) >= 8, "degenerate reference output"
    got = tmake(tm, tgen, device="cpu").generate(torch.from_numpy(prompt))
    np.testing.assert_array_equal(got.numpy(), want)


# (step at which it arrives, prompt length, max_new_tokens)
TRACE = [(0, 32, None), (0, 20, 8), (3, 27, None)]


def _serve(sched, make_req, vocab):
    rng = np.random.default_rng(11)
    reqs = [make_req(prompt=rng.integers(3, vocab, n).astype(np.int32), max_new_tokens=m)
            for _, n, m in TRACE]
    step = 0
    while step <= TRACE[-1][0] or sched.has_work():
        for (at, _, _), r in zip(TRACE, reqs):
            if at == step:
                sched.submit(r)
        sched.step()
        step += 1
    return reqs, sched


@pytest.mark.parametrize("arch", ["gemma3-1b", "olmoe-1b-7b"])
def test_paged_serving_matches_reference(arch):
    """Three requests on two paged slots with early advance and the adaptive
    cache (full and partial refreshes): the third waits for a slot."""
    jm, params, tm = models(arch)
    jgen, tgen = gen_configs(**SERVE)
    kw = dict(max_slots=2, prompt_len=PL, paged=True, page_size=PS, early_advance=True)
    jreqs, _ = _serve(JScheduler(jm, params, jgen, attn_impl="xla", **kw), JRequest,
                      tm.cfg.vocab_size)
    reqs, sched = _serve(StreamScheduler(tm, tgen, device="cpu", **kw), Request,
                         tm.cfg.vocab_size)
    for r, jr in zip(reqs, jreqs):
        assert r.error is None and r.output is not None
        np.testing.assert_array_equal(r.output, jr.output)
    assert len(np.unique(np.concatenate([r.output for r in reqs]))) >= 8
    assert sched.engine.pass_counts["partial"] > 0
    assert sched.allocator.free_pages == sched.allocator.num_pages - 1


@pytest.mark.parametrize("arch", ["gemma3-1b", "llama3-8b"])
@pytest.mark.parametrize("override", [0, 8, 40])
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_layer_windows_match_reference(arch, override, reduced):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    if reduced:
        jcfg, tcfg = reduced_cfg(jconfigs, arch), reduced_cfg(tconfigs, arch)
    want = np.asarray(jbuild(jcfg).window_meta(override))
    want = np.where(want == BIG_WINDOW, 0, want)
    if not (jcfg.sliding_window or override):
        want[:] = 0         # the reference compiles its windows out
    got = [layer_window(tcfg, layer, override) for layer in range(tcfg.n_layers)]
    np.testing.assert_array_equal(got, want)
    if arch == "gemma3-1b" and not override and not reduced:
        assert got == [0 if layer % 6 == 5 else 512 for layer in range(26)]


def _port_copy(jcfg):
    """A port ModelConfig with the reference config's fields."""
    fields = dataclasses.asdict(jcfg)
    if fields["moe"] is not None:
        fields["moe"] = tconfigs.MoEConfig(**fields["moe"])
    if fields["ssm"] is not None:
        fields["ssm"] = tconfigs.SSMConfig(**fields["ssm"])
    return tconfigs.ModelConfig(**fields)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "seamless-m4t-large-v2"])
def test_families_outside_the_port_are_refused(arch):
    """No family is left outside the port: ``check_supported`` accepts
    copies of the reference's vision and SeamlessM4T configs, full and
    reduced, both are registered in the port as the reference has them, and
    the reduced ones build (their parity: ``test_torch_cross.py``)."""
    for cfg in (jconfigs.get_config(arch), jconfigs.reduced(jconfigs.get_config(arch))):
        check_supported(_port_copy(cfg))
    assert dataclasses.asdict(tconfigs.get_config(arch)) == dataclasses.asdict(
        jconfigs.get_config(arch))
    model = Model(tconfigs.reduced(tconfigs.get_config(arch)), device="cpu")
    assert model.cross_layers and len(model.cross_layers) == len(model.cross_plane)


def test_serve_launcher_with_an_moe_arch(capsys):
    done = serve.main(["--device", "cpu", "--arch", "olmoe-1b-7b", "--requests", "3",
                       "--batch", "2", "--gen-length", "16", "--block-length", "8",
                       "--prompt-len", "16", "--paged", "--page-size", "8",
                       "--early-advance", "--cache-prompt-interval", "2",
                       "--prompt-refresh-period", "4"])
    assert len(done) == 3 and all(r.error is None and r.output.shape == (16,) for r in done)
    assert "served 3 requests" in capsys.readouterr().out
