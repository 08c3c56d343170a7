"""The port's tensor parallelism on the SSM, hybrid, cross-attention and
encoder stacks, on the CPU, against the JAX reference.

Meshes ``(data=1, model=N)`` over N gloo ranks, one process each, spawned
once per world size for the whole module (``repro_torch.launch.tp.spawn``),
as in ``test_torch_tp``.  Reduced archs in f32, the reference's random-init
parameters with every weight matrix x10, converted to each rank's shard:

* mamba2-370m at 4 layers (32 SSM heads of 16: 16 or 8 a rank);
* jamba-v0.1-52b at 16 layers, two periods of 8 (4 query heads on 1 KV
  head: ``Grouped``; 32 SSM heads; 4 experts, capacity factor 0.5, so picks
  drop);
* llama-3.2-vision-11b at 10 layers (cross layers 3 and 8, ``enc_proj``
  whole on every rank);
* seamless-m4t-large-v2 at 2 decoder and 2 encoder layers (4 heads on 4
  KV heads, the encoder's cut like the decoder's).

Every reduced width divides 4, so all four run at TP 2 and at TP 4:

* ES greedy tokens equal the reference's on every rank, and each rank's
  logits of a cacheless forward over the output lie within 1e-2 of the
  reference's (the ``test_torch_tp`` tolerance: x10 weights grow the hidden
  states past 1e3, and the row-parallel sums and the gated norm's sum of
  squares add in another order than one reduction does);
* the collectives of a ``generate`` by site: ``ssm`` and ``ssm_norm`` once
  a mixer layer and pass, ``cross`` once a cross layer and pass, the
  encoder's ``attn`` and ``mlp`` once a layer and encode;
* after a Jamba prefill each rank's planes are its shard of TP 1's: the SSD
  state by SSM heads, the conv tail its x channels then every B/C channel
  (``ssm_conv_tail``), ``ssmh`` whole, the K/V planes its KV head;
* a sampled Jamba paged ``StreamScheduler`` trace with prefix sharing at
  TP 2 forks pages and equals the reference scheduler's tokens;
* a mesh of size 1 is bit-equal to no mesh on the SSM and encoder stacks.
"""
import concurrent.futures
import dataclasses
import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import tp
from test_torch_tp import generate_job, run_jobs

# the ranks import this module to find their jobs: JAX and the reference's
# test helpers are imported where the parent process needs them, not here
MAMBA, JAMBA, VLM, AUDIO = ("mamba2-370m", "jamba-v0.1-52b", "llama-3.2-vision-11b",
                            "seamless-m4t-large-v2")
ARCHS = [MAMBA, JAMBA, VLM, AUDIO]
WORLDS = (2, 4)
PL = 16
BASE = dict(gen_length=16, block_length=8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the reduced models' ops are tiny, and several
    test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reduced_cfg(c, arch):
    """``c`` is either package's ``configs``: mamba2 at 4 layers, Jamba's
    MoE at capacity factor 0.5."""
    cfg = c.reduced(c.get_config(arch))
    if arch == MAMBA:
        return dataclasses.replace(cfg, n_layers=4)
    if arch == JAMBA:
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    return cfg


@functools.lru_cache(maxsize=None)
def case(arch):
    """(reference model, port config, numpy tree x10, reference gen, port
    gen, prompt, enc_embeds or None)."""
    import jax

    from repro import configs as jconfigs
    from repro.models import build_model as jbuild
    from repro_torch import configs as tconfigs

    jcfg, tcfg = reduced_cfg(jconfigs, arch), reduced_cfg(tconfigs, arch)
    jm = jbuild(jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a) * (10.0 if a.ndim >= 2 else 1.0),
                                  jm.init(jax.random.PRNGKey(0)))
    stages = [(s.layer, s.ratio) for s in tconfigs.default_skip_stages(tcfg.n_layers)]
    jgen, tgen = (c.GenerationConfig(mode="es", skip_stages=tuple(c.SkipStage(*s)
                                                                  for s in stages), **BASE)
                  for c in (jconfigs, tconfigs))
    rng = np.random.default_rng(1)
    prompt = rng.integers(3, tcfg.vocab_size, (2, PL)).astype(np.int32)
    enc = None
    if tcfg.family in ("audio", "vlm"):
        enc = rng.normal(size=(2, tcfg.n_enc_tokens, tcfg.d_enc)).astype(np.float32)
    return jm, tcfg, tree, jgen, tgen, prompt, enc


def planes_job(mesh, cfg, gen, tree, prompt: np.ndarray) -> tuple:
    """The rank's Jamba caches after one prefill of ``prompt`` at block
    start ``PL``: (SSD states, conv tails, ssmh, K planes)."""
    from repro_torch.core import make_engine

    model = tp.build_model(cfg, mesh, "cpu", tree=tree)
    engine = make_engine(model, gen, device="cpu")
    tokens = np.full((prompt.shape[0], PL + BASE["gen_length"]), cfg.vocab_size, np.int32)
    tokens[:, :PL] = prompt
    st = engine.prefill(engine.make_block_state(torch.from_numpy(tokens)), PL)
    ssm = st.cache.ssm
    return ssm.state.numpy(), ssm.conv_tail.numpy(), ssm.ssmh.numpy(), st.cache.kv.k.numpy()


def shared_serve_job(mesh, cfg, gen, prompts, seeds, sched_kw: dict, *, tree) -> dict:
    """A paged ``StreamScheduler`` trace with every request submitted at
    step 0: each request's tokens and the scheduler's fork count."""
    from repro_torch.runtime import Request, StreamScheduler

    sched = StreamScheduler(tp.build_model(cfg, mesh, "cpu", tree=tree), gen, device="cpu",
                            **sched_kw)
    reqs = [Request(prompt=np.asarray(p).copy(), sample_seed=s) for p, s in zip(prompts, seeds)]
    for r in reqs:
        sched.submit(r)
    while sched.has_work():
        sched.step()
    return dict(outputs=[r.output for r in reqs], cow_forks=sched.stats.cow_forks)


def _shared_trace():
    """test_torch_hybrid_serving's sampled sharing trace: two cohorts of two
    duplicates (a 16- and a 12-token prompt), seeds 100-103."""
    from test_torch_hybrid_serving import SERVE, gen_configs, models

    rng = np.random.default_rng(2)
    vocab = models()[2].cfg.vocab_size
    a, b = (rng.integers(3, vocab, n).astype(np.int32) for n in (16, 12))
    _, tgen = gen_configs(**SERVE, temperature=0.8)
    return [a, a, b, b], [100, 101, 102, 103], tgen


def _shared_kw():
    from test_torch_hybrid_serving import PAGED, PL as SPL, SLOTS

    return dict(max_slots=SLOTS, prompt_len=SPL, prefix_sharing=True, **PAGED)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Starts the ranks in a thread of this process: every arch's generate
    at TP 2 and TP 4, Jamba's prefill planes at both, and the shared trace
    at TP 2.  They run while ``reference`` runs JAX here; the ``runs``
    fixture waits for them."""
    jobs = []
    for arch in ARCHS:
        _, cfg, tree, _, tgen, prompt, enc = case(arch)
        jobs.append((generate_job, (cfg, tgen, prompt), dict(tree=tree, logits=True, enc=enc)))
    _, cfg, tree, _, tgen, prompt, _ = case(JAMBA)
    jobs.append((planes_job, (cfg, tgen, tree, prompt), {}))
    prompts, seeds, tgen = _shared_trace()
    serve = (shared_serve_job, (cfg, tgen, prompts, seeds, _shared_kw()), dict(tree=tree))
    dirs = {world: tmp_path_factory.mktemp(f"tp{world}") for world in WORLDS}

    def spawn_all() -> dict:
        return {world: tp.spawn(run_jobs, world, (jobs + ([serve] if world == 2 else []),),
                                workdir=dirs[world], threads=1) for world in WORLDS}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(spawn_all)


@pytest.fixture(scope="module")
def reference(ranks):
    """The reference's tokens and logits of each arch, and its scheduler's
    tokens and forks over the shared trace (JAX on the CPU, while the ranks
    run)."""
    import jax
    import jax.numpy as jnp

    from repro.core import make_engine as jmake
    from repro.runtime import Request as JRequest
    from test_torch_hybrid_serving import _drive, _schedulers

    out = {}
    for arch in ARCHS:
        jm, _, tree, jgen, _, prompt, enc = case(arch)
        params = jax.tree_util.tree_map(jnp.asarray, tree)
        kw = {} if enc is None else dict(enc_embeds=jnp.asarray(enc))
        tokens = np.asarray(jmake(jm, jgen, attn_impl="xla", importance_impl="xla").generate(
            params, jnp.asarray(prompt), jax.random.PRNGKey(0), **kw))
        out[arch] = (tokens, np.asarray(jm.forward(params, jnp.asarray(tokens), **kw)[0]))
    prompts, seeds, _ = _shared_trace()
    jsched, _ = _schedulers(temperature=0.8, prefix_sharing=True)
    out["trace"] = (_drive(jsched, [JRequest(prompt=p.copy(), sample_seed=s)
                                    for p, s in zip(prompts, seeds)], [0] * len(prompts)),
                    jsched.stats.cow_forks)
    return out


@pytest.fixture(scope="module")
def runs(ranks, reference):
    """{world: per-rank results}."""
    return ranks.result(timeout=900)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_stack_tokens_equal_reference(runs, reference, arch, world):
    want, want_logits = reference[arch]
    # greedy SeamlessM4T: every [mask] row of a block ties, so the block's
    # prefill unmasks all of it to one id (test_torch_cross)
    assert len(np.unique(want[:, PL:])) >= (2 if arch == AUDIO else 8), "degenerate output"
    results = [r[ARCHS.index(arch)] for r in runs[world]]
    for rank, res in enumerate(results):
        np.testing.assert_array_equal(res["tokens"], want, err_msg=f"rank {rank}")
        np.testing.assert_allclose(res["logits"], want_logits, atol=1e-2, rtol=0,
                                   err_msg=f"rank {rank}")
    for res in results[1:]:
        np.testing.assert_array_equal(res["logits"], results[0]["logits"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_stack_collectives_per_generate(runs, arch, world):
    """Per pass: one sum for the embedding and one for the logits, two a
    mixer layer (``ssm_norm``, ``ssm``), one after each attention, cross-
    attention, MLP and MoE FFN; per encode (one a ``generate``), one after
    each encoder layer's attention and MLP."""
    cfg = case(arch)[1]
    kinds = [cfg.layer_kind(l) for l in range(cfg.n_layers)]
    moe = sum(cfg.layer_is_moe(l) for l in range(cfg.n_layers))
    ffn = 0 if cfg.family == "ssm" else cfg.n_layers - moe
    c = runs[world][0][ARCHS.index(arch)]["collectives"]
    passes, enc = c["embed"], cfg.n_encoder_layers
    assert passes > 0 and c["logits"] == passes
    want = {"embed": passes, "logits": passes, "ssm": kinds.count("ssm") * passes,
            "ssm_norm": kinds.count("ssm") * passes, "moe": moe * passes,
            "cross": kinds.count("cross") * passes, "mlp": ffn * passes + enc,
            "attn": kinds.count("attn") * passes + enc}
    assert c == {k: v for k, v in want.items() if v}, c


@pytest.mark.parametrize("world", WORLDS)
def test_tp_jamba_planes_are_shards_of_tp1(runs, world):
    """Each rank's SSD state holds its SSM heads, its conv tail its
    ``d_inner / world`` x channels followed by all B/C channels, its
    ``ssmh`` the whole hidden rows, its K planes its KV head (Grouped), all
    within 1e-4 of each plane's largest magnitude of TP 1's (x10 weights
    grow the SSD states past 1e7, and the sums reorder f32 additions)."""
    from repro_torch.models.mamba import mamba_dims
    from repro_torch.sharding import specs

    _, cfg, tree, _, tgen, prompt, _ = case(JAMBA)
    want = planes_job(None, cfg, tgen, tree, prompt)
    sizes, d_inner = {"model": world}, mamba_dims(cfg)["d_inner"]
    rules = (specs.cache_leaf_spec("ssm", want[0].shape, sizes),
             specs.cache_leaf_spec("ssm", want[1].shape, sizes, d_inner=d_inner),
             specs.cache_leaf_spec("ssmh", want[2].shape, sizes),
             specs.cache_leaf_spec("kv", want[3].shape, sizes))
    assert rules[1][3] == specs.Leading("model", d_inner)
    for rank, res in enumerate(r[len(ARCHS)] for r in runs[world]):
        for name, got, full, spec in zip(("state", "conv_tail", "ssmh", "k"), res, want, rules):
            mine = specs.local_slice(full, spec, sizes, {"model": rank})
            assert got.shape == mine.shape == specs.local_shape(full.shape, spec, sizes), name
            scale = max(float(np.abs(full).max()), 1.0)
            np.testing.assert_allclose(got, mine, atol=1e-4 * scale, rtol=0,
                                       err_msg=f"rank {rank} {name}")


def test_tp2_jamba_shared_trace_equals_reference(runs, reference):
    want, forks = reference["trace"]
    assert forks > 0
    for rank in range(2):
        got = runs[2][rank][-1]
        for i, (x, y) in enumerate(zip(got["outputs"], want)):
            np.testing.assert_array_equal(x, y, err_msg=f"rank {rank} request {i}")
        assert got["cow_forks"] == forks


@pytest.mark.parametrize("arch", [MAMBA, AUDIO])
def test_mesh_of_one_is_bit_equal_to_no_mesh(tmp_path, arch):
    """One gloo rank in this process: ``Model(mesh=(1, 1))`` on the SSM and
    encoder stacks gives the same tokens and bit-equal logits as
    ``Model()``: the sums of one rank return their input, and the mixer's
    norm divides the same sum of squares by the same width."""
    from repro_torch.launch.mesh import make_debug_mesh

    _, cfg, tree, _, tgen, prompt, enc = case(arch)
    want = generate_job(None, cfg, tgen, prompt, tree=tree, logits=True, enc=enc)
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        got = generate_job(make_debug_mesh(1, 1, device_type="cpu"), cfg, tgen, prompt,
                           tree=tree, logits=True, enc=enc)
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["logits"], want["logits"])
    assert want["collectives"] == {} and got["collectives"]["logits"] > 0
