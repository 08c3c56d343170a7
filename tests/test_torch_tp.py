"""The port's tensor parallelism on the CPU, against the JAX reference.

Each mesh is ``(data=1, model=N)`` over N gloo ranks, one process each
(``repro_torch.launch.tp.spawn``: the store is a file under ``tmp_path``,
so concurrent test workers cannot collide).  Reduced LLaDA-8B, Dream-7B
(4 query heads on 1 KV head: at TP 2 and 4 each rank keeps the one KV head,
the ``kv_heads`` divergence) and OLMoE (4 experts: 2 or 1 a rank), 4
layers, f32, the reference's random-init parameters with every weight
matrix x10 (as ``test_torch_engine``), converted to each rank's shard:

* TP 2 and TP 4 ES greedy tokens equal the reference's, on every rank;
  each rank's logits of a cacheless forward over the output lie within
  1e-2 of the reference's (the logits are of order 1-10, but x10 weights
  grow the hidden states past 1e3, where one f32 ulp is 6e-5 to 1.2e-4,
  and the row-parallel sums add in another order than one matmul does:
  2e-3 is the largest difference seen);
* the collectives of a ``generate``: one sum after attention and one after
  the MLP (or MoE combine) a layer and pass, one for the embedding and one
  for the logits a pass;
* a reduced LLaDA paged ``StreamScheduler`` trace at TP 2 equals the
  reference scheduler's tokens;
* a mesh of size 1 gives results bit-equal to no mesh.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.convert import params_to_numpy
from repro_torch.launch import tp
from repro_torch.train import OptimizerConfig, make_train_step

# the ranks import this module to find their jobs: JAX and the reference's
# test helpers are imported where the parent process needs them, not here
ARCHS = ["llada-8b", "dream-7b", "olmoe-1b-7b"]
ES = dict(mode="es", skip_stages=((1, 0.5), (2, 0.5)))


def generate_job(mesh, cfg, gen, prompt: np.ndarray, *, tree, logits: bool = False,
                 enc: np.ndarray | None = None) -> dict:
    """One offline ``generate`` on the CPU: the tokens, the collectives it
    made, and with ``logits`` a cacheless forward's logits of the output;
    ``enc`` the encoder-conditioned archs' ``enc_embeds``."""
    from repro_torch.core import make_engine
    from repro_torch.sharding.comm import COUNTER

    model = tp.build_model(cfg, mesh, "cpu", tree=tree)
    engine = make_engine(model, gen, device="cpu")
    kw = {} if enc is None else dict(enc_embeds=torch.as_tensor(enc))
    COUNTER.reset()
    out = engine.generate(torch.as_tensor(prompt), **kw)
    res = dict(tokens=out.numpy(), collectives=dict(COUNTER.count_by_site))
    if logits:
        with torch.no_grad():
            res["logits"] = model.forward(out, **kw)[0].float().numpy()
    return res


def serve_job(mesh, cfg, gen, plan, sched_kw: dict, *, tree) -> list:
    """A ``StreamScheduler`` trace on the CPU: ``plan`` is ``[(step, prompt,
    max_new_tokens)]``; returns each request's output tokens."""
    from repro_torch.runtime import Request, StreamScheduler

    sched = StreamScheduler(tp.build_model(cfg, mesh, "cpu", tree=tree), gen, device="cpu",
                            **sched_kw)
    reqs = [Request(prompt=np.asarray(p).copy(), max_new_tokens=m) for _, p, m in plan]
    step = 0
    while step <= max(at for at, _, _ in plan) or sched.has_work():
        for (at, _, _), r in zip(plan, reqs):
            if at == step:
                sched.submit(r)
        sched.step()
        step += 1
    return [r.output for r in reqs]


def run_jobs(mesh, jobs) -> list:
    """``[fn(mesh, *args, **kw) for fn, args, kw in jobs]``: several jobs in
    one spawn."""
    return [fn(mesh, *args, **kw) for fn, args, kw in jobs]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The reduced models' ops are tiny: one intra-op thread runs them as
    fast as eight alone, and keeps them fast when several test workers
    share the CPU (each op's parallel region would wait on busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def case(arch):
    """(reference model, its params, port config, numpy tree x10, gens, prompt)."""
    import jax

    from test_torch_engine import gen_configs, models, prompt_for

    jm, params, tm = models(arch)
    tree = jax.tree_util.tree_map(np.asarray, params)
    jgen, tgen = gen_configs(**ES)
    return jm, params, tm.cfg, tree, jgen, tgen, prompt_for(tm.cfg)


def _offline_jobs():
    jobs = []
    for arch in ARCHS:
        _, _, cfg, tree, _, tgen, prompt = case(arch)
        jobs.append((generate_job, (cfg, tgen, prompt), dict(tree=tree, logits=True)))
    return jobs


def _serve_plan(vocab):
    from test_torch_serving import TRACE

    rng = np.random.default_rng(11)
    return [(at, rng.integers(3, vocab, n).astype(np.int32), m) for at, n, m in TRACE]


def _serve_kw():
    from test_torch_serving import PL, PS

    return dict(max_slots=3, prompt_len=PL, paged=True, page_size=PS, early_advance=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: per-rank results}: TP 2 runs the three archs and the served
    trace, TP 4 the three archs."""
    from test_torch_engine import gen_configs
    from test_torch_serving import SERVE

    _, _, cfg, tree, _, _, _ = case("llada-8b")
    _, tgen = gen_configs(parallel_decoding=True, pd_threshold=0.5, **SERVE)
    serve = (serve_job, (cfg, tgen, _serve_plan(cfg.vocab_size), _serve_kw()), dict(tree=tree))
    out = {}
    for world, extra in ((2, [serve]), (4, [])):
        out[world] = tp.spawn(run_jobs, world, (_offline_jobs() + extra,),
                              workdir=tmp_path_factory.mktemp(f"tp{world}"), threads=1)
    return out


@pytest.fixture(scope="module")
def reference():
    """The reference's tokens and logits of each arch (JAX on the CPU)."""
    import jax

    from repro.core import make_engine as jmake

    out = {}
    for arch in ARCHS:
        jm, params, _, _, jgen, _, prompt = case(arch)
        tokens = np.asarray(jmake(jm, jgen, attn_impl="xla", importance_impl="xla")
                            .generate(params, jax.numpy.asarray(prompt), jax.random.PRNGKey(0)))
        logits = np.asarray(jm.forward(params, jax.numpy.asarray(tokens))[0])
        out[arch] = (tokens, logits)
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_tokens_equal_reference(runs, reference, arch, world):
    from test_torch_engine import PROMPT_LEN

    want, want_logits = reference[arch]
    assert len(np.unique(want[:, PROMPT_LEN:])) >= 8, "degenerate reference output"
    results = [r[ARCHS.index(arch)] for r in runs[world]]
    for rank, res in enumerate(results):
        np.testing.assert_array_equal(res["tokens"], want, err_msg=f"rank {rank}")
        np.testing.assert_allclose(res["logits"], want_logits, atol=1e-2, rtol=0,
                                   err_msg=f"rank {rank}")
    # every rank holds the same summed values: bit-equal logits
    for res in results[1:]:
        np.testing.assert_array_equal(res["logits"], results[0]["logits"])


@pytest.mark.parametrize("world", [2, 4])
def test_tp_collectives_per_generate(runs, world):
    """Per pass (``generate`` runs one per iteration): one sum for the
    embedding and one for the logits, and one after attention and one after
    the FFN in each layer a pass reaches (every pass here runs all 4)."""
    res = runs[world][0][0]
    c = res["collectives"]
    passes = c["embed"]
    assert c["logits"] == passes and passes > 0
    assert c["attn"] == c["mlp"] == 4 * passes


def test_tp2_served_trace_equals_reference(runs):
    from repro.runtime import Request as JRequest
    from repro.runtime import StreamScheduler as JScheduler
    from test_torch_engine import gen_configs, models
    from test_torch_serving import SERVE, TRACE

    jm, params, tm = models("llada-8b")
    jgen, _ = gen_configs(parallel_decoding=True, pd_threshold=0.5, **SERVE)
    sched = JScheduler(jm, params, jgen, attn_impl="xla", **_serve_kw())
    plan = _serve_plan(tm.cfg.vocab_size)
    reqs = [JRequest(prompt=p.copy(), max_new_tokens=m) for _, p, m in plan]
    step = 0
    while step <= TRACE[-1][0] or sched.has_work():
        for (at, _, _), r in zip(plan, reqs):
            if at == step:
                sched.submit(r)
        sched.step()
        step += 1
    for rank in range(2):
        outs = runs[2][rank][-1]
        for got, r in zip(outs, reqs):
            np.testing.assert_array_equal(got, r.output, err_msg=f"rank {rank}")


def test_mesh_of_one_is_bit_equal_to_no_mesh(tmp_path):
    """One gloo rank in this process: ``Model(mesh=(1, 1))`` from the same
    tree gives the same tokens and bit-equal logits as ``Model()``; with a
    mesh, sparse attention refuses, while ``params_to_numpy`` and training,
    which refused a mesh until FSDP x TP training was ported, now run: the
    gathered tree is the one loaded, and a train step's metrics are
    finite."""
    from repro_torch.core import prng
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train import TrainState, init_opt_state
    from repro_torch.utils.tree import flatten_with_paths

    _, _, cfg, tree, _, tgen, prompt = case("llada-8b")
    want = generate_job(None, cfg, tgen, prompt, tree=tree, logits=True)
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        got = generate_job(make_debug_mesh(1, 1, device_type="cpu"), cfg, tgen, prompt,
                              tree=tree, logits=True)
        with pytest.raises(ValueError, match="sparse attention under tensor parallelism"):
            generate_job(make_debug_mesh(1, 1, device_type="cpu"), cfg,
                            dataclasses.replace(tgen, sparse_attention=True), prompt, tree=tree)
        model = tp.build_model(cfg, make_debug_mesh(1, 1, device_type="cpu"), "cpu", tree=tree)
        gathered = flatten_with_paths(params_to_numpy(model))
        step = make_train_step(model, OptimizerConfig(), ce_chunk=prompt.shape[1])
        batch = {"tokens": prompt, "loss_region": np.ones(prompt.shape, bool)}
        _, metrics = step(TrainState(model, init_opt_state(model), prng.prng_key(0)), batch)
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["logits"], want["logits"])
    assert want["collectives"] == {} and got["collectives"]["logits"] > 0
    for path, a in flatten_with_paths(tree).items():
        np.testing.assert_array_equal(gathered[path], a, err_msg=path)
    assert all(np.isfinite(float(v)) for v in metrics.values()) and metrics["grad_norm"] > 0


def test_tp_refusals():
    """Every registered arch passes ``check_supported``; what a mesh cannot
    cut raises ValueError naming the rule: query, KV and SSM heads that do
    not divide, and an SSM with more than one B/C group."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import Model
    from repro_torch.models.model import check_supported
    from repro_torch.sharding import specs

    for arch in configs.list_archs():
        check_supported(configs.get_config(arch))
    with pytest.raises(ValueError, match="n_heads % model"):
        specs.port_param_spec("layers.0.attn.wq", (1152, 1024), {"model": 16}, 256)
    with pytest.raises(ValueError, match="model % n_kv_heads"):
        specs.port_param_spec("layers.0.attn.wk", (4096, 3 * 128), {"model": 4}, 128)
    assert specs.port_param_spec("layers.0.attn.wk", (256, 4 * 32), {"model": 8}, 32) == \
        (None, specs.Grouped("model", 4))
    # mamba2-370m: 32 SSM heads of 64 channels
    ssm = configs.get_config("mamba2-370m").ssm
    assert specs.port_param_spec("layers.0.mixer.x_proj", (1024, 2048), {"model": 16}, 0,
                                 ssm=ssm) == (None, "model")
    with pytest.raises(ValueError, match="n_ssm_heads % model"):
        specs.port_param_spec("layers.0.mixer.x_proj", (1024, 2048), {"model": 64}, 0, ssm=ssm)
    with pytest.raises(ValueError, match="n_ssm_heads % model"):
        specs.port_param_spec("layers.0.mixer.a_log", (32,), {"model": 3}, 0, ssm=ssm)
    grouped = dataclasses.replace(ssm, n_groups=2)
    with pytest.raises(ValueError, match=r"n_groups=2.*ROADMAP"):
        specs.port_param_spec("layers.0.mixer.bc_proj", (1024, 512), {"model": 2}, 0,
                              ssm=grouped)
    # the model refuses both at construction, before any weight is drawn
    cfg = dataclasses.replace(configs.reduced(configs.get_config("mamba2-370m")), n_layers=1)
    with pytest.raises(ValueError, match="n_ssm_heads % model"):
        Model(cfg, device="cpu", mesh=_FakeModelAxis(64))
    with pytest.raises(ValueError, match="ROADMAP"):
        Model(dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, n_groups=2)),
              device="cpu", mesh=_FakeModelAxis(2))


class _FakeModelAxis:
    """A stand-in ``DeviceMesh`` with a ``model`` axis of ``size`` ranks:
    enough for ``TPGroup.from_mesh``, which reads the axis and no group
    until a collective runs."""
    mesh_dim_names = ("model",)

    def __init__(self, size: int):
        self.size_ = size

    def __getitem__(self, name):
        return self

    def get_group(self):
        return None

    def get_local_rank(self):
        return 0

    def size(self, dim=None):
        return self.size_
