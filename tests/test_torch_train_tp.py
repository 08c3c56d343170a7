"""The port's training under FSDP x TP against the JAX reference's unsharded
step, on the CPU at f32.

Meshes ``(data=2, model=1)``, ``(1, 2)`` and ``(2, 2)`` over gloo ranks, one
process each, spawned once per world size for the whole module
(``repro_torch.launch.tp.spawn``; the world of 2 runs both of its meshes);
the ranks run in a thread while JAX computes the reference here, as in
``test_torch_tp_stacks``.  The seven reduced archs of
``test_torch_train_grads`` with its settings: olmoe at capacity factor 0.5
(picks drop), Jamba at 8 layers, Jamba and the vision model against the
reference without remat (``test_reference_remat_masks_attention_to_self``);
the port trains with remat everywhere.  A global batch of 4 rows of 32, CE
chunks of 16: a data rank holds 64 tokens, one routing group of 64 on the
MoE archs; reduced qwen2's single KV head is ``Grouped`` at ``model=2``.
Each rank builds its shard of the reference's parameters
(``Model(mode="train")``, ``convert.params_from_numpy``) and takes two
``make_train_step`` steps (clip and AdamW, lr 1e-3) on two global batches.

* Step 1's ``loss``, ``ce``, ``aux`` and ``mask_frac`` lie within 1e-5
  relative of ``jax.value_and_grad`` of the reference's ``diffusion_loss``
  on the global batch, and every gradient leaf, gathered to the reference's
  path (``params_to_numpy(grads=True)``), within 1e-4 of that leaf's largest
  |g|; the metrics are equal on every rank.
* Both steps' ``loss`` and ``grad_norm`` lie within 1e-5 relative of the
  reference's ``make_train_step``'s, and the parameters after them within
  the bound :func:`assert_params_close` states.
* Every leaf that several ranks hold (whole on ``model``, ``Grouped``, whole
  on ``data``) is bit-equal across them, its gradient too.
* The collectives of a step, by kind and site, equal :func:`want_counts`.
* A rank whose rows are not whole routing groups raises ``ValueError``.
* The dry run of the train step at ``debug=(2, 2)`` on reduced llada-8b and
  olmoe: the rank's ``argument_size`` equals a real ``(2, 2)`` rank's bytes
  of parameters, moments, key and rows, and each parameter's and moment's
  shape is ``specs.local_shape`` of its train spec.
* A checkpoint saved at ``(2, 2)`` (rank 0 writes the gathered tree)
  restores every rank's shards bit for bit.
* A ``(1, 1)`` mesh is bit-equal to no mesh (loss, gradients, parameters).
"""
import concurrent.futures
import dataclasses
import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import tp
from test_torch_tp import run_jobs

# the ranks import this module to find their jobs: JAX and the reference's
# test helpers are imported where the parent process needs them, not here
B, L, CHUNK = 4, 32, 16
KEY = 7
LR = 1e-3
EPS = 1e-8                             # OptimizerConfig's eps
# arch -> (capacity factor or None, the reference's remat, layers or None)
ARCHS = {
    "llada-8b": (None, True, None),
    "qwen2-1.5b": (None, True, None),
    "olmoe-1b-7b": (0.5, True, None),
    "mamba2-370m": (None, True, None),
    "seamless-m4t-large-v2": (None, True, None),
    "jamba-v0.1-52b": (None, False, 8),
    "llama-3.2-vision-11b": (None, False, None),
}
MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2),)}
ALL_MESHES = [m for ms in MESHES.values() for m in ms]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the reduced models' ops are tiny, and several
    test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reduced_cfg(c, arch):
    """``c`` is either package's ``configs``."""
    cf, _, n_layers = ARCHS[arch]
    cfg = c.reduced(c.get_config(arch))
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return cfg


def opt_config(c):
    return c.OptimizerConfig(lr=LR, warmup_steps=1, total_steps=2)


def batches(cfg, rows: int = B) -> list:
    """Two global batches of the port's synthetic data (the reference's)."""
    from repro_torch.train.data import DataConfig, SyntheticTextDataset

    n_enc = cfg.n_enc_tokens if cfg.family in ("audio", "vlm") else 0
    ds = SyntheticTextDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=L, global_batch=rows,
                                         seed=3, n_enc_tokens=n_enc,
                                         d_enc=cfg.d_enc or cfg.d_model))
    return [ds.next_batch(), ds.next_batch()]


@functools.lru_cache(maxsize=None)
def setup(arch):
    """(reference model, its params, the numpy tree, port config)."""
    import jax

    from repro import configs as jconfigs
    from repro.models import build_model as jbuild
    from repro_torch import configs as tconfigs

    jm = jbuild(reduced_cfg(jconfigs, arch))
    params = jm.init(jax.random.PRNGKey(1))
    return jm, params, jax.tree_util.tree_map(np.asarray, params), reduced_cfg(tconfigs, arch)


def shards_of(model, grads: bool = False) -> dict:
    """The rank's local shards (or their gradients), by parameter name."""
    return {n: (p.grad if grads else p).detach().clone() for n, p in model.named_parameters()}


def train_job(mesh, shape, cfg, tree) -> dict:
    """Two train steps of ``cfg`` on this rank of a ``shape`` mesh: the
    metrics of both, the collectives of the first by kind and site, the
    rank's shards and their gradients after the second, its coordinates,
    and on rank 0 the gathered gradients of step 1 and parameters after
    step 2 (``params_to_numpy``: every rank gathers)."""
    from repro_torch.convert import params_to_numpy
    from repro_torch.core import prng
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding import specs
    from repro_torch.sharding.comm import COUNTER
    from repro_torch.train import optimizer, train_step
    from repro_torch.utils.tree import flatten_with_paths

    mesh = make_debug_mesh(*shape, device_type="cpu")
    model = tp.build_model(cfg, mesh, "cpu", tree=tree, mode="train")
    step = train_step.make_train_step(model, opt_config(optimizer), ce_chunk=CHUNK)
    state = train_step.TrainState(model, optimizer.init_opt_state(model), prng.prng_key(KEY))
    b1, b2 = batches(cfg)
    COUNTER.reset()
    state, m1 = step(state, b1)
    counts = {k: dict(v) for k, v in COUNTER.count_by_kind_site.items()}
    grads1 = flatten_with_paths(params_to_numpy(model, grads=True))
    state, m2 = step(state, b2)
    params2 = flatten_with_paths(params_to_numpy(model))
    rank0 = dist.get_rank() == 0
    return dict(metrics=[{k: float(v) for k, v in m.items()} for m in (m1, m2)], counts=counts,
                shards=shards_of(model), grad_shards=shards_of(model, grads=True),
                coords=specs.mesh_coords(mesh), grads1=grads1 if rank0 else None,
                params2=params2 if rank0 else None)


def bytes_job(mesh, shape, cfg) -> dict:
    """A ``(2, 2)`` rank's training state at the dry run's shape: the bytes
    of its parameters, moments, key and rows of a global batch of ``B``."""
    from repro_torch.core import prng
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import Model
    from repro_torch.train.optimizer import init_opt_state

    mesh = make_debug_mesh(*shape, device_type="cpu")
    model = Model(cfg, device="cpu", mesh=mesh, mode="train")
    opt = init_opt_state(model)
    rows = B // (shape[0])
    tensors = (list(model.parameters()) + list(opt.mu.values()) + list(opt.nu.values())
               + [prng.prng_key(0), torch.zeros((rows, L), dtype=torch.int32),
                  torch.zeros((rows, L), dtype=torch.bool)])
    return dict(nbytes=sum(t.numel() * t.element_size() for t in tensors),
                shapes={n: tuple(p.shape) for n, p in model.named_parameters()},
                moments={n: tuple(t.shape) for n, t in opt.mu.items()})


def unaligned_job(mesh, shape, cfg) -> str:
    """A train step whose data rank holds 2 x 16 tokens, half a routing group
    of 64: the error it raises."""
    from repro_torch.core import prng
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train import optimizer, train_step

    mesh = make_debug_mesh(*shape, device_type="cpu")
    model = tp.build_model(cfg, mesh, "cpu", seed=0, mode="train")
    step = train_step.make_train_step(model, opt_config(optimizer), ce_chunk=16)
    state = train_step.TrainState(model, optimizer.init_opt_state(model), prng.prng_key(KEY))
    batch = {k: v[:, :16] for k, v in batches(cfg)[0].items()}
    try:
        step(state, batch)
    except ValueError as e:
        return str(e)
    return ""


def checkpoint_job(mesh, shape, cfg, tree, path: str) -> dict:
    """A train step at a ``shape`` mesh, ``save_checkpoint`` (rank 0 writes
    the gathered tree), then ``restore_checkpoint`` into a fresh model: its
    shards, and the step's, by name."""
    from repro_torch.core import prng
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import Model
    from repro_torch.train import checkpoint, optimizer, train_step

    mesh = make_debug_mesh(*shape, device_type="cpu")
    model = tp.build_model(cfg, mesh, "cpu", tree=tree, mode="train")
    step = train_step.make_train_step(model, opt_config(optimizer), ce_chunk=CHUNK)
    step(train_step.TrainState(model, optimizer.init_opt_state(model), prng.prng_key(KEY)),
         batches(cfg)[0])
    checkpoint.save_checkpoint(path, model, step=1)
    fresh = Model(cfg, device="cpu", mesh=mesh, mode="train")
    saved_step = checkpoint.restore_checkpoint(path, fresh)
    return dict(step=saved_step, trained=shards_of(model), restored=shards_of(fresh))


def world_jobs(world: int, workdir) -> list:
    jobs = []
    for shape in MESHES[world]:
        for arch in ARCHS:
            _, _, tree, cfg = setup(arch)
            jobs.append((train_job, (shape, cfg, tree), {}))
    if world == 4:
        for arch in DRY_ARCHS:
            jobs.append((bytes_job, ((2, 2), setup(arch)[3]), {}))
        jobs.append((unaligned_job, ((2, 2), setup("olmoe-1b-7b")[3]), {}))
        _, _, tree, cfg = setup("qwen2-1.5b")
        jobs.append((checkpoint_job, ((2, 2), cfg, tree, str(workdir / "ckpt.npz")), {}))
    return jobs


DRY_ARCHS = ("llada-8b", "olmoe-1b-7b")


def job_index(shape, arch) -> int:
    return MESHES[shape[0] * shape[1]].index(shape) * len(ARCHS) + list(ARCHS).index(arch)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Starts the ranks in a thread of this process; ``runs`` waits for
    them while ``reference`` runs JAX here."""
    dirs = {world: tmp_path_factory.mktemp(f"train{world}") for world in MESHES}
    jobs = {world: world_jobs(world, dirs[world]) for world in MESHES}

    def spawn_all() -> dict:
        return {world: tp.spawn(run_jobs, world, (jobs[world],), workdir=dirs[world],
                                threads=1) for world in MESHES}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(spawn_all)


@pytest.fixture(scope="module")
def reference(ranks):
    """Per arch: ``value_and_grad`` of the reference's loss at the initial
    parameters (step 1's key and batch) and at its step-1 parameters (step
    2's), and its ``make_train_step``'s metrics and parameters after two
    steps."""
    import jax
    import jax.numpy as jnp

    from repro.train import loss as jloss
    from repro.train import optimizer as joptimizer
    from repro.train.train_step import TrainState as JTrainState
    from repro.train.train_step import make_train_step as jmake_step
    from repro_torch.utils.tree import flatten_with_paths

    out = {}
    for arch, (_, remat, _) in ARCHS.items():
        jm, params, _, cfg = setup(arch)
        bs = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches(cfg)]

        def fn(p, key, batch):
            return jloss.diffusion_loss(jm, p, key, batch["tokens"], batch["loss_region"],
                                        enc_embeds=batch.get("enc_embeds"), ce_chunk=CHUNK,
                                        remat=remat)
        vg = jax.jit(jax.value_and_grad(fn, has_aux=True))
        step = jax.jit(jmake_step(jm, opt_config(joptimizer), ce_chunk=CHUNK, remat=remat))
        state = JTrainState(params, joptimizer.init_opt_state(params), jax.random.PRNGKey(KEY))
        grads, metrics = [], []
        for batch in bs:
            _, sub = jax.random.split(state.key)
            (loss, aux), g = vg(state.params, sub, batch)
            grads.append(flatten_with_paths(jax.tree_util.tree_map(np.asarray, g)))
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            metrics[-1]["vg_loss"] = float(loss)
            metrics[-1].update({f"vg_{k}": float(v) for k, v in aux.items()})
        out[arch] = dict(grads=grads, metrics=metrics, params2=flatten_with_paths(
            jax.tree_util.tree_map(np.asarray, state.params)))
    return out


@pytest.fixture(scope="module")
def runs(ranks, reference):
    """{world: per-rank results}."""
    return ranks.result(timeout=900)


def results(runs, shape, arch) -> list:
    return [r[job_index(shape, arch)] for r in runs[shape[0] * shape[1]]]


def assert_grads_close(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for path, g in want.items():
        assert got[path].shape == g.shape, path
        bound = 1e-4 * float(np.abs(g).max())
        err = float(np.abs(got[path] - g).max())
        assert err <= bound, f"{path}: max |err| {err:.3e} > {bound:.3e}"


def assert_params_close(got: dict, want: dict, grads: list, norms: list) -> None:
    """The bound after two AdamW steps.  An element whose reference gradient
    is at least 1e-4 of its leaf's largest |g| (the gradients' parity bound)
    and whose clipped gradient is at least ``100 * EPS`` at both steps moves
    as the reference's within ``1e-2 * LR``: AdamW's update is then
    normalised by the gradient, and ``eps`` takes at most 1e-2 of it (the
    clip scales a gradient by ``min(1, 1 / (norm + 1e-9))``).  Any
    other element may have its update's sign flipped, so it lies within
    ``4 * LR`` (an AdamW update is at most 1 at step 1 and 1.0007 at step 2
    with betas (0.9, 0.95))."""
    for path, p in want.items():
        determined = np.ones(p.shape, bool)
        for g, n in zip(grads, norms):
            a = np.abs(g[path])
            clip = min(1.0, 1.0 / (n + 1e-9))
            determined &= (a >= 1e-4 * float(a.max())) & (a * clip >= 100 * EPS)
        err = np.abs(got[path] - p)
        assert float(err.max(initial=0)) <= 4 * LR, path
        tight = float(err[determined].max(initial=0))
        assert tight <= 1e-2 * LR, f"{path}: {tight:.3e} on elements of well-set gradient"


@pytest.mark.parametrize("shape", ALL_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_and_grads_match_value_and_grad(runs, reference, arch, shape):
    res = results(runs, shape, arch)
    want = reference[arch]["metrics"][0]
    got = res[0]["metrics"][0]
    for name in ("loss", "ce", "aux", "mask_frac"):
        np.testing.assert_allclose(got[name], want[f"vg_{name}"], rtol=1e-5, err_msg=name)
    for r in res[1:]:
        assert r["metrics"] == res[0]["metrics"], "the ranks' metrics differ"
    assert_grads_close(res[0]["grads1"], reference[arch]["grads"][0])


@pytest.mark.parametrize("shape", ALL_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", list(ARCHS))
def test_two_steps_match_reference_train_step(runs, reference, arch, shape):
    res = results(runs, shape, arch)
    for got, want in zip(res[0]["metrics"], reference[arch]["metrics"]):
        for name in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[name], want[name], rtol=1e-5, err_msg=name)
    assert_params_close(res[0]["params2"], reference[arch]["params2"], reference[arch]["grads"],
                        [m["grad_norm"] for m in reference[arch]["metrics"]])


@pytest.mark.parametrize("shape", ALL_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", list(ARCHS))
def test_leaves_held_by_several_ranks_are_bit_equal(runs, arch, shape):
    """Ranks whose shards of a leaf cover the same piece of it hold the same
    bits, after two steps, and so do their gradients."""
    from repro_torch.models import Model
    from repro_torch.sharding import specs

    res = results(runs, shape, arch)
    cfg = setup(arch)[3]
    sizes = {"data": shape[0], "model": shape[1]}
    full = dict(Model(cfg, device="cpu").named_parameters())
    shared = 0
    for name, p in full.items():
        spec = specs.port_param_spec(name, tuple(p.shape), sizes, cfg.head_dim, mode="train",
                                     ssm=cfg.ssm)
        pieces: dict = {}
        for r in res:
            idx = specs.local_index(tuple(p.shape), spec, sizes, r["coords"])
            pieces.setdefault(tuple((s.start, s.stop) for s in idx), []).append(r)
        for holders in pieces.values():
            for r in holders[1:]:
                shared += 1
                for key in ("shards", "grad_shards"):
                    assert torch.equal(r[key][name], holders[0][key][name]), (name, key)
    assert shared > 0


def want_counts(arch, shape) -> dict:
    """The collectives of one train step, ``{kind: {site: count}}``.  Each
    layer's forward runs ``R`` times: once, then once in each checkpoint's
    recompute around it (the group's, and a period-8 stack's per-layer one),
    whose early stop is off under a mesh, so ``R`` is 2 on a period-1 stack
    and 3 on Jamba; the encoder runs once.  A *g* sum (``attn``, ``mlp``,
    ``moe``, ``cross``, ``ssm``, ``ssm_norm``; the data ranks' ``aux``) runs
    with its layer; ``embed`` once; ``logits`` twice a CE chunk (its
    checkpoint).  An *f* (``attn_in``, ``mlp_in``, ``moe_in``,
    ``moe_gates``, ``cross_in``, ``enc_in``, ``ssm_in``, ``ssm_bc``,
    ``ssm_rms``, ``head_in``) runs once, in the backward pass.  A leaf cut
    over ``data`` is gathered each time its layer runs (the tied embedding
    for the lookup and for the head) and reduce-scattered once for each
    gather of the first forward; a leaf whole on ``data`` is all-reduced
    over it (``dp_grad``), a ``Grouped`` one over its KV subgroup
    (``kv_heads``), once each.  With data ranks, ``loss`` sums three
    scalars (the CE's denominator, the CE and the mask's share); the norm
    sums once over the mesh."""
    from repro_torch.models import Model
    from repro_torch.sharding import specs

    cfg = setup(arch)[3]
    data, model = shape
    kinds = [cfg.layer_kind(l) for l in range(cfg.n_layers)]
    n = {k: kinds.count(k) for k in ("attn", "ssm", "cross")}
    n_moe = sum(cfg.layer_is_moe(l) for l in range(cfg.n_layers))
    n_mlp = (0 if cfg.family == "ssm" else cfg.n_layers) - n_moe
    n_enc, chunks = cfg.n_encoder_layers, L // CHUNK
    r = 2 if cfg.pattern_period == 1 else 3
    ar = {"embed": 1, "logits": 2 * chunks, "head_in": chunks, "grad_norm": 1,
          "attn": r * n["attn"] + n_enc, "mlp": r * n_mlp + n_enc, "moe": r * n_moe,
          "cross": r * n["cross"], "ssm": r * n["ssm"], "ssm_norm": r * n["ssm"],
          "attn_in": n["attn"] + n_enc, "mlp_in": n_mlp + n_enc, "moe_in": n_moe,
          "moe_gates": n_moe, "cross_in": n["cross"], "enc_in": n["cross"],
          "ssm_in": n["ssm"], "ssm_bc": n["ssm"], "ssm_rms": n["ssm"]}
    if data > 1:
        ar.update(loss=3, aux=r * n_moe)
    gathers = scatters = dp_grad = kv = 0
    sizes = {"data": data, "model": model}
    for name, p in Model(cfg, device="cpu").named_parameters():
        spec = specs.port_param_spec(name, tuple(p.shape), sizes, cfg.head_dim, mode="train",
                                     ssm=cfg.ssm)
        uses = 2 if name == "embed" and cfg.tie_embeddings else 1
        runs_ = r if name.startswith("layers.") else 1
        if data > 1 and "data" in spec:
            gathers, scatters = gathers + uses * runs_, scatters + uses
        elif data > 1:
            dp_grad += uses
        if any(isinstance(e, specs.Grouped) for e in spec):
            kv += uses
    ar.update(dp_grad=dp_grad, kv_heads=kv)
    out = {"all-reduce": {k: v for k, v in ar.items() if v}}
    if gathers:
        out["all-gather"] = {"fsdp_gather": gathers}
        out["reduce-scatter"] = {"fsdp_grad": scatters}
    return out


@pytest.mark.parametrize("shape", ALL_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", list(ARCHS))
def test_collectives_a_step(runs, arch, shape):
    for r in results(runs, shape, arch):
        assert r["counts"] == want_counts(arch, shape)


def test_rows_that_split_a_routing_group_raise(runs):
    msg = runs[4][0][-2]
    assert "routing groups of 64" in msg, msg


def test_checkpoint_saves_the_gathered_tree_and_cuts_it_back(runs):
    """A checkpoint saved at ``(2, 2)`` restores each rank's shards bit for
    bit (``restore_checkpoint`` checks the file holds every path of the
    reference's tree)."""
    for r in runs[4]:
        got = r[-1]
        assert got["step"] == 1
        assert got["trained"].keys() == got["restored"].keys()
        for name, p in got["trained"].items():
            assert torch.equal(got["restored"][name], p), name


@pytest.mark.parametrize("arch", DRY_ARCHS)
def test_dry_run_train_step_bytes_and_shapes(runs, arch):
    """``run_one(..., debug=(2, 2))`` on the reduced config at ``B x L``
    (f32, CE chunks of ``CHUNK``): its ``argument_size`` is rank 0's real
    bytes, its model's parameters and moments have the train spec's local
    shapes, and its collectives by kind and site are a real step's."""
    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun, steps
    from repro_torch.sharding import specs

    cfg = setup(arch)[3]
    real = runs[4][0][len(MESHES[4]) * len(ARCHS) + DRY_ARCHS.index(arch)]
    captured = {}
    make = steps.make_train_fn

    def spy(model, shape, **kw):
        out = make(model, shape, **kw)
        captured["model"], captured["opt"] = model, out[1][0].opt
        return out
    steps.make_train_fn = spy
    try:
        res = dryrun.run_one(arch, "train_tiny", "debug", debug=(2, 2), verbose=False,
                             cfg=cfg, shape=InputShape("train_tiny", L, B, "train"),
                             ce_chunk=CHUNK)
    finally:
        steps.make_train_fn = make
        dryrun_teardown()
    assert "unsupported" not in res, res
    assert res["memory"]["argument_size"] == real["nbytes"]
    sizes = {"data": 2, "model": 2}
    for name, p in captured["model"].named_parameters():
        full = captured["model"].fsdp.layout[name][0]
        spec = specs.port_param_spec(name, full, sizes, cfg.head_dim, mode="train", ssm=cfg.ssm)
        want = specs.local_shape(full, spec, sizes)
        assert tuple(p.shape) == want == real["shapes"][name], name
        assert tuple(captured["opt"].mu[name].shape) == want == real["moments"][name], name
    assert res["collectives"]["count_by_kind"]["reduce-scatter"] > 0
    assert res["collectives_by_site"]["count_by_kind"] == want_counts(arch, (2, 2))


def dryrun_teardown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "olmoe-1b-7b"])
def test_mesh_of_one_is_bit_equal_to_no_mesh(tmp_path, arch):
    """One gloo rank in this process: two steps of ``Model(mesh=(1, 1),
    mode="train")`` give the metrics, step-1 gradients and parameters of
    ``Model()``, bit for bit."""
    from repro_torch.launch.mesh import make_debug_mesh

    _, _, tree, cfg = setup(arch)
    want = train_job_single(None, cfg, tree)
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        got = train_job_single(make_debug_mesh(1, 1, device_type="cpu"), cfg, tree)
    finally:
        dist.destroy_process_group()
    assert got["metrics"] == want["metrics"]
    for key in ("grads1", "params2"):
        for path, a in want[key].items():
            np.testing.assert_array_equal(got[key][path], a, err_msg=f"{key} {path}")


def train_job_single(mesh, cfg, tree) -> dict:
    """:func:`train_job`'s two steps in this process, with or without a mesh."""
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.core import prng
    from repro_torch.models import Model
    from repro_torch.train import optimizer, train_step
    from repro_torch.utils.tree import flatten_with_paths

    model = Model(cfg, device="cpu", mesh=mesh, mode="train")
    model.load_state_dict(params_from_numpy(tree, cfg, "cpu", mesh=mesh, mode="train"))
    step = train_step.make_train_step(model, opt_config(optimizer), ce_chunk=CHUNK)
    state = train_step.TrainState(model, optimizer.init_opt_state(model), prng.prng_key(KEY))
    b1, b2 = batches(cfg)
    state, m1 = step(state, b1)
    grads1 = flatten_with_paths(params_to_numpy(model, grads=True))
    state, m2 = step(state, b2)
    return dict(metrics=[{k: float(v) for k, v in m.items()} for m in (m1, m2)], grads1=grads1,
                params2=flatten_with_paths(params_to_numpy(model)))
