"""The port's training substrate (``repro_torch.train``) against the
reference's ``repro.train``, on the CPU at f32.

* data: ``SyntheticTextDataset`` batches equal the reference's, with and
  without the ``enc_embeds`` stubs;
* the diffusion mask and ``t`` bit-equal the reference's for the same key;
* the chunked CE equals the full CE and the reference's chunked CE;
* AdamW: ``lr_at``, the clip, one and three ``adamw_update`` steps on a
  converted tree with random grads, and the decay rule pinned in both
  packages (the stacked rank, a reference-side fault mirrored on purpose);
* the tree paths, ``params_to_numpy``, checkpoints across the packages in
  both directions;
* three ``make_train_step`` steps against the reference's jitted one;
* the launcher (``python -m repro_torch.launch.train``), its card default,
  and a falling loss (the reference's ``test_loss_decreases_e2e``).
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jbuild
from repro.train import checkpoint as jckpt
from repro.train import data as jdata
from repro.train import loss as jloss
from repro.train import optimizer as jopt
from repro.train import train_step as jstep
from repro.utils.tree import flatten_with_paths as jflatten
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import prng
from repro_torch.launch import train as launcher
from repro_torch.models import Model
from repro_torch.train import (
    DataConfig,
    OptimizerConfig,
    SyntheticTextDataset,
    TrainState,
    init_opt_state,
    init_train_state,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.train import loss as tloss
from repro_torch.train import optimizer as topt
from repro_torch.utils.tree import flatten_with_paths

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the reduced models' ops are tiny, and several
    test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(arch, seed=0, capacity_factor=None, **replace):
    """(reference model, its params, port model with the same values)."""
    cfgs = []
    for c in (jconfigs, tconfigs):
        cfg = dataclasses.replace(c.reduced(c.get_config(arch)), **replace)
        if capacity_factor is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=capacity_factor))
        cfgs.append(cfg)
    jcfg, tcfg = cfgs
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg,
                                         "cpu"))
    return jm, params, tm


def numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def assert_trees_close(got: dict, want: dict, atol: float) -> None:
    got, want = flatten_with_paths(got), flatten_with_paths(want)
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(got[path], np.asarray(w), rtol=0, atol=atol, err_msg=path)


# ---------------------------------------------------------------- data, mask, CE
@pytest.mark.parametrize("seed", [0, 1, 42])
@pytest.mark.parametrize("enc", [(0, 0), (16, 128)], ids=["text", "enc_embeds"])
def test_batches_equal_reference(seed, enc):
    kw = dict(vocab_size=503, seq_len=64, global_batch=3, seed=seed, n_enc_tokens=enc[0],
              d_enc=enc[1])
    got, want = SyntheticTextDataset(DataConfig(**kw)), jdata.SyntheticTextDataset(
        jdata.DataConfig(**kw))
    for _ in range(3):
        a, b = got.next_batch(), want.next_batch()
        assert a.keys() == b.keys() and ("enc_embeds" in a) == bool(enc[0])
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1])
def test_diffusion_mask_bit_equal(seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, 500, (4, 96)).astype(np.int32)
    region = np.ones((4, 96), bool)
    region[:, :24] = False
    want_m, want_t, want_k = jloss.sample_diffusion_mask(
        jax.random.PRNGKey(seed), jnp.asarray(tokens), jnp.asarray(region))
    got_m, got_t, got_k = tloss.sample_diffusion_mask(
        prng.prng_key(seed), torch.from_numpy(tokens), torch.from_numpy(region))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_t.numpy().view(np.uint32),
                                  np.asarray(want_t).view(np.uint32))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k).astype(np.int64))
    assert got_m.any() and not got_m[:, :24].any()


def _ce_inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    b, l = 2, 32
    return (rng.standard_normal((b, l, cfg.d_model)).astype(np.float32),
            rng.integers(0, cfg.vocab_size, (b, l)).astype(np.int32),
            rng.uniform(size=(b, l)).astype(np.float32))


@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_chunked_ce_equals_full(chunk):
    _, _, tm = both("llada-8b")
    h, tgt, w = (torch.from_numpy(a) for a in _ce_inputs(tm.cfg))
    logits = tm.logits(h).float()
    nll = torch.logsumexp(logits, -1) - torch.gather(logits, -1, tgt.long()[..., None])[..., 0]
    want = float(torch.sum(nll * w) / torch.sum(w))
    got = float(tloss.chunked_masked_ce(tm, h, tgt, w, chunk=chunk))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("arch", ["llada-8b", "qwen2-1.5b"])
def test_chunked_ce_matches_reference(arch):
    jm, params, tm = both(arch)
    h, tgt, w = _ce_inputs(tm.cfg, seed=1)
    want = float(jloss.chunked_masked_ce(jm, params, jnp.asarray(h), jnp.asarray(tgt),
                                         jnp.asarray(w), chunk=8))
    got = float(tloss.chunked_masked_ce(tm, *(torch.from_numpy(a) for a in (h, tgt, w)),
                                        chunk=8))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ---------------------------------------------------------------------- AdamW
def test_lr_schedule_matches_reference():
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    jcfg, tcfg = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    for step in range(0, 101):
        want = float(jopt.lr_at(jcfg, jnp.asarray(step)))
        assert abs(float(topt.lr_at(tcfg, step)) - want) <= 1e-7, step
    assert float(topt.lr_at(tcfg, 0)) == 0.0


def test_clip_matches_reference():
    rng = np.random.default_rng(0)
    grads = {"a": rng.standard_normal((10, 4)).astype(np.float32) * 30,
             "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    for max_norm in (1.0, 1e4):
        want, want_norm = jopt.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, grads),
                                                   max_norm)
        flat = {k: torch.from_numpy(v) for k, v in flatten_with_paths(grads).items()}
        got, norm = topt.clip_by_global_norm(flat, max_norm)
        np.testing.assert_allclose(float(norm), float(want_norm), rtol=1e-6)
        for k, v in jflatten(want).items():
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-6, atol=1e-7)


def _random_grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32) * 0.1, numpy_tree(params))


def _set_grads(tm, grads):
    for name, g in params_from_numpy(grads, tm.cfg, "cpu").items():
        tm.get_parameter(name).grad = g


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_matches_reference(steps):
    """SeamlessM4T's tree has every kind of leaf: stacked layer and encoder
    leaves, top-level 1-D and 2-D ones and the cross layers' ``gate_attn``."""
    jm, params, tm = both("seamless-m4t-large-v2")
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, grad_clip=5.0)
    jcfg, tcfg = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    jstate, tstate = jopt.init_opt_state(params), topt.init_opt_state(tm)
    update = jax.jit(functools.partial(jopt.adamw_update, jcfg))
    for i in range(steps):
        grads = _random_grads(params, seed=i)
        params, jstate, jmet = update(params, grads, jstate)
        _set_grads(tm, grads)
        tstate, tmet = topt.adamw_update(tcfg, tm, tstate)
        np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=1e-6)
    assert tstate.step == int(jstate.step) == steps
    assert_trees_close(params_to_numpy(tm), numpy_tree(params), atol=1e-6)


def test_decay_rule_follows_the_stacked_rank():
    """Zero gradients, so a parameter moves only by its decay.  In both
    packages each layer's ``ln1``, ``lnx`` and ``ln2`` and the encoder
    layers' norms are decayed (the reference's stacked leaves are 2-D),
    while ``final_norm``, the encoder's ``final_norm`` and the cross
    layers' ``gate_attn`` ([G] when stacked) are not: the reference's
    docstring promises to skip every 1-D parameter, its code ranks the
    stacked leaf, and the port mirrors the code."""
    jm, params, tm = both("seamless-m4t-large-v2")
    kw = dict(lr=0.5, warmup_steps=0, total_steps=10)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    new, _, _ = jax.jit(functools.partial(jopt.adamw_update, jopt.OptimizerConfig(**kw)))(
        params, zeros, jopt.init_opt_state(params))
    tm.zero_grad(set_to_none=True)
    before = flatten_with_paths(params_to_numpy(tm))
    topt.adamw_update(topt.OptimizerConfig(**kw), tm, topt.init_opt_state(tm))
    after = flatten_with_paths(params_to_numpy(tm))
    jbefore, jafter = jflatten(numpy_tree(params)), jflatten(numpy_tree(new))
    decayed = {"layers/0/lnx", "layers/0/ln2", "encoder/ln1", "encoder/ln2", "embed",
               "layers/0/ffn/w_up", "encoder/attn/wq"}
    kept = {"final_norm", "encoder/final_norm", "layers/0/gate_attn"}
    for path in decayed | kept:
        for b, a in ((jbefore, jafter), (before, after)):
            moved = not np.array_equal(a[path], b[path])
            assert moved == (path in decayed), path
    assert after.keys() == jafter.keys()
    assert {p for p in after if not np.array_equal(after[p], before[p])} == \
        {p for p in jafter if not np.array_equal(jafter[p], jbefore[p])}
    assert not topt.decays("final_norm", tm.final_norm)
    assert topt.decays("layers.0.ln2", tm.layers[0].ln2)


# ------------------------------------------------------- tree, convert, checkpoints
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "jamba-v0.1-52b", "llama-3.2-vision-11b",
                                  "seamless-m4t-large-v2"])
def test_params_to_numpy_is_the_reference_tree(arch):
    """The restacked tree has the reference's paths, in its order, its
    shapes and dtypes, and the values it was converted from."""
    _, params, tm = both(arch)
    want, got = jflatten(numpy_tree(params)), flatten_with_paths(params_to_numpy(tm))
    assert list(got) == list(want)
    for path, w in want.items():
        assert got[path].shape == w.shape and got[path].dtype == w.dtype, path
        np.testing.assert_array_equal(got[path], w)


def test_checkpoint_reference_to_port(tmp_path):
    jm, _, tm = both("llama-3.2-vision-11b")
    other = jm.init(jax.random.PRNGKey(5))
    path = str(tmp_path / "ref.npz")
    jckpt.save_checkpoint(path, other, step=17)
    assert restore_checkpoint(path, tm) == 17
    assert_trees_close(params_to_numpy(tm), numpy_tree(other), atol=0)
    del_key = {k: v for k, v in np.load(path).items() if k != "layers/0/ln1"}
    np.savez(tmp_path / "short.npz", **del_key)
    with pytest.raises(KeyError, match="missing keys"):
        restore_checkpoint(str(tmp_path / "short.npz"), tm)


def test_checkpoint_port_to_reference(tmp_path):
    jm, params, tm = both("jamba-v0.1-52b", seed=2, n_layers=8)
    tm.init(torch.Generator().manual_seed(9))
    path = str(tmp_path / "sub" / "port.npz")
    save_checkpoint(path, tm, step=3)
    assert not os.path.exists(path + ".tmp")
    restored, step = jckpt.restore_checkpoint(path, params)
    assert step == 3
    assert_trees_close(numpy_tree(restored), params_to_numpy(tm), atol=0)
    assert jflatten(restored).keys() == jflatten(params).keys()


# ------------------------------------------------------------------ train step
def assert_updates_close(got: dict, want: dict, start: dict, lr_sum: float) -> None:
    """The parameters after some AdamW steps: each leaf's move from
    ``start`` within 1e-3 of the reference's move in l2, and no element off
    by more than 5% of the learning rates summed.  Adam divides a gradient
    element by its own size plus ``eps`` (1e-8), so an element whose
    gradient is near 1e-8 turns its rounding (1e-4 of the leaf's largest
    |g| at most, ``test_torch_train_grads``) into a visible part of its step;
    such elements are few, and the l2 of the move hides none of the rest."""
    got, want, start = flatten_with_paths(got), flatten_with_paths(want), flatten_with_paths(start)
    assert got.keys() == want.keys()
    for path, w in want.items():
        w = np.asarray(w)
        move = float(np.linalg.norm(w - start[path]))
        assert float(np.linalg.norm(got[path] - w)) <= 1e-3 * move, path
        assert float(np.abs(got[path] - w).max()) <= 0.05 * lr_sum, path


def test_train_steps_match_reference():
    """Three steps from the same params and key against the reference's
    jitted ``make_train_step`` (reduced OLMoE, capacity factor 0.5, so the
    aux loss and dropped picks take part): the metrics within 1e-5, the key,
    and the parameters' moves (:func:`assert_updates_close`)."""
    jm, params, tm = both("olmoe-1b-7b", seed=3, capacity_factor=0.5, n_layers=4)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=6)
    jfn = jax.jit(jstep.make_train_step(jm, jopt.OptimizerConfig(**kw), ce_chunk=16))
    tfn = make_train_step(tm, OptimizerConfig(**kw), ce_chunk=16)
    jst = jstep.TrainState(params, jopt.init_opt_state(params), jax.random.PRNGKey(4))
    tst = TrainState(tm, init_opt_state(tm), prng.prng_key(4))
    ds = SyntheticTextDataset(DataConfig(vocab_size=tm.cfg.vocab_size, seq_len=32,
                                         global_batch=3, seed=5))
    start, lr_sum = numpy_tree(params), 0.0
    for _ in range(3):
        batch = ds.next_batch()
        jst, jmet = jfn(jst, {k: jnp.asarray(v) for k, v in batch.items()})
        tst, tmet = tfn(tst, batch)
        for name in ("loss", "ce", "aux", "lr", "grad_norm", "mask_frac"):
            np.testing.assert_allclose(float(tmet[name]), float(jmet[name]), rtol=1e-5,
                                       err_msg=name)
        np.testing.assert_array_equal(tst.key.numpy(), np.asarray(jst.key).astype(np.int64))
        lr_sum += float(jmet["lr"])
        assert_updates_close(params_to_numpy(tm), numpy_tree(jst.params), start, lr_sum)
    assert tst.opt.step == 3 and all(p.requires_grad for p in tm.parameters())


def test_init_train_state_splits_the_key():
    cfg = tconfigs.reduced(tconfigs.get_config("qwen2-1.5b"))
    st = init_train_state(Model(cfg, device="cpu"), prng.prng_key(0))
    _, k2 = jax.random.split(jax.random.PRNGKey(0))
    np.testing.assert_array_equal(st.key.numpy(), np.asarray(k2).astype(np.int64))
    assert st.opt.step == 0 and all(p.requires_grad for p in st.model.parameters())
    assert all(torch.isfinite(p).all() for p in st.model.parameters())


# -------------------------------------------------------------------- launcher
def test_launcher_trains_and_writes_a_reference_checkpoint(tmp_path):
    path = tmp_path / "ckpt.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--reduced",
         "--arch", "qwen2-1.5b", "--steps", "6", "--batch", "2", "--seq", "64", "--ckpt",
         str(path)], env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("step ")]
    assert len(lines) == 6 and f"saved checkpoint to {path}" in proc.stdout
    losses = [float(ln.split()[3]) for ln in lines]
    assert all(np.isfinite(losses))
    jm = jbuild(jconfigs.reduced(jconfigs.get_config("qwen2-1.5b")))
    restored, step = jckpt.restore_checkpoint(str(path), jm.init(jax.random.PRNGKey(0)))
    assert step == 6
    tm = Model(tconfigs.reduced(tconfigs.get_config("qwen2-1.5b")), device="cpu")
    assert restore_checkpoint(str(path), tm) == 6
    assert_trees_close(params_to_numpy(tm), numpy_tree(restored), atol=0)


def test_launcher_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        launcher.main(["--reduced", "--arch", "qwen2-1.5b", "--steps", "1"])


def test_loss_decreases_e2e():
    """The reference's ``test_loss_decreases_e2e`` on the port."""
    cfg = tconfigs.reduced(tconfigs.get_config("qwen2-1.5b"))
    model = Model(cfg, device="cpu")
    state = init_train_state(model, prng.prng_key(0))
    step = make_train_step(model, OptimizerConfig(lr=1e-3, total_steps=12, warmup_steps=2),
                           ce_chunk=16)
    ds = SyntheticTextDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                         global_batch=4))
    losses = []
    for _ in range(10):
        state, metrics = step(state, ds.next_batch())
        losses.append(float(metrics["loss"]))
    assert min(losses[-3:]) < losses[0]
