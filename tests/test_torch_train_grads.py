"""The port's training loss and its gradients against ``jax.value_and_grad``
of the reference's ``diffusion_loss``, on the CPU at f32.

Both packages get the same parameters (the reference's ``model.init``,
converted), the same key and the same synthetic batch (3 rows of 32, CE
chunks of 16, so the CE runs in two chunks).  The loss and its ``ce``,
``aux`` and ``mask_frac`` agree within 1e-5 relative, and every gradient
leaf, restacked to the reference's path (``convert.params_to_numpy``),
within 1e-4 of that leaf's largest |g|, on reduced:

* llada-8b (MHA), qwen2-1.5b (GQA, qkv bias, tied head), olmoe-1b-7b
  (experts at capacity factor 0.5, so picks drop, on 96 rows: two routing
  groups, the last half padding, with the aux loss), mamba2-370m (SSD),
  seamless-m4t-large-v2 (encoder and cross layers, ``enc_embeds``), the
  reference with its remat as the launcher runs it;
* jamba-v0.1-52b (one period of 8: attention, SSM and MoE layers) and
  llama-3.2-vision-11b (``enc_proj``, a cross layer in each period of 5),
  against the reference without remat: on a stack of period > 1 the
  reference's remat turns attention into self-attention to each position
  alone, which ``test_reference_remat_masks_attention_to_self`` pins (a
  reference-side fault the port does not mirror, ROADMAP.md).

The port's remat changes no gradient (per group, and per layer where the
period is above 1).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jbuild
from repro.train import loss as jloss
from repro.train.data import DataConfig, SyntheticTextDataset
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import prng
from repro_torch.models import Model
from repro_torch.train import loss as tloss
from repro_torch.utils.tree import flatten_with_paths

B, L, CHUNK = 3, 32, 16
KEY = 7
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


@functools.lru_cache(maxsize=None)
def setup(arch):
    """(reference model, its params, the numpy tree, port config, batch)."""
    jcfg, tcfg = reduced_cfg(jconfigs, arch), reduced_cfg(tconfigs, arch)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(1))
    tree = jax.tree_util.tree_map(np.asarray, params)
    n_enc = jcfg.n_enc_tokens if jcfg.family in ("audio", "vlm") else 0
    batch = SyntheticTextDataset(DataConfig(
        vocab_size=jcfg.vocab_size, seq_len=L, global_batch=B, seed=3, n_enc_tokens=n_enc,
        d_enc=jcfg.d_enc or jcfg.d_model)).next_batch()
    return jm, params, tree, tcfg, batch


def port_model(tree, tcfg):
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(params_from_numpy(tree, tcfg, "cpu"))
    return tm.requires_grad_(True)


@functools.lru_cache(maxsize=None)
def reference(arch, remat):
    """The reference's loss, metrics and gradient tree (numpy)."""
    jm, params, _, _, batch = setup(arch)

    def fn(p, key, tokens, region, enc):
        return jloss.diffusion_loss(jm, p, key, tokens, region, enc_embeds=enc, ce_chunk=CHUNK,
                                    remat=remat)
    enc = batch.get("enc_embeds")
    (loss, metrics), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(
        params, jax.random.PRNGKey(KEY), jnp.asarray(batch["tokens"]),
        jnp.asarray(batch["loss_region"]), None if enc is None else jnp.asarray(enc))
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            flatten_with_paths(jax.tree_util.tree_map(np.asarray, grads)))


def port(arch, remat):
    """The port's loss, metrics and gradient tree, under the reference's paths."""
    _, _, tree, tcfg, batch = setup(arch)
    tm = port_model(tree, tcfg)
    enc = batch.get("enc_embeds")
    loss, metrics = tloss.diffusion_loss(
        tm, prng.prng_key(KEY), torch.from_numpy(batch["tokens"]),
        torch.from_numpy(batch["loss_region"]),
        enc_embeds=None if enc is None else torch.from_numpy(enc), ce_chunk=CHUNK, remat=remat)
    loss.backward()
    return (loss.item(), {k: v.item() for k, v in metrics.items()},
            flatten_with_paths(params_to_numpy(tm, grads=True)))


def assert_grads_close(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for path, g in want.items():
        assert got[path].shape == g.shape, path
        bound = 1e-4 * float(np.abs(g).max())
        err = float(np.abs(got[path] - g).max())
        assert err <= bound, f"{path}: max |err| {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_and_grads_match_value_and_grad(arch):
    want_loss, want_metrics, want_grads = reference(arch, ARCHS[arch][1])
    loss, metrics, grads = port(arch, remat=True)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    for name in ("ce", "aux", "mask_frac"):
        np.testing.assert_allclose(metrics[name], want_metrics[name], rtol=1e-5, err_msg=name)
    assert (metrics["aux"] > 0) == (tconfigs.get_config(arch).moe is not None)
    assert_grads_close(grads, want_grads)
    assert all(np.abs(g).max() > 0 for g in want_grads.values()), "a leaf without gradient"


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "jamba-v0.1-52b"])
def test_remat_changes_no_gradient(arch):
    """Checkpointing each group (and each layer of a period-8 group)
    recomputes the same values: loss and gradients equal without it."""
    loss_r, _, grads_r = port(arch, remat=True)
    loss, _, grads = port(arch, remat=False)
    assert loss == loss_r
    for path, g in grads.items():
        np.testing.assert_allclose(grads_r[path], g, rtol=0, atol=1e-7 * np.abs(g).max(),
                                   err_msg=path)


def test_reference_remat_masks_attention_to_self():
    """Pins a reference-side fault the port does not mirror: on a stack of
    period > 1 the reference's per-layer ``jax.checkpoint`` takes the
    layer's window 0 as a traced argument, so ``ops.attention`` no longer
    sees the Python int 0 and applies a window of 0: each query attends its
    own position only, its scores no longer depend on q and k, and ``wq``
    and ``wk`` get no gradient.  Without remat the reference equals the
    port's (remat or not)."""
    loss_r, _, grads_r = reference("llama-3.2-vision-11b", True)
    loss, _, grads = reference("llama-3.2-vision-11b", False)
    self_attn = [p for p in grads if p.endswith("/attn/wq") or p.endswith("/attn/wk")]
    assert self_attn
    for p in self_attn:
        assert not grads_r[p].any() and grads[p].any(), p
    assert abs(loss_r - loss) > 1e-3
    np.testing.assert_allclose(port("llama-3.2-vision-11b", remat=True)[0], loss, rtol=1e-5)
