"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: one step of
the tensor-parallel engine as rank 0 of a ``fake`` process group, on fake
tensors.

* a debug mesh ``(data=1, model=2)`` on reduced LLaDA-8B: ``argument_size``
  equals the bytes of a real TP-2 rank's parameters and state (built from
  real tensors, the same code), and the collectives are what the code makes:
  one sum after attention and one after the MLP in each layer, one for the
  embedding and one for the logits;
* reduced LLaDA's step FLOPs on a 1 x 1 mesh against the reference's
  ``cost_analysis`` of the same step (``decode_iteration`` lowered by XLA
  on the CPU), within 2%: the port counts the matmuls and the kernels'
  work (``kernels/fake.py``); XLA also counts the element-wise work of the
  norms, RoPE, the softmaxes and the confidence (1.1% here).  XLA's cost analysis
  counts a loop body once, not once per trip, and the reference scans each
  segment's layer groups, so this model has 3 layers with skip stages after
  layers 1 and 2: every segment is one group (at 4 layers XLA leaves the
  last segment's second layer out, 8.4e6 of 7.3e7 FLOPs);
* one full-size ``decode_32k`` step of LLaDA-8B on the single-pod mesh
  finishes on fake tensors;
* a refused combination records its reason.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.core import make_engine as jmake
from repro.models import build_model as jbuild
from repro.utils.hlo import cost_analysis_dict
from repro_torch import configs as tconfigs
from repro_torch.configs import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch import steps as step_lib

SHAPE = InputShape("decode_reduced", 128, 4, "decode")
STAGES = ((1, 0.5), (2, 0.5))
GEN = dict(mode="es", gen_length=32, block_length=8, prompt_refresh_period=64,
           block_refresh_period=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread_and_no_group():
    """One intra-op thread; the fake process group is torn down after the
    module, so no later test in this worker sees it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    if dist.is_initialized():
        dist.destroy_process_group()


def reduced(dtype="float32", n_layers=4):
    cfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config("llada-8b")), n_layers=n_layers,
                              param_dtype=dtype, compute_dtype=dtype)
    gen = tconfigs.GenerationConfig(skip_stages=tuple(tconfigs.SkipStage(*s) for s in STAGES),
                                    **GEN)
    return cfg, gen


def test_debug_mesh_argument_size_and_collectives():
    cfg, gen = reduced("bfloat16")
    res = dryrun.run_one("llada-8b", "decode_reduced", "debug", debug=(1, 2), cfg=cfg,
                         shape=SHAPE, gen=gen, verbose=False)
    # a real TP-2 rank 0: the same model and state from real CPU tensors
    mesh = dryrun.make_mesh("debug", (1, 2))
    _, (state, _), model = step_lib.input_specs("llada-8b", "", mesh, device="cpu", cfg=cfg,
                                                shape=SHAPE, gen=gen)
    real = dryrun.nbytes(list(model.parameters())) + dryrun.nbytes(dryrun.tensors_of(state))
    assert res["memory"]["argument_size"] == real
    assert model.layers[0].attn.wq.shape == (cfg.d_model, cfg.n_heads // 2 * cfg.head_dim)
    assert state.cache.k.shape[3] == cfg.n_kv_heads // 2
    layers = cfg.n_layers
    assert res["collectives"]["count_by_kind"] == {"all-reduce": 2 * layers + 2}
    assert res["collectives_by_site"]["count"] == {"embed": 1, "attn": layers,
                                                   "mlp": layers, "logits": 1}
    # the logits' sum carries the whole padded vocab of the block's last rows
    vp = model.embed.shape[0] * 2
    assert res["collectives_by_site"]["bytes"]["logits"] % (vp * 2) == 0
    assert res["memory"]["temp_size"] > 0 and res["flops"] > 0
    assert res["kernels"]["flash_attention"]["calls"] == layers


def test_step_flops_match_reference_cost_analysis():
    cfg, gen = reduced(n_layers=3)
    res = dryrun.run_one("llada-8b", "decode_reduced", "debug", debug=(1, 1), cfg=cfg,
                         shape=SHAPE, gen=gen, verbose=False)
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get_config("llada-8b")), n_layers=3)
    jm = jbuild(jcfg)
    jgen = jconfigs.GenerationConfig(skip_stages=tuple(jconfigs.SkipStage(*s) for s in STAGES),
                                     **GEN)
    eng = jmake(jm, jgen, attn_impl="xla", importance_impl="xla")
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    state = jax.eval_shape(lambda: eng.make_block_state(
        jnp.zeros((SHAPE.global_batch, SHAPE.seq_len), jnp.int32), jax.random.PRNGKey(0)))
    bs = jax.ShapeDtypeStruct((SHAPE.global_batch,), jnp.int32)
    compiled = jax.jit(eng.decode_iteration).lower(params, state, bs).compile()
    want = cost_analysis_dict(compiled)["flops"]
    assert want > 0
    assert abs(res["flops"] - want) <= 0.02 * want, (res["flops"], want)


def test_full_size_decode_on_the_single_mesh():
    res = dryrun.run_one("llada-8b", "decode_32k", "single", verbose=False)
    assert res["n_chips"] == 256 and res["local_batch"] == 8
    # 32 layers, 2 sums each, the embedding and the logits
    assert res["collectives"]["total_count"] == 66
    # this rank: 1/16 of every layer's weights and of the padded vocab, and
    # 2 of 32 KV heads of a [8, 32768] cache in bf16
    cfg = tconfigs.get_config("llada-8b")
    cache = 2 * cfg.n_layers * 8 * 32768 * 2 * cfg.head_dim * 2
    assert res["memory"]["argument_size"] > cache
    assert res["kernels"]["flash_attention"]["calls"] == cfg.n_layers


def test_refused_combination_records_its_reason():
    res = dryrun.run_one("mamba2-370m", "decode_32k", "single", verbose=False)
    assert "ROADMAP" in res["unsupported"]
    res = dryrun.run_one("dream-7b", "decode_32k", "single", verbose=False)
    assert "28 heads over model=16" in res["unsupported"]
    res = dryrun.run_one("llada-8b", "train_4k", "single", verbose=False)
    assert "ROADMAP" in res["unsupported"]
