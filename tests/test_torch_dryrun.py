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
* the SSM, hybrid, cross-attention and encoder stacks: reduced Jamba's and
  SeamlessM4T's debug-mesh ``argument_size`` equals a real TP-2 rank's
  bytes (SeamlessM4T's prefill takes ``enc_embeds`` and encodes them), and
  full-size mamba2, Jamba, the vision model and SeamlessM4T run on the
  single-pod mesh with the collectives their layer kinds make;
* a refused combination records its reason, and ``train_4k`` runs (FSDP x
  TP) where the mesh divides the heads.
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
INPUT_KIND = {"decode_32k": "decode", "prefill_32k": "prefill"}
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


@pytest.mark.parametrize("arch,shape_name", [("jamba-v0.1-52b", "decode_32k"),
                                              ("seamless-m4t-large-v2", "prefill_32k")])
def test_debug_mesh_argument_size_on_ssm_and_cross_stacks(arch, shape_name):
    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    shape = InputShape(shape_name, 64, 4, INPUT_KIND[shape_name])
    gen = tconfigs.GenerationConfig(mode="es", gen_length=16, block_length=8,
                                    skip_stages=tconfigs.default_skip_stages(cfg.n_layers))
    res = dryrun.run_one(arch, shape_name, "debug", debug=(1, 2), cfg=cfg, shape=shape, gen=gen,
                         verbose=False)
    mesh = dryrun.make_mesh("debug", (1, 2))
    _, args, model = step_lib.input_specs(arch, "", mesh, device="cpu", cfg=cfg, shape=shape,
                                          gen=gen)
    real = dryrun.nbytes(list(model.parameters())) + dryrun.nbytes(dryrun.tensors_of(args))
    assert res["memory"]["argument_size"] == real
    if arch == "jamba-v0.1-52b":
        # the rank's SSM heads and x channels, every B/C channel
        mixer = model.layers[0].mixer
        d_inner = cfg.ssm.expand * cfg.d_model
        assert mixer.x_proj.shape[1] == d_inner // 2 and mixer.bc_proj.shape[1] == \
            2 * cfg.ssm.d_state
        state = args[0].cache.ssm
        assert state.conv_tail.shape[3] == d_inner // 2 + 2 * cfg.ssm.d_state
        assert state.state.shape[2] == d_inner // cfg.ssm.headdim // 2
    else:
        # the prefill step's enc_embeds, and the encoder's sums
        assert args[2].shape == (shape.global_batch, cfg.n_enc_tokens, cfg.d_enc)
        assert args[0].cache.cross.k.shape[3] == cfg.n_kv_heads // 2
        assert res["collectives_by_site"]["count"]["attn"] == cfg.n_encoder_layers


@pytest.mark.parametrize("arch,shape_name", [("mamba2-370m", "decode_32k"),
                                              ("jamba-v0.1-52b", "decode_32k"),
                                              ("llama-3.2-vision-11b", "decode_32k"),
                                              ("seamless-m4t-large-v2", "prefill_32k")])
def test_remaining_stacks_on_the_single_mesh(arch, shape_name):
    """One step at full size on 256 ranks: one sum a pass for the embedding
    and the logits, two a mixer layer, one after each attention, cross-
    attention, MLP and MoE FFN, and one after each encoder layer's
    attention and MLP where the step encodes (SeamlessM4T's prefill)."""
    res = dryrun.run_one(arch, shape_name, "single", verbose=False)
    assert "unsupported" not in res and res["n_chips"] == 256
    cfg = tconfigs.get_config(arch)
    kinds = [cfg.layer_kind(l) for l in range(cfg.n_layers)]
    moe = sum(cfg.layer_is_moe(l) for l in range(cfg.n_layers))
    ffn = 0 if cfg.family == "ssm" else cfg.n_layers - moe
    enc = cfg.n_encoder_layers if shape_name == "prefill_32k" else 0
    want = {"embed": 1, "logits": 1, "ssm": kinds.count("ssm"), "ssm_norm": kinds.count("ssm"),
            "moe": moe, "cross": kinds.count("cross"), "mlp": ffn + enc,
            "attn": kinds.count("attn") + enc}
    assert res["collectives_by_site"]["count"] == {k: v for k, v in want.items() if v}
    if "ssm" in kinds:
        assert res["kernels"]["ssd_chunks"]["calls"] == kinds.count("ssm")


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-v0.1-52b", "llama-3.2-vision-11b",
                                  "seamless-m4t-large-v2"])
def test_full_size_model_builds_at_model_2(arch):
    """``Model(cfg, mesh=...)`` at full size on a ``(1, 2)`` mesh, on fake
    tensors: each rank holds half of every head-cut leaf and the whole of
    the leaves the forward reads whole."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import Model

    cfg = step_lib.dryrun_model_config(arch)
    mesh = dryrun.make_mesh("debug", (1, 2))
    with FakeTensorMode():
        model = Model(cfg, device=dryrun.fake_device(), mesh=mesh)
    for l in range(cfg.n_layers):
        layer = model.layers[l]
        if layer.kind == "ssm":
            d_inner = cfg.ssm.expand * cfg.d_model
            assert layer.mixer.x_proj.shape == (cfg.d_model, d_inner // 2)
            assert layer.mixer.a_log.shape == (d_inner // cfg.ssm.headdim // 2,)
            assert layer.mixer.bc_proj.shape == (cfg.d_model, 2 * cfg.ssm.d_state)
        attn = layer.xattn if layer.kind == "cross" else getattr(layer, "attn", None)
        if attn is not None:
            assert attn.wq.shape[1] == cfg.n_heads * cfg.head_dim // 2
    if model.encoder is not None:
        assert model.encoder.layers[0].attn.wq.shape[1] == cfg.n_heads * cfg.head_dim // 2


def test_refused_combination_records_its_reason():
    res = dryrun.run_one("gemma3-1b", "decode_32k", "single", verbose=False)
    assert "4 heads over model=16" in res["unsupported"]
    res = dryrun.run_one("dream-7b", "decode_32k", "single", verbose=False)
    assert "28 heads over model=16" in res["unsupported"]
    # train_4k, which refused every arch until FSDP x TP training was
    # ported, now runs (LLaDA-8B's widths at 2 layers here; the full depth
    # takes 20 s) and refuses only head counts the mesh does not divide
    cfg = dataclasses.replace(step_lib.dryrun_model_config("llada-8b"), n_layers=2)
    res = dryrun.run_one("llada-8b", "train_4k", "single", verbose=False, cfg=cfg)
    assert "unsupported" not in res and res["kind"] == "train"
    assert res["collectives_by_site"]["count"]["fsdp_grad"] == 7 * 2 + 2
    res = dryrun.run_one("qwen2-1.5b", "train_4k", "single", verbose=False)
    assert "12 heads over model=16" in res["unsupported"]
    # a stack PR 27 refused now runs: Jamba on the single-pod mesh, pure TP
    res = dryrun.run_one("jamba-v0.1-52b", "decode_32k", "single", verbose=False)
    assert "unsupported" not in res and res["collectives_by_site"]["count"]["ssm"] == 28
