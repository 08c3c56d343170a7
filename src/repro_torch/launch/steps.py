"""Step factories and their inputs for every (architecture x input shape)
combination, the counterpart of ``repro/launch/steps.py``; the dry run
(``launch/dryrun.py``) runs exactly these.

Shape -> step (the reference's mapping):
  prefill_32k -> prefill step (full forward, builds every ES cache); an
                 encoder-conditioned arch's step takes ``enc_embeds [B,
                 n_enc_tokens, d_enc]`` and encodes them first
  decode_32k  -> serve step   (ONE ES iteration: the active block against a
                 32k cache)
  long_500k   -> serve step at a 524,288-row cache; pure full-attention
                 archs run the windowed long-context variant (window 8,192
                 and a prompt anchor of 1,024)
  train_4k    -> train step   (the masked-diffusion loss, its backward pass
                 with remat, CE chunks of 256, and AdamW with
                 ``OptimizerConfig()``); the audio and vision archs' batch
                 holds ``enc_embeds`` too

The reference returns ``ShapeDtypeStruct`` stand-ins for XLA to lower; the
port builds the model, the engine and the step's state as they are, so
under ``FakeTensorMode`` they are fake tensors with no data.  With a mesh
the model is the rank's tensor-parallel shard (its ``model`` axis) and the
state holds the rank's share of the batch (its ``data``/``pod`` axes, where
they divide the batch, else the whole batch, as ``sharding.specs``'s guard
replicates it).  A train step's model is cut by the train rules, FSDP over
``data`` x TP over ``model`` (``sharding/fsdp.py``), and its state holds
the rank's shards of the parameters and AdamW's moments and its rows of the
global batch.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import (
    INPUT_SHAPES,
    GenerationConfig,
    InputShape,
    ModelConfig,
    default_skip_stages,
    get_config,
)
from repro_torch.core import prng
from repro_torch.core.engine import DiffusionEngine
from repro_torch.models.model import Model
from repro_torch.sharding import specs
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.train_step import TrainState, make_train_step

LONG_CTX_WINDOW = 8192
LONG_CTX_ANCHOR = 1024

# archs whose every attention layer is full (no native sub-quadratic path):
# long_500k uses the windowed variant for these
FULL_ATTN_ARCHS = {
    "qwen2-1.5b", "llama3-8b", "chatglm3-6b", "granite-moe-1b-a400m",
    "olmoe-1b-7b", "seamless-m4t-large-v2", "llama-3.2-vision-11b",
    "llada-8b", "dream-7b",
}


def dryrun_model_config(arch: str, *, dtype: str = "bfloat16") -> ModelConfig:
    return dataclasses.replace(get_config(arch), param_dtype=dtype, compute_dtype=dtype)


def serving_gen_config(cfg: ModelConfig, *, block_length: int = 64) -> GenerationConfig:
    """Paper defaults: r_{L/8} = r_{L/4} = 0.5 (where placeable)."""
    return GenerationConfig(
        gen_length=block_length * 4,
        block_length=block_length,
        mode="es",
        skip_stages=default_skip_stages(cfg.n_layers),
        prompt_refresh_period=64,
        block_refresh_period=4,
    )


def local_batch(shape: InputShape, mesh=None) -> int:
    """This rank's rows of the global batch (``specs.batch_spec``): ``B``
    over the batch axes where they divide it, else all ``B``."""
    b = (shape.global_batch,)
    return specs.local_shape(b, specs.batch_spec(b, mesh), mesh)[0]


def _engine_for(model: Model, shape: InputShape, gen: GenerationConfig,
                arch: str) -> DiffusionEngine:
    window = anchor = 0
    if shape.name == "long_500k" and arch in FULL_ATTN_ARCHS:
        window, anchor = LONG_CTX_WINDOW, LONG_CTX_ANCHOR
    return DiffusionEngine(model, gen, device=model.device, window_override=window,
                           anchor=anchor)


def _step_inputs(model: Model, shape: InputShape, arch: str, mesh, gen=None):
    gen = gen or serving_gen_config(model.cfg)
    eng = _engine_for(model, shape, gen, arch)
    b = local_batch(shape, mesh)
    state = eng.make_block_state(torch.zeros((b, shape.seq_len), dtype=torch.int32,
                                             device=model.device))
    # the first generated block: the prompt fills the rest of the sequence
    return eng, state, shape.seq_len - gen.gen_length


def make_serve_fn(model: Model, shape: InputShape, arch: str, *, mesh=None,
                  gen: GenerationConfig | None = None):
    """serve step: ONE ES decode iteration (skip decode) at block start
    ``bs``.  Returns ``(step_fn, (state, bs), engine)``."""
    eng, state, bs = _step_inputs(model, shape, arch, mesh, gen)
    return eng.decode_iteration, (state, bs), eng


def make_prefill_fn(model: Model, shape: InputShape, arch: str, *, mesh=None,
                    gen: GenerationConfig | None = None):
    """prefill step: the full forward that (re)builds every ES cache.  On
    the audio and vision archs it takes the stub frontend embeddings too,
    encodes them (``Model.encode``) and stores the cross planes; the serve
    step then reads those planes from the state."""
    eng, state, bs = _step_inputs(model, shape, arch, mesh, gen)
    cfg = model.cfg
    if cfg.family not in ("audio", "vlm"):
        return eng.prefill, (state, bs), eng

    def prefill_step(st, bs, enc_embeds):
        return eng.prefill(st._replace(enc_out=model.encode(enc_embeds)), bs)
    enc = torch.zeros((state.tokens.shape[0], cfg.n_enc_tokens, cfg.d_enc or cfg.d_model),
                      dtype=model.compute_dtype, device=model.device)
    return prefill_step, (state, bs, enc), eng


def make_train_fn(model: Model, shape: InputShape, *, mesh=None, ce_chunk: int = 256):
    """train step: the reference's ``make_train_fn``, ``OptimizerConfig()``,
    remat, CE chunks of ``ce_chunk`` (the sequence, where it is shorter).
    Returns ``(step_fn, (state, batch))``: the state holds the model (the
    rank's shards), zero moments of the shards' shapes and a key, the batch
    the rank's rows of the global one (``local_batch``), in the compute
    dtype for ``enc_embeds``."""
    cfg = model.cfg
    step = make_train_step(model, OptimizerConfig(), ce_chunk=min(ce_chunk, shape.seq_len),
                           remat=True, global_batch=shape.global_batch)
    state = TrainState(model, init_opt_state(model), prng.prng_key(0, device=model.device))
    b, l = local_batch(shape, mesh), shape.seq_len
    batch = {"tokens": torch.zeros((b, l), dtype=torch.int32, device=model.device),
             "loss_region": torch.zeros((b, l), dtype=torch.bool, device=model.device)}
    if cfg.family in ("audio", "vlm"):
        batch["enc_embeds"] = torch.zeros((b, cfg.n_enc_tokens, cfg.d_enc or cfg.d_model),
                                          dtype=model.compute_dtype, device=model.device)
    return step, (state, batch)


def input_specs(arch: str, shape_name: str, mesh=None, *, device: str | torch.device = "cuda", cfg: ModelConfig | None = None,
                shape: InputShape | None = None, gen: GenerationConfig | None = None,
                ce_chunk: int = 256):
    """Public entry: ``(step_fn, args, model)``, the model on ``device`` (a
    shard with ``mesh``: tensor-parallel to serve, FSDP x TP to train).
    ``cfg``, ``shape``, ``gen`` and ``ce_chunk`` replace the arch's bf16
    config, the named shape, the serving config and the train step's CE
    chunk (reduced runs).  Raises ``ValueError`` for head counts the mesh
    does not divide."""
    shape = shape or INPUT_SHAPES[shape_name]
    cfg = cfg or dryrun_model_config(arch)
    if shape.kind == "train":
        model = Model(cfg, device=device, mesh=mesh, mode="train")
        step, args = make_train_fn(model, shape, mesh=mesh, ce_chunk=ce_chunk)
        return step, args, model
    model = Model(cfg, device=device, mesh=mesh)
    make = make_prefill_fn if shape.kind == "prefill" else make_serve_fn
    step, args, _ = make(model, shape, arch, mesh=mesh, gen=gen)
    return step, args, model
