"""Training step of the port, the reference's ``repro/train/train_step.py``:
the diffusion loss, its backward pass and an AdamW step on the model's
parameters in place, on one card or over a ``(data, model)`` or ``(pod,
data, model)`` mesh (FSDP x TP, ``sharding/fsdp.py``)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import prng
from repro_torch.models.model import Model
from repro_torch.train.loss import diffusion_loss
from repro_torch.train.optimizer import OptimizerConfig, OptState, adamw_update, init_opt_state


class TrainState(NamedTuple):
    model: Model          # the parameters, updated in place
    opt: OptState
    key: torch.Tensor     # raw threefry key [2] (core/prng.py)


def init_train_state(model: Model, key: torch.Tensor) -> TrainState:
    """Splits ``key`` as the reference does: ``k1`` initialises the model,
    ``k2`` is the state's key.  ``Model.init`` draws torch's numbers from a
    generator seeded with ``k1``'s words, so the values differ from the
    reference's ``model.init(k1)``; parity runs load the reference's
    parameters through ``convert.params_from_numpy`` instead.  Turns the
    model's grads on."""
    k1, k2 = prng.split(key)
    seed = (int(k1[0]) << 32) | int(k1[1])
    model.init(torch.Generator(device=model.device).manual_seed(seed))
    model.requires_grad_(True)
    return TrainState(model, init_opt_state(model), k2.to(model.device))


def make_train_step(model: Model, opt_cfg: OptimizerConfig, *, ce_chunk: int = 256,
                    remat: bool = True, global_batch: Optional[int] = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.  ``batch`` is
    ``{tokens [B, L] int32, loss_region [B, L] bool, optional enc_embeds [B,
    E, d_enc]}`` as numpy arrays or tensors; the metrics (``loss``, ``ce``,
    ``aux``, ``mask_frac``, ``lr``, ``grad_norm``) are 0-dim tensors.

    A model with a mesh (``Model(cfg, mesh=..., mode="train")``: FSDP over
    ``data`` x TP over ``model``, ``sharding/fsdp.py``) trains the same
    step: the batch arrives global and each rank takes its rows
    (``specs.batch_spec``), or, with ``global_batch``, it holds the rank's
    rows of a global batch of that many; the gradients reach each rank's
    shards reduced over the ranks that share them, the clip takes the norm
    of the whole gradient tree, and AdamW updates the rank's shards of the
    parameters and moments.  The metrics are the global batch's, equal on
    every rank."""
    model.requires_grad_(True)
    dp = model.dp

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        key, sub = prng.split(state.key.to(model.device))
        inputs = {k: torch.as_tensor(v, device=model.device) for k, v in batch.items()}
        rows = None
        if dp is not None and global_batch is not None:
            rows = (dp.rows(global_batch).start, global_batch)
        for p in model.parameters():
            p.grad = None
        with torch.enable_grad():
            objective, metrics = diffusion_loss(
                model, sub, inputs["tokens"], inputs["loss_region"],
                enc_embeds=inputs.get("enc_embeds"), ce_chunk=ce_chunk, remat=remat, rows=rows)
            objective.backward()
        opt, opt_metrics = adamw_update(opt_cfg, model, state.opt)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return TrainState(model, opt, key), dict(metrics, **opt_metrics)

    return train_step
