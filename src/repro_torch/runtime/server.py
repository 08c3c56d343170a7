"""The lock-step micro-batching server of the port: the counterpart of the
reference's ``repro.runtime.server``.

Requests queue up, are left-padded and stacked into ``[B, P]`` prompt
batches, and each batch runs one offline ``DiffusionEngine.generate``
(paper §6.1 serves at a fixed batch of 8 "for better weight reuse").  The
tail batch is padded by repeating its last request; only real requests get
an output and count in ``stats``, whose ``tps`` is Table 1's metric.

As in the reference, no ``prompt_start`` is passed, so the left pad rows
are attended, and each batch's sample seeds are the row indices; the base
key of batch ``n`` is the second half of the ``n``-th ``prng.split`` of
``prng_key(seed)``.  Batches are modality-homogeneous, as the reference's:
requests whose ``enc_embeds`` presence differs from the queue head's wait
for a later batch, and an encoder arch's batch is encoded once by its
``generate``.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.configs.base import GenerationConfig
from repro_torch.core import prng
from repro_torch.core.engine import DiffusionEngine
from repro_torch.models.model import Model
from repro_torch.runtime.request import Request, pad_and_stack


@dataclasses.dataclass
class ServerStats:
    requests: int = 0
    tokens_generated: int = 0
    wall_s: float = 0.0

    @property
    def tps(self) -> float:
        return self.tokens_generated / self.wall_s if self.wall_s else 0.0


class BatchServer:
    def __init__(
        self,
        model: Model,
        gen: GenerationConfig,
        *,
        batch_size: int = 8,
        prompt_len: int = 64,
        pad_id: int = 0,
        seed: int = 0,
        **engine_kw,
    ):
        self.model = model
        self.gen = gen
        self.batch_size = batch_size
        self.prompt_len = prompt_len
        self.pad_id = pad_id
        self.engine = DiffusionEngine(model, gen, **engine_kw)
        self.key = prng.prng_key(seed)
        self.queue: list[Request] = []
        self.stats = ServerStats()
        self.batch_wall_s: list[float] = []      # wall seconds of each batch, in order

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def step(self) -> list[Request]:
        """Serves one batch from the queue: the first ``batch_size`` requests
        whose ``enc_embeds`` presence matches the head's, the tail batch
        padded by repeating its last request; returns the batch's real
        requests."""
        if not self.queue:
            return []
        head_has_enc = self.queue[0].enc_embeds is not None
        batch, rest = [], []
        for r in self.queue:
            if len(batch) < self.batch_size and (r.enc_embeds is not None) == head_has_enc:
                batch.append(r)
            else:
                rest.append(r)
        self.queue = rest
        real = len(batch)
        batch += [batch[-1]] * (self.batch_size - real)
        prompts = torch.from_numpy(pad_and_stack(batch, self.pad_id, self.prompt_len))
        enc = None
        if head_has_enc:
            enc = torch.stack([torch.as_tensor(r.enc_embeds, dtype=torch.float32)
                               for r in batch])
        self.key, sub = prng.split(self.key)
        t0 = time.time()
        tokens = self.engine.generate(prompts, enc_embeds=enc, key=sub).cpu().numpy()
        dt = time.time() - t0
        for i, req in enumerate(batch[:real]):
            req.output = tokens[i, self.prompt_len:]
            req.latency_s = dt
        self.stats.requests += real
        self.stats.tokens_generated += real * self.gen.gen_length
        self.stats.wall_s += dt
        self.batch_wall_s.append(dt)
        return batch[:real]

    def drain(self) -> list[Request]:
        done = []
        while self.queue:
            done.extend(self.step())
        return done
