"""Collective and cost accounting of the dry run, the counterpart of
``repro/utils/hlo.py``.

The reference parses compiled HLO text for its collectives' result bytes,
since ``cost_analysis()`` leaves them out.  Eager PyTorch has no HLO: the
port's collectives are its own calls (``sharding/comm.py``: all-reduces,
and a train step's all-gathers and reduce-scatters), counted as they are
made, and ``CommDebugMode`` counts the ``c10d`` ops that reach the process
group.  ``CollectiveStats`` keeps the reference's fields and
``as_dict()``.  ``cost_dict`` gives the FLOPs of one step: the matmuls that
``FlopCounterMode`` counts plus the hand-written kernels' work, which the
kernel ops tally on fake tensors (``kernels/fake.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class CollectiveStats:
    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())

    def as_dict(self) -> dict:
        return {
            "total_bytes": self.total_bytes,
            "total_count": self.total_count,
            "bytes_by_kind": dict(self.bytes_by_kind),
            "count_by_kind": dict(self.count_by_kind),
        }


def collective_stats(counter, comm_mode=None) -> CollectiveStats:
    """Stats from ``comm.COUNTER`` (bytes and calls by kind).  With a
    ``CommDebugMode`` that watched the same calls, its count of ``c10d``
    collectives must agree: a collective made outside ``sharding/comm.py``
    raises."""
    stats = CollectiveStats(dict(counter.bytes_by_kind), dict(counter.count_by_kind))
    if comm_mode is not None:
        seen = comm_mode.get_total_counts()
        if seen != stats.total_count:
            raise AssertionError(f"{seen} collectives reached the process group, "
                                 f"{stats.total_count} through sharding.comm")
    return stats


def cost_dict(flop_counter, tally, op_bytes: float = 0.0) -> dict:
    """``{"flops", "bytes accessed"}`` of one step (the keys of the
    reference's ``cost_analysis_dict``): the counted matmul FLOPs plus the
    kernels' tallied FLOPs; the operands and results of every other op
    (``op_bytes``) plus the kernels' tallied bytes."""
    return {"flops": float(flop_counter.get_total_flops()) + tally.total("flops"),
            "bytes accessed": float(op_bytes) + tally.total("bytes")}
