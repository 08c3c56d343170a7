"""Typed serving errors of the port: a copy of the reference's ``repro.runtime.errors``.

Every failure the runtime can survive is surfaced as a distinct exception
type so callers can pattern-match on outcomes instead of parsing assertion
strings:

  * ``ConfigError``       — rejected flag/kwarg combination, raised upfront
                            before any device work.
  * ``LedgerError``       — allocator bookkeeping corruption (double release,
                            negative refcount, share-after-free).  Always a
                            bug, never a load condition.
  * ``DeadlineUnmeetable``— SLO admission verdict: the request cannot finish
                            inside its ``deadline_s`` given the measured
                            per-step cost.  Stored on ``Request.error``.
  * ``PoisonedRequest``   — the request produced non-finite activations
                            and was quarantined.  Stored on
                            ``Request.error``.
  * ``DrainStalled``      — the drain watchdog detected zero forward
                            progress (or blew its step/wall budget); names
                            the stuck slots and their phases.
"""
from __future__ import annotations


class SchedulerError(Exception):
    """Base class for every typed serving-runtime error."""


class ConfigError(SchedulerError, ValueError):
    """Invalid or incompatible configuration, rejected before any work."""


class LedgerError(SchedulerError):
    """Page-allocator claim ledger corruption (double release,
    negative refcount, share-after-free)."""


class DeadlineUnmeetable(SchedulerError):
    """SLO admission verdict: the request cannot meet ``deadline_s``.

    Attached to ``Request.error``; the request is retired unserved
    (``output`` stays ``None``) and counted in ``deadline_rejects``.
    """

    def __init__(self, request_id: int, deadline_s: float,
                 waited_s: float, estimate_s: float):
        self.request_id = request_id
        self.deadline_s = deadline_s
        self.waited_s = waited_s
        self.estimate_s = estimate_s
        super().__init__(
            f"request {request_id}: deadline {deadline_s:.3f}s unmeetable "
            f"(waited {waited_s:.3f}s, estimated service {estimate_s:.3f}s)")


class PoisonedRequest(SchedulerError):
    """The request produced non-finite logits/hidden state and was
    quarantined: retired unserved, its slot reset and its private pages
    scrubbed.  Attached to ``Request.error`` and counted in
    ``poisoned_requests``."""

    def __init__(self, request_id: int, slot: int, step: int):
        self.request_id = request_id
        self.slot = slot
        self.step = step
        super().__init__(
            f"request {request_id}: non-finite activations detected in "
            f"slot {slot} at scheduler step {step}")


class DrainStalled(SchedulerError):
    """``drain()`` made no forward progress (or exceeded its budget).

    ``slots`` is a list of ``(slot, request_id, phase, blocks_left)``
    tuples for every stuck resident at the time the watchdog fired, each
    led by its shard index under ``ShardedStreamScheduler`` (the
    reference's message formatting expects four fields and raises
    ``ValueError`` on the sharded form; the port names the shard).
    """

    def __init__(self, reason: str, slots: list[tuple[int, ...]]):
        self.reason = reason
        self.slots = slots
        stuck = ", ".join(
            ("" if len(t) == 4 else f"shard {t[0]} ")
            + "slot {} (req {}, phase {}, blocks_left {})".format(*t[-4:])
            for t in slots) or "no residents"
        super().__init__(f"drain stalled: {reason}; stuck: {stuck}")
