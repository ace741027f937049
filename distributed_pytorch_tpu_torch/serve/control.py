"""Control-plane policy: SLO classes.

Counterpart of the reference package's `serve/control.py`, cut to what the
port's scheduler reads. Every request is `interactive` or `batch`
(`ClassPolicy`): admission orders the queue interactive-first (FCFS within
a class), and under slot pressure live batch work is *voluntarily
preempted* through the engine's lossless preempt/requeue path — the
victim's generated-so-far tokens become its resume prompt, the retained
radix prefix makes re-admission a cache hit, and the stream continues.
Batch absorbs latency, never loss.

The reference's tenant fairness (`TokenBucketFairness`) and autoscaler
(`Autoscaler`, `FleetSample`, `ReplicaLauncher`) run in the router, and
come with the slice that ports it. Stdlib-only.
"""

from __future__ import annotations

from typing import Optional

from distributed_pytorch_tpu_torch.config import knob

#: the closed set of SLO classes; admission order is list order.
SLO_CLASSES = ("interactive", "batch")


def normalize_class(value: Optional[str],
                    default: Optional[str] = None) -> str:
    """Map a request's class field/header to a member of SLO_CLASSES.
    None/empty falls back to `default` (or the SLO_CLASS_DEFAULT knob);
    an unknown name raises ValueError so a typo is a 400, not a silent
    misclassification."""
    if not value:
        return default if default else knob("SLO_CLASS_DEFAULT")
    v = str(value).strip().lower()
    if v not in SLO_CLASSES:
        raise ValueError(f"unknown SLO class {value!r} "
                         f"(expected one of {SLO_CLASSES})")
    return v


# ----------------------------------------------------------------------
# SLO-class admission + preemption policy
# ----------------------------------------------------------------------

class ClassPolicy:
    """Pure ordering/selection rules for class-aware scheduling. The
    scheduler owns the queue and the engine; this object only answers
    *where* a request goes and *who* gets preempted, so the identical
    rules run against the simulator's queues."""

    #: numeric admission rank (lower admits first)
    RANK = {c: i for i, c in enumerate(SLO_CLASSES)}

    @classmethod
    def insert_index(cls, queue, slo_class: str,
                     resumed: bool = False) -> int:
        """Index at which a request of `slo_class` enters `queue` (a
        sequence of objects with .slo_class / .resumed). The invariant
        maintained: interactive section first, then batch, FCFS within
        a section — except resumed requests, which go to the FRONT of
        their class section (they are mid-stream; within the resumed
        group original order is preserved by inserting after earlier
        resumes). A preempted batch request therefore re-queues AHEAD
        of queued batch work but BEHIND every waiting interactive
        request — it can never immediately re-steal the slot it was
        evicted from."""
        rank = cls.RANK[slo_class]
        i = 0
        for i, req in enumerate(queue):
            r_rank = cls.RANK.get(getattr(req, "slo_class", SLO_CLASSES[0]),
                                  0)
            if r_rank > rank:
                return i
            if r_rank == rank and resumed \
                    and not getattr(req, "resumed", False):
                return i
        return len(queue)

    @staticmethod
    def queued_interactive(queue) -> int:
        return sum(1 for r in queue
                   if getattr(r, "slo_class", "interactive")
                   == "interactive")

    @staticmethod
    def preempt_count(n_interactive_queued: int, n_free_slots: int,
                      n_live_batch: int) -> int:
        """How many live batch requests to evict so every queued
        interactive request can reach a slot: the interactive backlog
        not covered by free slots, capped by the evictable population.
        Zero whenever free slots cover the backlog — preemption is the
        pressure valve, never the steady state."""
        return max(0, min(n_live_batch,
                          n_interactive_queued - n_free_slots))

    @staticmethod
    def pick_victims(live_batch, k: int) -> list:
        """Choose `k` victims among live batch requests: most recently
        admitted first (ties: fewest tokens served), so the work
        discarded-and-resumed is the work with the least decode
        progress sunk into its slot."""
        ranked = sorted(
            live_batch,
            key=lambda r: (-(getattr(r, "admitted_at", 0.0) or 0.0),
                           getattr(r, "served", 0)))
        return ranked[:max(0, k)]
