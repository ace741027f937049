"""Step-level flight recorder: the engine's always-on black box.

The serving histograms (serve/metrics.py) answer "what were the
quantiles"; they cannot answer "what happened around 14:03:07 when ITL
p99 spiked". The flight recorder can: every fused step appends one
compact record — `{step, step_ms, n_live, prefill_tokens, emitted,
blocks_in_use, preemptions}` — to a bounded ring, so the last few
thousand steps are always reconstructable, at the cost of one dict
append per multi-millisecond device step. Served live at
`GET /debug/timeline` (serve/server.py) and dumped to `runs/*.jsonl` by
the bench legs and the fault-injection harness for post-hoc analysis
against the PERF.md latency models.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Optional


class FlightRecorder:
    """Thread-safe bounded ring of per-step records.

    >>> fl = FlightRecorder(capacity=4096)
    >>> fl.record(step=1, step_ms=3.7, n_live=8)
    >>> fl.entries(n=100)       # the last 100 steps
    >>> fl.dump_jsonl("runs/serve/timeline.jsonl")
    """

    def __init__(self, capacity: int = 4096, enabled: bool = True):
        self.capacity = capacity
        self.enabled = enabled
        self.dropped = 0           # records evicted off the ring's back
        self.total = 0             # records ever written
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        # one wall-clock read at construction anchors the timeline to
        # absolute time (so `t` still correlates with server logs and
        # Prometheus scrapes); per-record stamps advance MONOTONICALLY
        # from it, so an NTP slew mid-run can never make step timestamps
        # jump backwards or overlap
        self._wall0 = time.time()  # lint: allow(wall-clock)
        self._mono0 = time.monotonic()

    def record(self, **fields) -> None:
        """Append one step record, stamped with `t` = the construction
        wall-clock anchor plus a monotonic delta."""
        if not self.enabled:
            return
        fields["t"] = round(self._wall0 + (time.monotonic() - self._mono0), 4)
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self.total += 1
            self._ring.append(fields)

    def __len__(self) -> int:
        return len(self._ring)

    def entries(self, n: Optional[int] = None) -> list[dict]:
        """The last `n` records (all retained when None), oldest first."""
        with self._lock:
            out = list(self._ring)
        return out if n is None else out[-n:]

    def dump_jsonl(self, path: str) -> str:
        """Write every retained record as JSONL; returns the path."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            for rec in self.entries():
                f.write(json.dumps(rec) + "\n")
        return path
