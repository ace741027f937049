"""Structured span/event recorder for end-to-end request tracing.

Design constraints (with tracing disabled the serve hot path must be
indistinguishable from the recorder compiled out):

* **Near-zero overhead when disabled**: every public entry point checks
  one attribute and returns; `span()` hands back a shared no-op context
  manager, so a disabled recorder costs one attribute load + one branch
  per call site. Nothing is allocated, nothing is locked.
* **Hot-path discipline when enabled**: the serving layers record spans
  at TERMINAL events (retire/shed/failover), computed from timestamps
  they already collect for the latency histograms — per-token work gains
  no recorder calls either way.
* **Thread-safe bounded ring**: spans land in a `deque(maxlen=capacity)`
  under a lock (the scheduler's event loop and the engine's executor
  thread both record); old spans fall off the back, `dropped` counts
  them. Monotonic clocks (`time.perf_counter`) order everything recorded
  in one process; cross-process stitching re-bases on the dispatcher's
  clock (serve/router.py).
* **Two export formats**: Chrome-trace JSON (`to_chrome()` — load in
  Perfetto / chrome://tracing) and JSONL (`dump_jsonl()` — grep/pandas).

A span is a plain dict:
    {"trace": id, "span": n, "parent": n|None, "name": str, "cat": str,
     "t0": perf_counter_seconds, "dur": seconds, "attrs": {...}}
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import uuid
from typing import Optional

TRACE_HEADER = "X-Trace-Id"


def new_trace_id() -> str:
    """16-hex-char request trace id (uuid4-derived, collision-safe at
    serving volumes, short enough for log lines and headers)."""
    return uuid.uuid4().hex[:16]


class _NullSpan:
    """The disabled-mode span: a shared, stateless context manager."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    """A live (entered, not yet recorded) span."""

    __slots__ = ("_rec", "name", "trace", "parent", "cat", "attrs", "t0")

    def __init__(self, rec: "TraceRecorder", name: str, trace: str,
                 parent: Optional[int], cat: str, attrs: dict):
        self._rec = rec
        self.name = name
        self.trace = trace
        self.parent = parent
        self.cat = cat
        self.attrs = attrs
        self.t0 = time.perf_counter()

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, *exc) -> bool:
        self._rec.add(self.name, self.trace,
                      t0=self.t0, dur=time.perf_counter() - self.t0,
                      parent=self.parent, cat=self.cat, **self.attrs)
        return False


class TraceRecorder:
    """Thread-safe bounded span ring with Perfetto/JSONL export.

    >>> rec = TraceRecorder()
    >>> tid = new_trace_id()
    >>> with rec.span("prefill", tid, cat="sched", bucket=64):
    ...     run_prefill()
    >>> rec.spans_for(tid)
    [{'name': 'prefill', ...}]
    """

    def __init__(self, capacity: int = 8192, enabled: bool = True):
        self.capacity = capacity
        self.enabled = enabled
        self.dropped = 0          # spans evicted off the ring's back
        self._spans: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._next = 1

    # ------------------------------------------------------------------
    # recording
    # ------------------------------------------------------------------

    def add(self, name: str, trace: Optional[str], *, t0: float,
            dur: float, parent: Optional[int] = None, cat: str = "",
            **attrs) -> Optional[int]:
        """Record one finished span. No-op (None) when disabled or when
        the event has no trace id to hang from."""
        if not self.enabled or trace is None:
            return None
        with self._lock:
            sid = self._next
            self._next += 1
            if len(self._spans) == self.capacity:
                self.dropped += 1
            self._spans.append({"trace": trace, "span": sid,
                                "parent": parent, "name": name, "cat": cat,
                                "t0": t0, "dur": dur, "attrs": attrs})
            return sid

    def event(self, name: str, trace: Optional[str], *, cat: str = "",
              t: Optional[float] = None, parent: Optional[int] = None,
              **attrs) -> Optional[int]:
        """Record an instant (zero-duration) event on a trace."""
        if not self.enabled or trace is None:
            return None
        return self.add(name, trace, t0=time.perf_counter() if t is None
                        else t, dur=0.0, parent=parent, cat=cat, **attrs)

    def span(self, name: str, trace: Optional[str], *,
             parent: Optional[int] = None, cat: str = "", **attrs):
        """Context manager measuring a code region. Disabled (or
        trace-less) recorders hand back a shared no-op."""
        if not self.enabled or trace is None:
            return _NULL_SPAN
        return _Span(self, name, trace, parent, cat, attrs)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    # ------------------------------------------------------------------
    # reading
    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._spans)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._spans)

    def spans_for(self, trace: str) -> list[dict]:
        """All recorded spans of one trace, in t0 order."""
        return sorted((s for s in self.snapshot() if s["trace"] == trace),
                      key=lambda s: s["t0"])

    def summary(self, trace: str,
                base: Optional[float] = None) -> list[dict]:
        """Compact per-request span list for completion payloads and
        cross-process stitching: offsets in ms relative to `base` (the
        trace's earliest span when omitted), so the receiving process can
        re-base them onto its own clock."""
        spans = self.spans_for(trace)
        if not spans:
            return []
        if base is None:
            base = spans[0]["t0"]
        return [{"name": s["name"], "cat": s["cat"],
                 "off_ms": round((s["t0"] - base) * 1e3, 3),
                 "dur_ms": round(s["dur"] * 1e3, 3),
                 "attrs": s["attrs"]} for s in spans]

    def ingest(self, trace: str, summary: list[dict], *, base: float,
               **extra_attrs) -> None:
        """Record a peer process's `summary()` spans onto this recorder,
        re-based at `base` on THIS process's monotonic clock (the router
        uses its dispatch timestamp) — a failed-over stream stitches into
        one timeline this way."""
        if not self.enabled:
            return
        for s in summary:
            try:
                self.add(s.get("name", "?"), trace,
                         t0=base + float(s.get("off_ms", 0.0)) / 1e3,
                         dur=float(s.get("dur_ms", 0.0)) / 1e3,
                         cat=s.get("cat", ""),
                         **{**s.get("attrs", {}), **extra_attrs})
            except (TypeError, ValueError):
                continue          # a malformed peer span never poisons us

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------

    def to_chrome(self, trace: Optional[str] = None) -> dict:
        """Chrome trace event format (the JSON Perfetto and
        chrome://tracing open directly): one complete ('X') event per
        span, timestamps in microseconds, grouped on one pid with a
        thread track per category so router/sched/engine lanes stack."""
        spans = self.spans_for(trace) if trace else \
            sorted(self.snapshot(), key=lambda s: s["t0"])
        tids: dict[str, int] = {}
        events = []
        for s in spans:
            lane = s["cat"] or "main"
            tid = tids.setdefault(lane, len(tids))
            events.append({"name": s["name"], "ph": "X", "cat": lane,
                           "pid": 0, "tid": tid,
                           "ts": round(s["t0"] * 1e6, 3),
                           "dur": round(s["dur"] * 1e6, 3),
                           "args": {"trace": s["trace"], **s["attrs"]}})
        meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                 "args": {"name": lane}} for lane, tid in tids.items()]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def dump_jsonl(self, path: str, trace: Optional[str] = None) -> str:
        """One span per line (ring order); returns the path written."""
        spans = self.spans_for(trace) if trace else self.snapshot()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            for s in spans:
                f.write(json.dumps(s) + "\n")
        return path


# ----------------------------------------------------------------------
# process-wide default recorder (the serving layers share one ring so a
# request's router/scheduler/server spans land in the same place)
# ----------------------------------------------------------------------

from distributed_pytorch_tpu_torch import config as _config

_default = TraceRecorder(
    capacity=_config.knob("TRACE_CAPACITY"),
    enabled=_config.knob("TRACE"))


def get_recorder() -> TraceRecorder:
    return _default


def set_recorder(rec: TraceRecorder) -> TraceRecorder:
    """Swap the process default (tests install a fresh ring)."""
    global _default
    _default = rec
    return rec
