"""Async request scheduler: the online layer that keeps the DecodeEngine's
slot cache full under ragged arrivals.

Orca-style continuous batching (PAPERS.md) only pays off when admissions
and retirements interleave with decoding — the decode engine gives the
device side (one fused step for every live slot, O(1) slot reuse); this
module gives the host side:

* **Bounded FCFS admission queue**: `submit()` either enqueues or raises
  `ShedError` — backpressure is an explicit error at the edge, never a
  silent drop or an unbounded queue. Per-request `deadline_s` bounds the
  QUEUE WAIT: a request that can't reach a slot in time is shed with a
  'deadline' cause instead of burning a slot on an answer nobody is
  waiting for. Only the FIRST admission is deadline-bound — a
  preemption-requeued request is already streaming and is never shed.
* **Bucket-grouped admission waves**: each scheduling pass fills every
  free slot from the queue head (FCFS — a stream of short requests can
  never starve an earlier long one, the property tests/test_serve.py
  pins). WITHIN a wave, prompts are stably sorted by their pow2 prefill
  bucket so same-bucket prefills run back-to-back on one compiled trace
  (`DecodeEngine.prefill_bucket`; the engine compiles one prefill per
  bucket, so grouping maximizes warm-trace reuse without reordering
  across waves). With a CHUNKED engine (`prefill_chunk > 0`) admission
  is bookkeeping only — no prefill runs, no bucket traces exist — so the
  wave stays pure FCFS and the prompt chunks into subsequent fused steps
  under the engine's token budget (decode tokens keep strict priority;
  the request's first token arrives via `StepResult.emitted` when its
  last chunk runs). TTFT is therefore observed when the FIRST TOKEN is
  pushed, not at admission — identical timing in wave mode, and the only
  correct point in chunked mode.
* **One background step loop**: a single task owns the engine; every
  engine call (admit/step) runs in a one-thread executor so a ~ms fused
  step never blocks the event loop's HTTP writes. Tokens fan out to
  per-request `asyncio.Queue` streams (`RequestHandle` async-iterates
  them); retirement reasons ride the final event.
* **Cancellation**: `RequestHandle.cancel()` (the server calls it on
  client disconnect) flags the request; the loop applies
  `engine.cancel()` before the next step, so a cancelled request's slot
  is free within one fused step. Queued requests are cancelled in place
  without ever touching the engine.
* **Preemption requeues, admission waits**: the paged engine retires a
  sequence with reason 'preempted' when the block pool runs dry mid-
  decode — the loop resubmits it at the queue HEAD (everything generated
  so far becomes the new prompt; the retained prefix blocks make the
  re-prefill a prefix-cache hit, and the stream just keeps going), so
  preemption is never user-visible loss. `NoFreeBlocks` at admission
  leaves the request queued until a retirement frees blocks — shed stays
  reserved for admission-bound overflow (queue_full/deadline/shutdown).

* **Fail loud, drain clean**: an exception escaping the step
  loop fails EVERY pending handle with an `EngineError` (never a hung
  stream), flips `healthy` False (`/healthz` -> 503) and sheds all later
  submits — the health-gated router's signal to fail the replica out and
  re-drive its streams elsewhere. `drain()` is the graceful half: stop
  admission (shed cause 'draining'), let queued requests reach slots and
  live streams retire, then hand the port to a replacement process.

Threading contract: `submit`/`cancel` must be called on the event loop
(the HTTP server does); only the background loop touches the engine, and
it serializes admits/steps through the executor, so the engine never sees
concurrent calls.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import dataclasses
import time
from typing import Optional

from distributed_pytorch_tpu_torch.config import knob
from distributed_pytorch_tpu_torch.engine.decode import Retired
from distributed_pytorch_tpu_torch.obs import trace as obs_trace
from distributed_pytorch_tpu_torch.ops.block_pool import NoFreeBlocks
from distributed_pytorch_tpu_torch.serve.control import (ClassPolicy,
                                                         normalize_class)
from distributed_pytorch_tpu_torch.serve.metrics import (ServeMetrics,
                                                         engine_build_info)


class ShedError(RuntimeError):
    """Admission control rejected/evicted the request (queue_full |
    deadline | shutdown | draining | engine_error | rate_limited |
    preempted_batch_timeout). Surfaces as HTTP 429/503 — never a
    hang."""

    def __init__(self, cause: str, msg: str):
        super().__init__(msg)
        self.cause = cause


class EngineError(RuntimeError):
    """The background step loop died: the engine raised, every pending
    stream is failed with THIS error (never left hanging), `/healthz`
    flips to 503, and later submits shed — the router's cue to fail the
    replica out and re-drive its in-flight requests elsewhere."""

    cause = "engine_error"

    def __init__(self, original: BaseException):
        super().__init__(f"engine step loop died: {original!r}")
        self.original = original


@dataclasses.dataclass
class _Request:
    prompt: list
    max_new: int                  # budget for the NEXT admission
    deadline_s: Optional[float]
    submitted_at: float
    handle: "RequestHandle"
    seq_id: Optional[int] = None
    admitted_at: Optional[float] = None
    last_tok_at: Optional[float] = None
    cancelled: bool = False
    # preemption-resume bookkeeping: the caller-visible prompt length and
    # total budget never change; `resumed` marks re-admissions (their
    # queue wait is not a TTFT, and they are exempt from deadline shed —
    # their tokens are already streaming). `served` counts tokens PUSHED
    # to the handle — the scheduler-paced generated count; handle.tokens
    # is consumer-paced and lags it, so budgets must never read that.
    orig_prompt_len: int = 0
    budget_total: int = 0
    resumed: bool = False
    served: int = 0
    # request tracing (obs/trace.py): the X-Trace-Id the server parsed
    # (or minted); spans are emitted at TERMINAL events from timestamps
    # the latency histograms already collect, so tracing adds nothing to
    # the per-token path. first_tok_at splits prefill from decode;
    # adm_prefix/adm_prefilled are the last admission's cache accounting.
    trace_id: Optional[str] = None
    first_tok_at: Optional[float] = None
    adm_prefix: int = 0
    adm_prefilled: int = 0
    # SLO class (serve/control.py): admission orders interactive ahead
    # of batch, and under slot pressure live batch work is voluntarily
    # preempted through the lossless requeue path. preempted_at stamps
    # the LAST preemption — the clock the optional
    # preempted_batch_timeout shed runs against.
    slo_class: str = "interactive"
    preempted_at: Optional[float] = None


class RequestHandle:
    """Caller-side view of one request: async-iterate the generated token
    ids as they stream; `cancel()` to abandon; `await result()` to drain
    to the final `Retired` record.

    >>> handle = scheduler.submit(prompt_ids, max_new_tokens=64)
    >>> async for tok in handle: ...
    >>> handle.retired.reason   # 'eos' | 'budget' | 'cache_full' | ...
    """

    def __init__(self, scheduler: "Scheduler", req: "_Request"):
        self._scheduler = scheduler
        self._req = req
        self._events: asyncio.Queue = asyncio.Queue()
        self.tokens: list[int] = []        # generated tokens streamed so far
        self.retired: Optional[Retired] = None
        self.error: Optional[BaseException] = None

    # -- scheduler side -------------------------------------------------
    def _push_token(self, tok: int) -> None:
        self._req.served += 1
        self._events.put_nowait(("token", tok))

    def _push_done(self, ret: Retired) -> None:
        self.retired = ret
        self._scheduler._pending.discard(self)
        self._events.put_nowait(("done", ret))

    def _push_error(self, exc: BaseException) -> None:
        self.error = exc
        self._scheduler._pending.discard(self)
        self._events.put_nowait(("error", exc))

    # -- caller side ----------------------------------------------------
    @property
    def submitted_at(self) -> float:
        return self._req.submitted_at

    @property
    def admitted_at(self) -> Optional[float]:
        """perf_counter timestamp of slot admission (None while queued)."""
        return self._req.admitted_at

    def cancel(self) -> None:
        """Abandon the request. A queued request shreds in place; a live
        one has its slot freed before the next fused step."""
        self._scheduler._request_cancel(self._req)

    def __aiter__(self) -> "RequestHandle":
        return self

    async def __anext__(self) -> int:
        while True:
            if self._events.empty():
                if self.retired is not None or self.error is not None:
                    raise StopAsyncIteration
            kind, val = await self._events.get()
            if kind == "token":
                self.tokens.append(val)
                return val
            if kind == "error":
                raise val
            raise StopAsyncIteration          # kind == "done"

    async def result(self) -> Retired:
        """Drain the stream; return the final `Retired` (raises the shed /
        scheduler error when the request never finished)."""
        async for _ in self:
            pass
        assert self.retired is not None
        return self.retired


class Scheduler:
    """Owns a `DecodeEngine` and serves it to concurrent async callers.

    >>> sched = Scheduler(engine, max_queue=128)
    >>> await sched.start()
    >>> handle = sched.submit([1, 2, 3], max_new_tokens=32)
    >>> async for tok in handle: ...
    >>> await sched.stop()
    """

    def __init__(self, engine, *, max_queue: int = 128,
                 metrics: Optional[ServeMetrics] = None,
                 default_deadline_s: Optional[float] = None,
                 batch_resume_timeout_s: Optional[float] = None):
        self.engine = engine
        self.max_queue = max_queue
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.default_deadline_s = default_deadline_s
        # 0 = never: a preempted batch stream waits out any interactive
        # burst and resumes losslessly; > 0 bounds that wait, shedding
        # with the distinct cause the router exempts from retry_budget
        self.batch_resume_timeout_s = (
            batch_resume_timeout_s if batch_resume_timeout_s is not None
            else knob("SLO_BATCH_RESUME_TIMEOUT_S"))
        self._queue: collections.deque[_Request] = collections.deque()
        self._live: dict[int, _Request] = {}       # seq_id -> request
        self._cancel_live: list[_Request] = []     # applied between steps
        # EVERY handle that has not yet seen done/error, including those
        # popped into a wave-local list mid-admission — the crash guard
        # iterates this, so no stream can hang on a loop death
        self._pending: set[RequestHandle] = set()
        self._wake = asyncio.Event()
        self._exec = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="decode")
        self._task: Optional[asyncio.Task] = None
        self._stopping = False
        self._draining = False
        self._failed: Optional[EngineError] = None
        self.metrics.register_gauge(
            "serve_queue_depth", lambda: len(self._queue),
            "requests waiting for a slot")
        self.metrics.register_gauge(
            "serve_slot_occupancy", lambda: self.engine.occupancy,
            "live fraction of the engine's slot cache")
        self.metrics.register_gauge(
            "serve_slots_free", lambda: self.engine.n_free,
            "free decode slots")
        # paged-cache observability (engine/decode.py properties): how full
        # the block pool runs, how much of it is partial-tail waste, and
        # how often prompts resolve to cached prefix blocks
        self.metrics.register_gauge(
            "serve_block_utilization", lambda: self.engine.block_utilization,
            "referenced fraction of the KV block pool")
        self.metrics.register_gauge(
            "serve_block_fragmentation",
            lambda: self.engine.block_fragmentation,
            "unwritten fraction of referenced KV block rows")
        self.metrics.register_gauge(
            "serve_prefix_hit_rate", lambda: self.engine.prefix_hit_rate,
            "lifetime fraction of prompt tokens served from cached blocks")
        # retrace guards (obs/retrace.py): total compiled traces and the
        # over-budget excess per program family — excess > 0 means the
        # one-trace serving invariant broke (the silent recompile cliff)
        self.metrics.register_gauge(
            "serve_engine_traces_total",
            lambda: sum(g.count for g in self.engine.trace_guards.values()),
            "compiled engine program traces across step/fused_step/admit")
        self.metrics.register_gauge(
            "serve_engine_retrace_excess",
            lambda: sum(g.excess for g in self.engine.trace_guards.values()),
            "engine traces past budget — should be 0")
        # speculative decoding (engine/decode.py): what fraction of
        # drafted tokens the verify step accepted, and how many tokens
        # each fused step delivered on average (1.0 with spec off)
        self.metrics.register_gauge(
            "serve_spec_accepted_token_rate",
            lambda: getattr(self.engine, "accepted_token_rate", 0.0),
            "accepted/drafted fraction of speculative draft tokens")
        self.metrics.register_gauge(
            "serve_engine_tokens_per_step",
            lambda: getattr(self.engine, "tokens_per_step", 1.0),
            "mean tokens emitted per fused step (spec decode > 1)")
        # host-RAM KV tier (ops/kv_tier.py via engine.host_tier): live
        # occupancy/save-rate gauges here, block-movement counters
        # delta-synced in _tier_sync() after every engine call. Tier
        # promotes run inside admit() — BEFORE queue_wait is observed —
        # so promote latency lands in queue-wait, never in ITL.
        self.metrics.register_gauge(
            "serve_kv_host_tier_occupancy",
            lambda: getattr(self.engine, "host_tier_occupancy", 0.0),
            "resident fraction of the host-RAM KV tier's block budget")
        self.metrics.register_gauge(
            "serve_kv_host_tier_hit_rate",
            lambda: getattr(self.engine, "host_tier_hit_rate", 0.0),
            "fraction of tier probes (after an HBM radix miss) served "
            "from host RAM")
        self._tier_seen = {"demoted": 0, "promoted": 0, "dropped": 0}
        # AOT program store (parallel/aot_store.py): hit/miss counters
        # delta-synced alongside the tier counters; compile/load wall
        # time as gauges so /metrics shows what spin-up actually paid.
        # The init-time sync publishes a pre-serve warm_aot() walk
        # before the first request lands.
        self.metrics.register_gauge(
            "serve_aot_store_compile_ms",
            lambda: (self.engine.aot_store.compile_ms
                     if getattr(self.engine, "aot_store", None) else 0.0),
            "wall-clock ms spent JIT-compiling on AOT store misses")
        self.metrics.register_gauge(
            "serve_aot_store_load_ms",
            lambda: (self.engine.aot_store.load_ms
                     if getattr(self.engine, "aot_store", None) else 0.0),
            "wall-clock ms spent deserializing stored executables")
        self._aot_seen = {"hits": 0, "misses": 0}
        self._aot_sync()
        # provenance: the engine's serving-relevant config as a
        # Prometheus info gauge (and in the bench JSON via summary())
        self.metrics.set_build_info(**engine_build_info(engine))

    @property
    def tracer(self) -> obs_trace.TraceRecorder:
        """The process-default span recorder (resolved per call so tests
        can swap rings after construction)."""
        return obs_trace.get_recorder()

    # ------------------------------------------------------------------
    # caller API (event-loop thread only)
    # ------------------------------------------------------------------

    async def start(self) -> None:
        assert self._task is None, "scheduler already started"
        self._task = asyncio.create_task(self._run(), name="serve-scheduler")

    async def stop(self) -> None:
        """Cancel live requests, shed queued ones, stop the loop."""
        self._stopping = True
        self._wake.set()
        if self._task is not None:
            await asyncio.gather(self._task, return_exceptions=True)
            self._task = None
        self._exec.shutdown(wait=True)

    def submit(self, prompt, max_new_tokens: int, *,
               deadline_s: Optional[float] = None,
               trace_id: Optional[str] = None,
               slo_class: Optional[str] = None) -> RequestHandle:
        """Enqueue a request (FCFS within its SLO class; interactive
        admits ahead of batch). Raises `ShedError` immediately when the
        admission queue is at its bound or the scheduler is stopping —
        backpressure is explicit, the caller maps it to HTTP 429/503.
        `trace_id` hangs the request's lifecycle spans (queue / prefill /
        decode / retire) on an end-to-end trace (obs/trace.py)."""
        slo_class = normalize_class(slo_class)
        if self._failed is not None:
            raise ShedError("engine_error", str(self._failed))
        if self._stopping:
            raise ShedError("shutdown", "scheduler is stopping")
        if self._draining:
            self.metrics.shed("draining", slo_class)
            raise ShedError("draining", "scheduler is draining; no new "
                                        "admissions (live slots retiring)")
        self.metrics.inc("submitted")
        self.metrics.inc_class("submitted", slo_class)
        if len(self._queue) >= self.max_queue:
            self.metrics.shed("queue_full", slo_class)
            raise ShedError(
                "queue_full",
                f"admission queue at bound ({self.max_queue}); retry later")
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        req = _Request(prompt=[int(t) for t in prompt],
                       max_new=max_new_tokens, deadline_s=deadline_s,
                       submitted_at=time.perf_counter(), handle=None,
                       orig_prompt_len=len(prompt),
                       budget_total=max_new_tokens, trace_id=trace_id,
                       slo_class=slo_class)
        req.handle = RequestHandle(self, req)
        self._pending.add(req.handle)
        # interactive inserts ahead of the queued batch section; batch
        # appends — plain FCFS whenever only one class is in play
        idx = ClassPolicy.insert_index(self._queue, slo_class)
        if idx >= len(self._queue):
            self._queue.append(req)
        else:
            self._queue.insert(idx, req)
        self._wake.set()
        return req.handle

    def drain(self) -> None:
        """Stop ADMISSION, keep serving: new submits shed with cause
        'draining' (a health-gating router stops dispatching here the
        moment `/healthz` flips), already-queued requests still reach
        slots, and live streams run to retirement. The draining restart
        recipe: drain -> wait for `drained` -> stop/replace the process —
        zero in-flight streams lost, unlike a bare stop() whose shutdown
        path sheds the queue and cancels live slots."""
        self._draining = True
        self._wake.set()

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def drained(self) -> bool:
        """True once a drain has fully quiesced (nothing queued or live)."""
        return self._draining and not self._queue and not self._live

    @property
    def failed(self) -> Optional[EngineError]:
        """The step loop's death certificate (None while healthy)."""
        return self._failed

    @property
    def healthy(self) -> bool:
        """Readiness: the background step loop is running and has not
        died. Draining is reported separately — a draining scheduler is
        alive but must not receive traffic, so `/healthz` returns 503
        for either."""
        return (self._task is not None and not self._task.done()
                and self._failed is None and not self._stopping)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def n_live(self) -> int:
        return len(self._live)

    # ------------------------------------------------------------------
    # internals (background loop)
    # ------------------------------------------------------------------

    @staticmethod
    def _caller_prompt_len(req: _Request, tokens: list) -> int:
        """Index in `tokens` where GENERATED output starts. The engine
        truncates prompts (and resume re-prompts) to their last max_len-1
        tokens, always keeping a SUFFIX — so the last `served` entries of
        `tokens` are generated and everything before them is prompt.
        `orig_prompt_len` over-counts whenever truncation dropped prompt
        tokens; this never does (== orig_prompt_len when nothing was
        dropped)."""
        return max(0, len(tokens) - req.served)

    def _emit_token(self, req: _Request, tok: int, now: float) -> None:
        """Push one generated token to the handle with the latency
        bookkeeping: the request's first-ever token is its TTFT (true
        submit-to-token wait, whether it came from a wave admission or
        the fused step that ran the prompt's last chunk); every later
        token is an ITL sample."""
        if req.served == 0:
            self.metrics.ttft.observe(now - req.submitted_at)
            self.metrics.observe_ttft_class(req.slo_class,
                                            now - req.submitted_at)
            req.first_tok_at = now
        else:
            self.metrics.itl.observe(now - req.last_tok_at)
        req.last_tok_at = now
        self.metrics.inc("tokens_out")
        req.handle._push_token(tok)

    def _trace_terminal(self, req: _Request, now: float,
                        outcome: str, **attrs) -> None:
        """Emit the request's lifecycle spans onto its trace, built from
        the timestamps already collected for the latency histograms —
        queue wait (submit -> admit), chunked prefill (admit -> first
        token), decode (first token -> retirement), and the terminal
        event. Runs once per request at a terminal transition, never on
        the token path; a disabled recorder makes it one branch."""
        tr = self.tracer
        if not tr.enabled or req.trace_id is None:
            return
        tid = req.trace_id
        adm = req.admitted_at if req.admitted_at is not None else now
        tr.add("sched.queue", tid, t0=req.submitted_at,
               dur=max(0.0, adm - req.submitted_at), cat="sched",
               resumed=req.resumed, prompt_len=req.orig_prompt_len)
        if req.admitted_at is not None:
            first = req.first_tok_at if req.first_tok_at is not None \
                else now
            tr.add("sched.prefill", tid, t0=adm,
                   dur=max(0.0, first - adm), cat="sched",
                   prefix_hit=req.adm_prefix, prefilled=req.adm_prefilled)
        if req.first_tok_at is not None:
            tr.add("sched.decode", tid, t0=req.first_tok_at,
                   dur=max(0.0, now - req.first_tok_at), cat="sched",
                   tokens=req.served)
        tr.event(f"sched.{outcome}", tid, t=now, cat="sched",
                 tokens=req.served, **attrs)

    def _request_cancel(self, req: _Request) -> None:
        if req.cancelled or req.handle.retired is not None \
                or req.handle.error is not None:
            return
        req.cancelled = True
        if req.seq_id is None:                 # still queued: shed in place
            try:
                self._queue.remove(req)
            except ValueError:                 # admission wave won the race
                pass
            else:
                self.metrics.inc("cancelled")
                self._trace_terminal(req, time.perf_counter(), "retire",
                                     reason="cancelled")
                req.handle._push_done(Retired(
                    tokens=list(req.prompt), reason="cancelled",
                    prompt_len=self._caller_prompt_len(req, req.prompt)))
                return
        self._cancel_live.append(req)
        self._wake.set()

    def _apply_cancellations(self) -> None:
        """Free cancelled live slots NOW (before the next fused step)."""
        for req in self._cancel_live:
            if req.seq_id is None:             # flagged pre-admission but
                continue                       # the wave admitted it: next
            ret = self.engine.cancel(req.seq_id)
            self._live.pop(req.seq_id, None)
            self.metrics.inc("cancelled")
            if ret is None:                    # retired before we got here
                continue
            self.metrics.retired("cancelled")
            self._trace_terminal(req, time.perf_counter(), "retire",
                                 reason="cancelled")
            req.handle._push_done(ret)
        # keep not-yet-admitted flagged requests for the next pass (the
        # admission wave resolves them); drop anything already finished
        self._cancel_live = [r for r in self._cancel_live
                             if r.seq_id is None
                             and r.handle.retired is None
                             and r.handle.error is None]

    def _shed_expired(self, now: float) -> None:
        """Evict queued requests whose deadline passed — never a live one
        (its tokens are already streaming) and never a preemption-requeued
        one (same reason: the client already holds part of the stream, so
        a shed here would be user-visible loss; the deadline only bounds
        the wait for the FIRST token). The one exception is opt-in: with
        `batch_resume_timeout_s > 0`, a voluntarily preempted batch
        request that has waited longer than that for re-admission sheds
        with the distinct cause 'preempted_batch_timeout' — which the
        router re-drives WITHOUT burning its retry budget (the client
        still keeps a lossless stream, just via another replica)."""
        keep: collections.deque[_Request] = collections.deque()
        for req in self._queue:
            if not req.resumed and req.deadline_s is not None \
                    and now - req.submitted_at > req.deadline_s:
                self.metrics.shed("deadline", req.slo_class)
                self._trace_terminal(req, now, "shed", cause="deadline")
                req.handle._push_error(ShedError(
                    "deadline",
                    f"queued {now - req.submitted_at:.3f}s > deadline "
                    f"{req.deadline_s:.3f}s"))
            elif req.resumed and req.slo_class == "batch" \
                    and self.batch_resume_timeout_s > 0 \
                    and req.preempted_at is not None \
                    and now - req.preempted_at > self.batch_resume_timeout_s:
                self.metrics.shed("preempted_batch_timeout", req.slo_class)
                self._trace_terminal(req, now, "shed",
                                     cause="preempted_batch_timeout")
                req.handle._push_error(ShedError(
                    "preempted_batch_timeout",
                    f"preempted batch request waited "
                    f"{now - req.preempted_at:.3f}s > "
                    f"{self.batch_resume_timeout_s:.3f}s for re-admission"))
            else:
                keep.append(req)
        self._queue = keep

    async def _admit_wave(self, loop) -> None:
        """Fill every free slot from the queue head. FCFS across waves;
        within the wave a stable bucket sort makes same-bucket prompts
        prefill consecutively on one compiled trace (wave mode only —
        a chunked engine has no prefill traces to group, so its waves
        stay pure FCFS)."""
        n = min(self.engine.n_free, len(self._queue))
        if not n:
            return
        chunked = getattr(self.engine, "prefill_chunk", 0) > 0
        wave = [self._queue.popleft() for _ in range(n)]
        if chunked:
            # chunked admission is bookkeeping-only (no prefill runs), so
            # the whole wave admits in ONE executor round-trip — live
            # streams wait one thread hop between steps, not one per
            # admitted request
            admitted: list = []

            def _admit_batch():
                for req in wave:
                    if req.cancelled:
                        admitted.append(None)
                        continue
                    try:
                        admitted.append(
                            self.engine.admit(req.prompt, req.max_new))
                    except NoFreeBlocks:
                        break          # remainder stays queued, in order
                return admitted

            await loop.run_in_executor(self._exec, _admit_batch)
            now = time.perf_counter()
            for req, adm in zip(wave, admitted):
                if adm is None:        # cancelled while queued
                    self.metrics.inc("cancelled")
                    req.handle._push_done(Retired(
                        tokens=list(req.prompt), reason="cancelled",
                        prompt_len=self._caller_prompt_len(req,
                                                           req.prompt)))
                    continue
                req.seq_id = adm.seq_id
                req.admitted_at = now
                req.adm_prefix, req.adm_prefilled = (adm.prefix_len,
                                                     adm.prefilled)
                self.metrics.inc("admitted")
                self.metrics.inc("prefix_hit_tokens", adm.prefix_len)
                self.metrics.inc("prefix_miss_tokens", adm.prefilled)
                if not req.resumed:
                    self.metrics.queue_wait.observe(now - req.submitted_at)
                self._live[adm.seq_id] = req
            for r in reversed(wave[len(admitted):]):  # NoFreeBlocks tail
                self._queue.appendleft(r)
            return
        wave.sort(key=lambda r: self.engine.prefill_bucket(
            min(len(r.prompt), self.engine.max_len - 1)))
        for i, req in enumerate(wave):
            if req.cancelled:
                self.metrics.inc("cancelled")
                req.handle._push_done(Retired(
                    tokens=list(req.prompt), reason="cancelled",
                    prompt_len=self._caller_prompt_len(req, req.prompt)))
                continue
            # live streams stall for the whole admission in wave mode
            # (the monolithic bucket prefill runs here); a chunked admit
            # is bookkeeping-only, so the same measurement stays ~0
            stalled = bool(self._live)
            t0 = time.perf_counter()
            try:
                adm = await loop.run_in_executor(
                    self._exec, self.engine.admit, req.prompt, req.max_new)
            except NoFreeBlocks:
                # pool exhausted: the wave's remainder goes BACK to the
                # queue head in order — they stay queued (never shed) and
                # re-admit as retirements free blocks
                for r in reversed(wave[i:]):
                    self._queue.appendleft(r)
                return
            now = time.perf_counter()
            if stalled:
                self.metrics.stall(now - t0)
            req.seq_id = adm.seq_id
            req.admitted_at = now
            req.adm_prefix, req.adm_prefilled = (adm.prefix_len,
                                                 adm.prefilled)
            # last_tok_at is NOT reset here: _emit_token stamps it, and a
            # resumed request's next ITL sample should span the whole
            # client-visible preemption gap
            self.metrics.inc("admitted")
            self.metrics.inc("prefix_hit_tokens", adm.prefix_len)
            self.metrics.inc("prefix_miss_tokens", adm.prefilled)
            if not req.resumed:
                self.metrics.queue_wait.observe(now - req.submitted_at)
            if adm.first_token is not None:    # wave mode: TTFT token now
                self.metrics.prefill_tokens_per_step.observe(adm.prefilled)
                self._emit_token(req, adm.first_token, now)
            if adm.retired is not None:        # finished at prefill
                self._finish(req, adm.retired, now)
            else:
                self._live[adm.seq_id] = req

    def _tier_sync(self) -> None:
        """Fold the engine host tier's lifetime counters into the
        metrics registry as deltas and drain per-promotion byte sizes
        into the promote-bytes histogram. Runs on the event loop right
        after an engine call returns from the executor — the tier only
        mutates inside admit/step, so the read races nothing."""
        tier = getattr(self.engine, "host_tier", None)
        if tier is None:
            return
        counts = tier.counters()
        for k in ("demoted", "promoted", "dropped"):
            delta = counts[k] - self._tier_seen[k]
            if delta:
                self.metrics.inc(f"kv_tier_{k}_blocks", delta)
                self._tier_seen[k] = counts[k]
        for nbytes in tier.drain_promote_events():
            self.metrics.kv_tier_promote_bytes.observe(float(nbytes))

    def _aot_sync(self) -> None:
        """Fold the AOT store's lifetime hit/miss counts into the
        metrics registry as deltas (same contract as _tier_sync: the
        store only mutates inside engine program builds, so reading
        after an engine call races nothing)."""
        store = getattr(self.engine, "aot_store", None)
        if store is None:
            return
        for k, total in (("hits", store.hits), ("misses", store.misses)):
            delta = total - self._aot_seen[k]
            if delta:
                self.metrics.inc(f"aot_store_{k}", delta)
                self._aot_seen[k] = total

    async def _preempt_for_interactive(self, loop) -> None:
        """Voluntary class preemption: when queued interactive requests
        outnumber free slots and batch work holds slots, evict just
        enough live batch streams (most recently admitted first — least
        decode progress lost) through the engine's lossless cancel ->
        requeue path. The victim's tokens-so-far become its resume
        prompt; its retained radix/host-tier prefix makes re-admission a
        cache hit; it re-queues at the FRONT of the batch section —
        behind every waiting interactive request, ahead of queued batch
        work. Batch absorbs latency, never loss."""
        n_int = sum(1 for r in self._queue
                    if r.slo_class == "interactive" and not r.cancelled)
        if not n_int:
            return
        live_batch = [r for r in self._live.values()
                      if r.slo_class == "batch" and not r.cancelled]
        k = ClassPolicy.preempt_count(n_int, self.engine.n_free,
                                      len(live_batch))
        if k <= 0:
            return
        victims = ClassPolicy.pick_victims(live_batch, k)

        def _evict():
            return [self.engine.cancel(r.seq_id) for r in victims]

        rets = await loop.run_in_executor(self._exec, _evict)
        now = time.perf_counter()
        for req, ret in zip(victims, rets):
            self._live.pop(req.seq_id, None)
            if ret is None:            # retired in the same step: done
                continue
            ret.reason = "preempted"   # policy eviction, not abandonment
            if self._requeue_preempted(req, ret):
                req.preempted_at = now
                idx = ClassPolicy.insert_index(self._queue, "batch",
                                               resumed=True)
                self._queue.insert(idx, req)

    def _finish(self, req: _Request, ret: Retired, now: float) -> None:
        self.metrics.inc("completed")
        self.metrics.inc_class("completed", req.slo_class)
        self.metrics.retired(ret.reason)
        self.metrics.e2e.observe(now - req.submitted_at)
        # a resumed request's final record reports the caller-visible
        # prompt boundary, not the resubmitted tokens-so-far prompt
        ret.prompt_len = self._caller_prompt_len(req, ret.tokens)
        self._trace_terminal(req, now, "retire", reason=ret.reason)
        req.handle._push_done(ret)

    def _requeue_preempted(self, req: _Request, ret: Retired) -> bool:
        """Resubmit a preempted request at the queue head (tokens so far
        become the prompt; remaining budget from the scheduler-side
        `served` count — handle.tokens is consumer-paced and lags, which
        would over-budget the resume and double-emit tokens). Returns
        False when the request was cancelled meanwhile — it finishes as
        cancelled instead."""
        if req.cancelled:
            self.metrics.inc("cancelled")
            self.metrics.retired("cancelled")
            ret.reason = "cancelled"
            ret.prompt_len = self._caller_prompt_len(req, ret.tokens)
            self._trace_terminal(req, time.perf_counter(), "retire",
                                 reason="cancelled")
            req.handle._push_done(ret)
            return False
        self.tracer.event("sched.preempted", req.trace_id, cat="sched",
                          tokens=req.served)
        req.prompt = list(ret.tokens)
        # served < budget_total always holds here: the engine retires on
        # 'budget' (not 'preempted') the step the budget is reached
        req.max_new = req.budget_total - req.served
        assert req.max_new >= 1, "preempted past its budget"
        req.seq_id = None
        req.admitted_at = None
        req.resumed = True
        self.metrics.inc("preempted")
        self.metrics.inc("requeued")
        self.metrics.inc_class("preempted", req.slo_class)
        return True

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                now = time.perf_counter()
                self._apply_cancellations()
                self._shed_expired(now)
                if self._stopping:
                    break
                # class preemption BEFORE admission: evicted batch slots
                # free up for the interactive backlog in this same pass
                await self._preempt_for_interactive(loop)
                await self._admit_wave(loop)
                self._tier_sync()      # admits demote (preempt) + promote
                self._aot_sync()       # admits can build fresh buckets
                if not self._live:
                    if not self._queue:        # idle: park until work
                        self._wake.clear()
                        # re-check under the cleared flag (submit() may
                        # have landed between the test and the clear)
                        if not self._queue and not self._cancel_live \
                                and not self._stopping:
                            await self._wake.wait()
                    continue
                # admissions may have taken a while — free freshly
                # cancelled slots before paying for a step
                self._apply_cancellations()
                if not self._live:
                    continue
                self.metrics.observe_occupancy(self.engine.occupancy)
                res = await loop.run_in_executor(self._exec,
                                                 self.engine.step)
                now = time.perf_counter()
                self._tier_sync()      # steps demote via _ensure_blocks
                self._aot_sync()       # first step builds its program
                if getattr(self.engine, "prefill_chunk", 0):
                    # per-step chunk budget use: the chunk-size tuning
                    # signal (p50 ~ budget => prefill-bound, ~0 => slack)
                    self.metrics.prefill_tokens_per_step.observe(
                        res.prefill_tokens)
                if res.drafted:
                    # speculative-decoding ledger: acceptance rate is
                    # accepted/drafted; the spec bench leg pins it > 0
                    self.metrics.inc("spec_drafted_tokens", res.drafted)
                    self.metrics.inc("spec_accepted_tokens", res.accepted)
                for sid, toks in res.emitted.items():
                    req = self._live.get(sid)
                    if req is None:            # cancelled mid-flight
                        continue
                    # a spec step emits a LIST (accepted prefix + the
                    # correction token); fanning them out one at a time
                    # preserves stream order and the served-count/TTFT
                    # bookkeeping (first-ever token is still the TTFT;
                    # later tokens in the same step are ~0 ITL samples)
                    for tok in toks:
                        self._emit_token(req, tok, now)
                requeued: list[_Request] = []
                for sid, ret in res.retired.items():
                    req = self._live.pop(sid, None)
                    if req is None:
                        continue
                    if ret.reason == "preempted":
                        if self._requeue_preempted(req, ret):
                            req.preempted_at = now
                            requeued.append(req)
                    else:
                        self._finish(req, ret, now)
                # front of the request's CLASS section, original order: a
                # preempted request outranks everything of its class that
                # arrived after it, but a preempted batch request never
                # jumps a waiting interactive one
                for req in requeued:
                    idx = ClassPolicy.insert_index(self._queue,
                                                   req.slo_class,
                                                   resumed=True)
                    self._queue.insert(idx, req)
                # one cooperative yield so consumers drain between steps
                await asyncio.sleep(0)
        except Exception as exc:               # crash guard: error, not hang
            # fail EVERY pending handle — not just _live/_queue: a wave
            # admission pops requests into a loop-local list, and an
            # exception mid-wave would otherwise strand those streams
            # forever (the regression tests/test_serve.py pins). The
            # failure flag flips /healthz to 503 and makes later submits
            # shed immediately instead of queueing into a dead loop.
            self._failed = EngineError(exc)
            for handle in list(self._pending):
                # neither completed nor shed: the availability SLO's
                # third denominator term
                self.metrics.inc("failed")
                self.tracer.event("sched.engine_error",
                                  handle._req.trace_id, cat="sched",
                                  error=repr(exc)[:200])
                handle._push_error(self._failed)
            self._live.clear()
            self._queue.clear()
            raise
        finally:
            # shutdown: cancel live slots, shed whatever is still queued
            for req in list(self._live.values()):
                ret = self.engine.cancel(req.seq_id)
                self.metrics.inc("cancelled")
                if ret is not None:
                    self.metrics.retired("cancelled")
                    req.handle._push_done(ret)
            self._live.clear()
            for req in self._queue:
                self.metrics.shed("shutdown")
                self._trace_terminal(req, time.perf_counter(), "shed",
                                     cause="shutdown")
                req.handle._push_error(
                    ShedError("shutdown", "scheduler stopped"))
            self._queue.clear()
