"""Serve-side observability: latency histograms, lifecycle counters, and
live gauges, rendered two ways — Prometheus text (`/metrics`) and a JSON
summary (the bench `serve_load` leg).

The quantities mirror the serving literature's decode SLOs (Orca/vLLM,
PAPERS.md): **TTFT** (submit -> first token; = queue wait + bucketed
prefill), **ITL** (gap between consecutive streamed tokens; = one fused
engine step when the scheduler keeps up), **e2e** latency, plus queue
depth / slot occupancy and admitted/completed/cancelled/shed counters —
the pair of curves (occupancy up, shed rate up) the admission bound
trades between.

Design notes:
* Histograms keep BOTH Prometheus cumulative bucket counts (cheap,
  mergeable, what scrapers want) and a capped reservoir of raw samples so
  the bench leg reports exact p50/p99 instead of bucket-edge estimates
  (exact until `max_samples` observations; the cap only bounds memory on
  a long-lived server — CI/bench runs never reach it).
* No locks: every observation comes from the scheduler's event loop (the
  engine runs in an executor, but its results are consumed back on the
  loop), and `/metrics` renders on the same loop. Single-threaded by
  construction, like the rest of the asyncio front-end.
* stdlib only — the CI image needs no prometheus_client.
"""

from __future__ import annotations

from typing import Callable, Optional

# Decode SLOs span ~1 ms (one fused step) to minutes (a queued long
# prompt), so the default grid is log-ish across that range, in seconds.
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)

# Per-step prefill token counts (chunked prefill): pow2 grid up to the
# largest plausible chunk budget — the knob this histogram tunes.
PREFILL_TOKEN_BUCKETS = (0, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)

# Host-tier promote transport sizes (ops/kv_tier.py): pow4 byte grid from
# one tiny block to tens of MB of chain — the bytes axis of the PERF.md
# promote-cost model (bytes/PCIe-BW + device_put fixed cost).
PROMOTE_BYTE_BUCKETS = (4096, 16384, 65536, 262144, 1048576,
                        4194304, 16777216, 67108864)


def engine_build_info(engine) -> dict:
    """The engine's serving-relevant config, for the build-info gauge:
    a scrape (or a bench JSON) carries its own provenance, so an A/B
    line can never be mistaken for a different knob setting. Reads via
    getattr so any engine-shaped object works."""
    info: dict = {}
    cfg = getattr(engine, "cfg", None)
    if cfg is not None:
        info["model"] = (f"L{getattr(cfg, 'n_layer', '?')}"
                         f"xD{getattr(cfg, 'n_embd', '?')}"
                         f"-{getattr(cfg, 'attn', '?')}")
    for label, attr in (("n_slots", "n_slots"), ("max_len", "max_len"),
                        ("kv_block", "block_size"),
                        ("kv_blocks", "n_blocks"),
                        ("prefill_chunk", "prefill_chunk"),
                        ("prefix_cache", "prefix_cache"),
                        ("quant_weights", "weights_quantized")):
        v = getattr(engine, attr, None)
        if v is not None:
            info[label] = v
    cd = getattr(engine, "cache_dtype", None)
    if cd is not None:
        # torch dtypes print as "torch.bfloat16"; keep the bare name
        info["cache_dtype"] = str(cd).removeprefix("torch.")
    try:
        import torch
        info["torch"] = torch.__version__
    except Exception:  # noqa: BLE001 — a torch-less process still renders
        pass
    return info


def _esc(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _labels(labels: dict) -> str:
    """Render a label dict as `{k="v",...}` (empty dict -> "")."""
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{_esc(v)}"'
                          for k, v in labels.items()) + "}"


def _render_info(name: str, help_: str, info: dict) -> list[str]:
    """Prometheus info-gauge idiom: constant 1 with the facts as labels."""
    if not info:
        return []
    labels = ",".join(f'{k}="{_esc(v)}"' for k, v in sorted(info.items()))
    return [f"# HELP {name} {help_}", f"# TYPE {name} gauge",
            f"{name}{{{labels}}} 1"]


class Histogram:
    """Prometheus-style cumulative histogram + exact quantiles."""

    def __init__(self, name: str, help_: str,
                 buckets=LATENCY_BUCKETS, max_samples: int = 65536):
        self.name = name
        self.help = help_
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self.sum = 0.0
        self.count = 0
        self._samples: list[float] = []
        self._max_samples = max_samples

    def observe(self, v: float) -> None:
        self.sum += v
        self.count += 1
        for i, edge in enumerate(self.buckets):
            if v <= edge:
                self.counts[i] += 1
                break
        else:
            self.counts[-1] += 1
        if len(self._samples) < self._max_samples:
            self._samples.append(v)

    def quantile(self, q: float) -> Optional[float]:
        """Exact quantile over the retained samples (None when empty)."""
        if not self._samples:
            return None
        s = sorted(self._samples)
        idx = min(len(s) - 1, max(0, round(q * (len(s) - 1))))
        return s[idx]

    @property
    def max(self) -> Optional[float]:
        return max(self._samples) if self._samples else None

    def count_le(self, threshold: float) -> int:
        """Observations provably <= threshold from the bucket counts
        alone (cumulative count of every bucket whose edge fits). Exact
        when the threshold is a bucket edge — SLO targets default to
        edges of LATENCY_BUCKETS for exactly this reason — and a
        conservative undercount otherwise."""
        total = 0
        for edge, c in zip(self.buckets, self.counts):
            if edge <= threshold:
                total += c
            else:
                break
        return total

    def to_dict(self) -> dict:
        """JSON-serializable snapshot carrying everything `merge_from`
        needs: per-bucket (non-cumulative) counts merge by elementwise
        addition, reservoirs by concatenate-and-cap."""
        return {"name": self.name, "help": self.help,
                "buckets": list(self.buckets),
                "counts": list(self.counts),
                "sum": self.sum, "count": self.count,
                "samples": list(self._samples)}

    def merge_from(self, snap: dict) -> None:
        """Fold another process's `to_dict()` snapshot into this
        histogram. Bucket grids must match exactly — merging histograms
        with different edges would silently misbucket, so it raises."""
        if tuple(snap["buckets"]) != self.buckets:
            raise ValueError(
                f"{self.name}: bucket mismatch "
                f"({snap['buckets']!r} != {list(self.buckets)!r})")
        for i, c in enumerate(snap["counts"]):
            self.counts[i] += int(c)
        self.sum += float(snap["sum"])
        self.count += int(snap["count"])
        room = self._max_samples - len(self._samples)
        if room > 0:
            self._samples.extend(snap["samples"][:room])

    @classmethod
    def from_dict(cls, snap: dict,
                  max_samples: int = 65536) -> "Histogram":
        h = cls(snap["name"], snap.get("help", ""),
                buckets=snap["buckets"], max_samples=max_samples)
        h.merge_from(snap)
        return h

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        cum = 0
        for edge, c in zip(self.buckets, self.counts):
            cum += c
            lines.append(f'{self.name}_bucket{{le="{edge}"}} {cum}')
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {self.count}')
        lines.append(f"{self.name}_sum {self.sum}")
        lines.append(f"{self.name}_count {self.count}")
        return lines

    def summary(self, unit: str = "ms", scale: float = 1e3) -> dict:
        """p50/p99/max/mean for the bench leg JSON — milliseconds by
        default; token-valued histograms pass unit='tok', scale=1."""
        if not self.count:
            return {"count": 0}
        return {"count": self.count,
                f"p50_{unit}": round((self.quantile(0.50) or 0.0) * scale, 3),
                f"p99_{unit}": round((self.quantile(0.99) or 0.0) * scale, 3),
                f"max_{unit}": round((self.max or 0.0) * scale, 3),
                f"mean_{unit}": round(self.sum / self.count * scale, 3)}


def merge_histograms(snaps: list[dict], max_samples: int = 65536) -> dict:
    """Merge N `Histogram.to_dict()` snapshots into one snapshot dict.
    Bucket counts sum exactly (the fleet page is bit-equal to summing
    per-replica scrapes); reservoirs concatenate capped at max_samples."""
    if not snaps:
        raise ValueError("no histogram snapshots to merge")
    h = Histogram.from_dict(snaps[0], max_samples=max_samples)
    for s in snaps[1:]:
        h.merge_from(s)
    return h.to_dict()


def render_hist_snap(snap: dict, labels: Optional[dict] = None,
                     header: bool = True) -> list[str]:
    """Render a histogram snapshot dict as Prometheus text, optionally
    tagging every series with extra labels (the fleet page's
    `replica="host:port"`) and suppressing the HELP/TYPE header when the
    metric name was already introduced by the fleet-summed series."""
    name = snap["name"]
    extra = dict(labels or {})
    lines: list[str] = []
    if header:
        lines += [f"# HELP {name} {snap.get('help', '')}",
                  f"# TYPE {name} histogram"]
    cum = 0
    for edge, c in zip(snap["buckets"], snap["counts"]):
        cum += c
        lines.append(f'{name}_bucket{_labels({**extra, "le": edge})} {cum}')
    lines.append(
        f'{name}_bucket{_labels({**extra, "le": "+Inf"})} {snap["count"]}')
    lines.append(f'{name}_sum{_labels(extra)} {snap["sum"]}')
    lines.append(f'{name}_count{_labels(extra)} {snap["count"]}')
    return lines


def render_fleet(snapshots: dict) -> str:
    """The router's `GET /metrics/fleet` page: one Prometheus document
    built from per-replica `ServeMetrics.snapshot()` dicts — each
    histogram appears once fleet-summed (unlabeled, bit-equal to adding
    the per-replica scrapes) and once per replica with a `replica`
    label; counters likewise; gauges and provenance only per replica
    (summing a queue depth across replicas is meaningful, summing a
    build hash is not)."""
    reps = sorted(snapshots.items())
    lines = ["# HELP serve_fleet_replicas replicas contributing to this "
             "fleet page",
             "# TYPE serve_fleet_replicas gauge",
             f"serve_fleet_replicas {len(reps)}"]
    hist_names: list[str] = []
    for _, snap in reps:
        for hn in snap.get("histograms", {}):
            if hn not in hist_names:
                hist_names.append(hn)
    for hn in hist_names:
        per = [(r, snap["histograms"][hn]) for r, snap in reps
               if hn in snap.get("histograms", {})]
        lines += render_hist_snap(merge_histograms([s for _, s in per]),
                                  header=True)
        for r, s in per:
            lines += render_hist_snap(s, labels={"replica": r},
                                      header=False)
    counter_keys: list[str] = []
    for _, snap in reps:
        for k in snap.get("counters", {}):
            if k not in counter_keys:
                counter_keys.append(k)
    if counter_keys:
        lines += ["# HELP serve_fleet_requests_total lifecycle counters "
                  "summed across replicas (and per replica, labeled)",
                  "# TYPE serve_fleet_requests_total counter"]
        for k in counter_keys:
            tot = sum(int(snap.get("counters", {}).get(k, 0))
                      for _, snap in reps)
            lines.append(
                f'serve_fleet_requests_total{_labels({"event": k})} {tot}')
            for r, snap in reps:
                if k in snap.get("counters", {}):
                    lines.append(
                        "serve_fleet_requests_total"
                        f'{_labels({"event": k, "replica": r})} '
                        f'{snap["counters"][k]}')
    class_hist_names: list[str] = []
    class_names: list[str] = []
    for _, snap in reps:
        for cls, hists in snap.get("histograms_by_class", {}).items():
            if cls not in class_names:
                class_names.append(cls)
            for hn in hists:
                if hn not in class_hist_names:
                    class_hist_names.append(hn)
    for hn in sorted(class_hist_names):
        first = True
        for cls in sorted(class_names):
            per = [(r, snap["histograms_by_class"][cls][hn])
                   for r, snap in reps
                   if hn in snap.get("histograms_by_class", {})
                   .get(cls, {})]
            if not per:
                continue
            lines += render_hist_snap(
                merge_histograms([s for _, s in per]),
                labels={"class": cls}, header=first)
            first = False
    shed_keys: list[tuple[str, str]] = []
    for _, snap in reps:
        for k in snap.get("shed_by_cause_class", {}):
            cause, _, cls = k.partition("|")
            if (cause, cls) not in shed_keys:
                shed_keys.append((cause, cls))
    if shed_keys:
        lines += ["# HELP serve_fleet_shed_total sheds by cause and SLO "
                  "class, summed across replicas (and per replica)",
                  "# TYPE serve_fleet_shed_total counter"]
        for cause, cls in sorted(shed_keys):
            k = f"{cause}|{cls}"
            tot = sum(int(snap.get("shed_by_cause_class", {}).get(k, 0))
                      for _, snap in reps)
            lines.append("serve_fleet_shed_total"
                         f'{_labels({"cause": cause, "class": cls})} {tot}')
            for r, snap in reps:
                if k in snap.get("shed_by_cause_class", {}):
                    lines.append(
                        "serve_fleet_shed_total"
                        f'{_labels({"cause": cause, "class": cls, "replica": r})} '
                        f'{snap["shed_by_cause_class"][k]}')
    occ_n = sum(int(s.get("occ_n", 0)) for _, s in reps)
    occ_sum = sum(float(s.get("occ_sum", 0.0)) for _, s in reps)
    lines += ["# HELP serve_fleet_slot_occupancy_mean mean live-slot "
              "fraction over all fused steps, fleet-wide",
              "# TYPE serve_fleet_slot_occupancy_mean gauge",
              "serve_fleet_slot_occupancy_mean "
              f"{(occ_sum / occ_n if occ_n else 0.0):.4f}"]
    gauge_names: list[str] = []
    for _, snap in reps:
        for g in snap.get("gauges", {}):
            if g not in gauge_names:
                gauge_names.append(g)
    for g in gauge_names:
        lines.append(f"# TYPE {g} gauge")
        for r, snap in reps:
            if g in snap.get("gauges", {}):
                v = snap["gauges"][g]
                lines.append(f'{g}{_labels({"replica": r})} '
                             f"{v if v is not None else 'NaN'}")
    for r, snap in reps:
        bi = snap.get("build_info") or {}
        if bi:
            labels = {**{k: str(v) for k, v in sorted(bi.items())},
                      "replica": r}
            lines.append(f"serve_build_info{_labels(labels)} 1")
        wv = snap.get("weights_version")
        if wv:
            lines.append("serve_weights_version"
                         f'{_labels({"replica": r, "version": wv})} 1')
    return "\n".join(lines) + "\n"


class ServeMetrics:
    """The scheduler/server's shared metrics registry."""

    #: request lifecycle counters; 'shed' splits by cause in shed_counts.
    #: 'preempted'/'requeued' track the paged pool's block-level
    #: preemption (every preempted request is requeued, never lost);
    #: 'prefix_hit_tokens'/'prefix_miss_tokens' split each admission's
    #: prompt into reused-from-cached-blocks vs actually-prefilled
    #: tokens; 'failed' counts requests terminated by an engine error —
    #: the denominator term of the availability SLO that neither
    #: 'completed' nor 'shed' covers.
    #: 'spec_drafted_tokens'/'spec_accepted_tokens' are the speculative-
    #: decoding ledger (engine/decode.py): tokens the n-gram drafter
    #: proposed vs tokens the verify step accepted — their ratio is the
    #: accepted_token_rate gauge the spec bench leg pins.
    #: 'kv_tier_*_blocks' mirror the host-RAM KV tier's block movements
    #: (ops/kv_tier.py, delta-synced by the scheduler): demoted =
    #: evictions saved to host RAM, promoted = radix hits staged back
    #: into HBM, dropped = lost to the host LRU cap — the only way
    #: tier-managed KV is ever lost.
    #: 'aot_store_hits'/'aot_store_misses' mirror the AOT program
    #: store's ledger (parallel/aot_store.py, delta-synced like the
    #: tier counters): hit = a compiled program deserialized from disk
    #: (no JIT), miss = a cold compile + write-back — a warmed replica
    #: must scrape misses == 0 (the serve smoke and tier-1 CI assert
    #: it); the router federates both across the fleet.
    COUNTERS = ("submitted", "admitted", "completed", "cancelled", "shed",
                "failed", "tokens_out", "preempted", "requeued",
                "prefix_hit_tokens", "prefix_miss_tokens",
                "spec_drafted_tokens", "spec_accepted_tokens",
                "kv_tier_demoted_blocks", "kv_tier_promoted_blocks",
                "kv_tier_dropped_blocks",
                "aot_store_hits", "aot_store_misses")

    def __init__(self):
        self._gauges: dict[str, tuple[Callable[[], float], str]] = {}
        self.ttft = Histogram(
            "serve_ttft_seconds",
            "submit to first streamed token (queue wait + bucketed prefill)")
        self.itl = Histogram(
            "serve_itl_seconds",
            "inter-token latency (one fused decode step when not queued)")
        self.e2e = Histogram(
            "serve_e2e_seconds", "submit to retirement")
        self.queue_wait = Histogram(
            "serve_queue_wait_seconds", "submit to slot admission")
        # chunked-prefill observability: the per-step prefill
        # token distribution is the chunk-size knob's tuning signal —
        # p50 near the chunk budget means prefill-bound, near 0 means the
        # budget is slack — and decode_stall tracks how long live decode
        # streams sat behind monolithic (wave) prefill work.
        self.prefill_tokens_per_step = Histogram(
            "serve_prefill_tokens_per_step",
            "prefill tokens executed per fused step (chunked mode) or "
            "per admission (wave mode)", buckets=PREFILL_TOKEN_BUCKETS)
        # host-tier promote transport: per-promotion byte
        # sizes, the distribution the PERF.md promote-cost model is fit
        # against — one sample per block chain staged host->HBM
        self.kv_tier_promote_bytes = Histogram(
            "serve_kv_tier_promote_bytes",
            "bytes staged per host-tier->HBM chain promotion "
            "(ops/kv_tier.py)", buckets=PROMOTE_BYTE_BUCKETS)
        self.decode_stall_s = 0.0
        self.register_gauge(
            "serve_decode_stall_ms", lambda: self.decode_stall_s * 1e3,
            "cumulative time decode slots sat idle behind prefill work")
        self.counters = dict.fromkeys(self.COUNTERS, 0)
        self.shed_counts: dict[str, int] = {}     # cause -> n
        self.retire_counts: dict[str, int] = {}   # reason -> n
        # control plane: the same ledgers split by SLO class.
        # Keys are "cause|class" / "event|class" flat strings so the
        # snapshot stays JSON-round-trippable; per-class TTFT histograms
        # live under their class in `histograms_by_class` — a separate
        # snapshot key so the fleet page's merge-by-name logic never
        # conflates a class slice with the all-traffic series.
        self.shed_class_counts: dict[str, int] = {}
        self.class_counts: dict[str, int] = {}
        self._ttft_class: dict[str, Histogram] = {}
        self.build_info: dict[str, str] = {}      # provenance labels
        self.weights_version: Optional[str] = None
        self._occ_sum = 0.0
        self._occ_n = 0

    # ------------------------------------------------------------------
    def inc(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def shed(self, cause: str, slo_class: Optional[str] = None) -> None:
        self.counters["shed"] += 1
        self.shed_counts[cause] = self.shed_counts.get(cause, 0) + 1
        if slo_class:
            k = f"{cause}|{slo_class}"
            self.shed_class_counts[k] = self.shed_class_counts.get(k, 0) + 1

    def inc_class(self, event: str, slo_class: str, n: int = 1) -> None:
        """Per-SLO-class slice of a lifecycle counter (the unsliced
        counter is still incremented via `inc` by the caller)."""
        k = f"{event}|{slo_class}"
        self.class_counts[k] = self.class_counts.get(k, 0) + n

    def observe_ttft_class(self, slo_class: str, v: float) -> None:
        """Per-class TTFT sample (the all-traffic `ttft` histogram is
        observed separately by the caller): the class-isolation SLO —
        interactive p99 held while batch absorbs preemptions — reads
        from these slices."""
        h = self._ttft_class.get(slo_class)
        if h is None:
            h = self._ttft_class[slo_class] = Histogram(
                "serve_ttft_seconds",
                "submit to first streamed token, per SLO class")
        h.observe(v)

    def ttft_class(self, slo_class: str) -> Optional[Histogram]:
        return self._ttft_class.get(slo_class)

    def retired(self, reason: str) -> None:
        self.retire_counts[reason] = self.retire_counts.get(reason, 0) + 1

    def stall(self, seconds: float) -> None:
        """Account time live decode streams spent waiting on prefill work
        (a monolithic wave admission ran while slots held live streams —
        ~0 in chunked mode, where prefill rides the fused step)."""
        self.decode_stall_s += seconds

    def observe_occupancy(self, frac: float) -> None:
        """Record the live-slot fraction seen by one fused step."""
        self._occ_sum += frac
        self._occ_n += 1

    @property
    def mean_occupancy(self) -> float:
        return self._occ_sum / self._occ_n if self._occ_n else 0.0

    def register_gauge(self, name: str, fn: Callable[[], float],
                       help_: str = "") -> None:
        """Register a live-read gauge (queue depth, slot occupancy)."""
        self._gauges[name] = (fn, help_)

    def set_build_info(self, **info) -> None:
        """Merge provenance labels into the build-info gauge (model
        preset, prefill_chunk, kv block size, cache dtype, torch version —
        whatever identifies THIS serving config in a scrape)."""
        self.build_info.update({k: str(v) for k, v in info.items()})

    def set_weights_version(self, version: Optional[str]) -> None:
        """Record which weights this replica serves (ckpt step dir +
        manifest digest prefix, or 'demo') — surfaces as an info gauge
        on /metrics and rides every completion payload."""
        self.weights_version = version

    # ------------------------------------------------------------------
    def _histograms(self) -> tuple:
        return (self.ttft, self.itl, self.e2e, self.queue_wait,
                self.prefill_tokens_per_step, self.kv_tier_promote_bytes)

    def snapshot(self) -> dict:
        """JSON-serializable state for `GET /metrics.json` — everything
        the router needs to rebuild this replica's series on the fleet
        page and to merge histograms exactly (raw per-bucket counts, raw
        occupancy accumulators, evaluated gauges)."""
        gauges = {}
        for name, (fn, _) in sorted(self._gauges.items()):
            try:
                gauges[name] = round(float(fn()), 6)
            except Exception:  # pragma: no cover — gauge died
                gauges[name] = None
        return {"kind": "serve",
                "histograms": {h.name: h.to_dict()
                               for h in self._histograms()},
                "histograms_by_class": {
                    cls: {h.name: h.to_dict()}
                    for cls, h in sorted(self._ttft_class.items())},
                "counters": dict(self.counters),
                "shed_by_cause": dict(self.shed_counts),
                "shed_by_cause_class": dict(self.shed_class_counts),
                "counters_by_class": dict(self.class_counts),
                "retired_by_reason": dict(self.retire_counts),
                "gauges": gauges,
                "build_info": dict(self.build_info),
                "weights_version": self.weights_version,
                "occ_sum": self._occ_sum, "occ_n": self._occ_n,
                "decode_stall_s": self.decode_stall_s}

    def render_prometheus(self) -> str:
        """The `/metrics` payload (Prometheus text exposition 0.0.4)."""
        lines: list[str] = _render_info(
            "serve_build_info",
            "serving config provenance (labels; value always 1)",
            self.build_info)
        if self.weights_version:
            lines += _render_info(
                "serve_weights_version",
                "checkpoint identity of the served weights",
                {"version": self.weights_version})
        for h in self._histograms():
            lines += h.render()
        for cls, h in sorted(self._ttft_class.items()):
            lines += render_hist_snap(h.to_dict(), labels={"class": cls},
                                      header=False)
        lines += ["# HELP serve_requests_total request lifecycle counters",
                  "# TYPE serve_requests_total counter"]
        for name in ("submitted", "admitted", "completed", "cancelled",
                     "shed", "failed", "preempted", "requeued"):
            lines.append(f'serve_requests_total{{event="{name}"}} '
                         f'{self.counters[name]}')
        lines += ["# HELP serve_prefix_tokens_total prompt tokens served "
                  "from cached prefix blocks (hit) vs prefilled (miss)",
                  "# TYPE serve_prefix_tokens_total counter",
                  f'serve_prefix_tokens_total{{kind="hit"}} '
                  f"{self.counters['prefix_hit_tokens']}",
                  f'serve_prefix_tokens_total{{kind="miss"}} '
                  f"{self.counters['prefix_miss_tokens']}"]
        lines += ["# HELP serve_spec_tokens_total speculative decoding: "
                  "draft tokens proposed vs accepted by the verify step",
                  "# TYPE serve_spec_tokens_total counter",
                  f'serve_spec_tokens_total{{kind="drafted"}} '
                  f"{self.counters['spec_drafted_tokens']}",
                  f'serve_spec_tokens_total{{kind="accepted"}} '
                  f"{self.counters['spec_accepted_tokens']}"]
        lines += ["# HELP serve_aot_store_programs_total AOT program "
                  "store ledger: executables read from the store (hit) "
                  "vs JIT-compiled on miss (parallel/aot_store.py); a "
                  "warmed replica must scrape miss == 0",
                  "# TYPE serve_aot_store_programs_total counter",
                  f'serve_aot_store_programs_total{{event="hit"}} '
                  f"{self.counters['aot_store_hits']}",
                  f'serve_aot_store_programs_total{{event="miss"}} '
                  f"{self.counters['aot_store_misses']}"]
        for ev in ("demoted", "promoted", "dropped"):
            name = f"kv_tier_{ev}_blocks_total"
            lines += [f"# HELP {name} host-RAM KV tier blocks {ev} "
                      "(ops/kv_tier.py)",
                      f"# TYPE {name} counter",
                      f"{name} {self.counters[f'kv_tier_{ev}_blocks']}"]
        for cause, n in sorted(self.shed_counts.items()):
            lines.append(f'serve_shed_total{{cause="{cause}"}} {n}')
        for k, n in sorted(self.shed_class_counts.items()):
            cause, _, cls = k.partition("|")
            lines.append("serve_shed_total"
                         f'{_labels({"cause": cause, "class": cls})} {n}')
        for k, n in sorted(self.class_counts.items()):
            ev, _, cls = k.partition("|")
            lines.append("serve_requests_total"
                         f'{_labels({"event": ev, "class": cls})} {n}')
        for reason, n in sorted(self.retire_counts.items()):
            lines.append(f'serve_retired_total{{reason="{reason}"}} {n}')
        lines += ["# HELP serve_tokens_streamed_total tokens fanned out",
                  "# TYPE serve_tokens_streamed_total counter",
                  f"serve_tokens_streamed_total "
                  f"{self.counters['tokens_out']}",
                  "# HELP serve_slot_occupancy_mean mean live-slot "
                  "fraction over all fused steps",
                  "# TYPE serve_slot_occupancy_mean gauge",
                  f"serve_slot_occupancy_mean {self.mean_occupancy:.4f}"]
        for name, (fn, help_) in sorted(self._gauges.items()):
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} gauge")
            try:
                lines.append(f"{name} {float(fn())}")
            except Exception:  # pragma: no cover — gauge died mid-shutdown
                lines.append(f"{name} NaN")
        return "\n".join(lines) + "\n"

    def summary(self) -> dict:
        """Flat dict for the bench `serve_load` leg JSON."""
        out = {"ttft": self.ttft.summary(), "itl": self.itl.summary(),
               "e2e": self.e2e.summary(),
               "queue_wait": self.queue_wait.summary(),
               "prefill_tokens_per_step":
                   self.prefill_tokens_per_step.summary(unit="tok",
                                                        scale=1.0),
               "mean_occupancy": round(self.mean_occupancy, 4)}
        out.update(self.counters)
        if self.build_info:
            out["build_info"] = dict(self.build_info)
        if self.weights_version:
            out["weights_version"] = self.weights_version
        if self.shed_counts:
            out["shed_by_cause"] = dict(self.shed_counts)
        if self.shed_class_counts:
            out["shed_by_cause_class"] = dict(self.shed_class_counts)
        if self.class_counts:
            out["counters_by_class"] = dict(self.class_counts)
        if self._ttft_class:
            out["ttft_by_class"] = {cls: h.summary() for cls, h
                                    in sorted(self._ttft_class.items())}
        if self.retire_counts:
            out["retired_by_reason"] = dict(self.retire_counts)
        if self._gauges:
            gauges = {}
            for name, (fn, _) in sorted(self._gauges.items()):
                try:
                    gauges[name] = round(float(fn()), 4)
                except Exception:  # pragma: no cover — gauge died
                    gauges[name] = None
            out["gauges"] = gauges
        return out


class RouterMetrics:
    """The router tier's registry (serve/router.py): client-visible
    latency histograms plus the fault-tolerance ledger — per-replica
    dispatch counts, failovers (a live stream re-driven after its
    replica died mid-decode), retries (a request re-dispatched before
    its first token), replica down/up transitions, and explicit shed by
    cause. The invariant the fault-injection harness asserts lives
    here: every submitted request is completed + shed (nothing silently
    failed)."""

    #: 'sticky_hits' counts dispatches whose replica was chosen by
    #: radix-digest prefix affinity (cache-aware routing) rather than
    #: pure least-loaded — the fleet-wide prefix reuse the tier bench
    #: leg's 2-replica drive pins.
    #: 'preempt_redispatches' counts batch streams re-driven after a
    #: voluntary class preemption timed out downstream — exempt from the
    #: shared retry_budget (they are policy, not failures), so they get
    #: their own ledger entry.
    COUNTERS = ("submitted", "dispatched", "completed", "shed",
                "tokens_out", "failovers", "retries", "replica_down",
                "replica_up", "replayed_tokens", "sticky_hits",
                "preempt_redispatches")

    def __init__(self):
        self._gauges: dict[str, tuple[Callable[[], float], str]] = {}
        self.ttft = Histogram(
            "router_ttft_seconds",
            "submit to first streamed token through the router (includes "
            "any retry/failover re-dispatch)")
        self.itl = Histogram(
            "router_itl_seconds",
            "inter-token latency at the router's client edge (a failover "
            "gap shows up as one inflated sample)")
        self.e2e = Histogram("router_e2e_seconds", "submit to done")
        self.counters = dict.fromkeys(self.COUNTERS, 0)
        self.shed_counts: dict[str, int] = {}        # cause -> n
        self.dispatch_counts: dict[str, int] = {}    # replica -> n
        self.build_info: dict[str, str] = {}         # provenance labels
        # control plane: sheds sliced by class ("cause|class") and by
        # tenant ("cause|tenant" — rate_limited is the interesting one),
        # plus per-class client-edge TTFT.
        self.shed_class_counts: dict[str, int] = {}
        self.shed_tenant_counts: dict[str, int] = {}
        self._ttft_class: dict[str, Histogram] = {}

    def inc(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def shed(self, cause: str, slo_class: Optional[str] = None,
             tenant: Optional[str] = None) -> None:
        self.counters["shed"] += 1
        self.shed_counts[cause] = self.shed_counts.get(cause, 0) + 1
        if slo_class:
            k = f"{cause}|{slo_class}"
            self.shed_class_counts[k] = self.shed_class_counts.get(k, 0) + 1
        if tenant:
            k = f"{cause}|{tenant}"
            self.shed_tenant_counts[k] = \
                self.shed_tenant_counts.get(k, 0) + 1

    def observe_ttft_class(self, slo_class: str, v: float) -> None:
        h = self._ttft_class.get(slo_class)
        if h is None:
            h = self._ttft_class[slo_class] = Histogram(
                "router_ttft_seconds",
                "submit to first token through the router, per SLO class")
        h.observe(v)

    def ttft_class(self, slo_class: str) -> Optional[Histogram]:
        return self._ttft_class.get(slo_class)

    def dispatched(self, replica: str) -> None:
        self.counters["dispatched"] += 1
        self.dispatch_counts[replica] = \
            self.dispatch_counts.get(replica, 0) + 1

    def register_gauge(self, name: str, fn: Callable[[], float],
                       help_: str = "") -> None:
        self._gauges[name] = (fn, help_)

    def set_build_info(self, **info) -> None:
        """Merge provenance labels into the router build-info gauge."""
        self.build_info.update({k: str(v) for k, v in info.items()})

    def snapshot(self) -> dict:
        """JSON-serializable state, shape-compatible with
        `ServeMetrics.snapshot()` so the same merge/render helpers work
        on router registries (federation tests, obs_report)."""
        gauges = {}
        for name, (fn, _) in sorted(self._gauges.items()):
            try:
                gauges[name] = round(float(fn()), 6)
            except Exception:  # pragma: no cover — gauge died
                gauges[name] = None
        return {"kind": "router",
                "histograms": {h.name: h.to_dict()
                               for h in (self.ttft, self.itl, self.e2e)},
                "histograms_by_class": {
                    cls: {h.name: h.to_dict()}
                    for cls, h in sorted(self._ttft_class.items())},
                "counters": dict(self.counters),
                "shed_by_cause": dict(self.shed_counts),
                "shed_by_cause_class": dict(self.shed_class_counts),
                "shed_by_cause_tenant": dict(self.shed_tenant_counts),
                "dispatch_by_replica": dict(self.dispatch_counts),
                "gauges": gauges,
                "build_info": dict(self.build_info)}

    def render_prometheus(self) -> str:
        lines: list[str] = _render_info(
            "router_build_info",
            "router config provenance (labels; value always 1)",
            self.build_info)
        for h in (self.ttft, self.itl, self.e2e):
            lines += h.render()
        for cls, h in sorted(self._ttft_class.items()):
            lines += render_hist_snap(h.to_dict(), labels={"class": cls},
                                      header=False)
        lines += ["# HELP router_requests_total router request lifecycle",
                  "# TYPE router_requests_total counter"]
        for name in ("submitted", "dispatched", "completed", "shed",
                     "failovers", "retries", "preempt_redispatches"):
            lines.append(f'router_requests_total{{event="{name}"}} '
                         f'{self.counters[name]}')
        for cause, n in sorted(self.shed_counts.items()):
            lines.append(f'router_shed_total{{cause="{cause}"}} {n}')
        for k, n in sorted(self.shed_class_counts.items()):
            cause, _, cls = k.partition("|")
            lines.append("router_shed_total"
                         f'{_labels({"cause": cause, "class": cls})} {n}')
        for k, n in sorted(self.shed_tenant_counts.items()):
            cause, _, tenant = k.partition("|")
            lines.append("router_shed_total"
                         f'{_labels({"cause": cause, "tenant": tenant})} {n}')
        for rep, n in sorted(self.dispatch_counts.items()):
            lines.append(f'router_dispatch_total{{replica="{rep}"}} {n}')
        lines += ["# HELP dispatch_sticky_hits_total dispatches routed "
                  "by radix-digest prefix affinity (cache-aware pick)",
                  "# TYPE dispatch_sticky_hits_total counter",
                  f"dispatch_sticky_hits_total "
                  f"{self.counters['sticky_hits']}"]
        lines += ["# HELP router_replica_transitions_total failure-"
                  "detector state transitions",
                  "# TYPE router_replica_transitions_total counter",
                  f'router_replica_transitions_total{{to="down"}} '
                  f"{self.counters['replica_down']}",
                  f'router_replica_transitions_total{{to="up"}} '
                  f"{self.counters['replica_up']}",
                  "# HELP router_tokens_streamed_total tokens relayed "
                  "to clients (replayed_tokens excluded — duplicate-"
                  "suppressed on failover)",
                  "# TYPE router_tokens_streamed_total counter",
                  f"router_tokens_streamed_total "
                  f"{self.counters['tokens_out']}",
                  f"router_tokens_replayed_total "
                  f"{self.counters['replayed_tokens']}"]
        for name, (fn, help_) in sorted(self._gauges.items()):
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} gauge")
            try:
                lines.append(f"{name} {float(fn())}")
            except Exception:  # pragma: no cover — gauge died
                lines.append(f"{name} NaN")
        return "\n".join(lines) + "\n"

    def summary(self) -> dict:
        """Flat dict for the bench serve_load_router leg / harness JSON."""
        out = {"ttft": self.ttft.summary(), "itl": self.itl.summary(),
               "e2e": self.e2e.summary()}
        out.update(self.counters)
        if self.build_info:
            out["build_info"] = dict(self.build_info)
        if self.shed_counts:
            out["shed_by_cause"] = dict(self.shed_counts)
        if self.shed_class_counts:
            out["shed_by_cause_class"] = dict(self.shed_class_counts)
        if self.shed_tenant_counts:
            out["shed_by_cause_tenant"] = dict(self.shed_tenant_counts)
        if self._ttft_class:
            out["ttft_by_class"] = {cls: h.summary() for cls, h
                                    in sorted(self._ttft_class.items())}
        if self.dispatch_counts:
            out["dispatch_by_replica"] = dict(self.dispatch_counts)
        if self._gauges:
            gauges = {}
            for name, (fn, _) in sorted(self._gauges.items()):
                try:
                    gauges[name] = round(float(fn()), 4)
                except Exception:  # pragma: no cover — gauge died
                    gauges[name] = None
            out["gauges"] = gauges
        return out
