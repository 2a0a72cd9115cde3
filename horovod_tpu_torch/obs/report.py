"""Step timing and the cross-rank straggler report, the port of
``horovod_tpu/obs/report.py``.

``metrics_report()`` allgathers every process's registry snapshot over
the native coordinator (the engine's control plane) and merges them on
every rank: counters sum, fixed-bucket histograms add element-wise. On
the merged snapshot :func:`build_report` builds the load-imbalance view:
fleet p50 / p99 of the step-time histogram, a per-rank table (count /
mean / p50 / p99), each rank's mean over the fleet median (skew) and
the stragglers, slowest first. The call is collective when the job has
a coordinator of more than one process, local otherwise. The
reference's METRICS timeline row waits for ``timeline.py`` (item A12).

The step time is the first present of ``step_metrics``:
``hvd_step_time_ms`` (:func:`step_timer`), the optimizer's
``hvd_optimizer_step_ms``, the serve executor's ``hvd_serve_step_ms``,
the engine's ``hvd_engine_cycle_ms``.
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Optional, Sequence

from .metrics import (MetricsRegistry, get_registry, merge_snapshots,
                      percentile_from_buckets)

#: histogram the per-rank skew table is computed from, in preference order
DEFAULT_STEP_METRICS = ("hvd_step_time_ms", "hvd_optimizer_step_ms",
                        "hvd_serve_step_ms", "hvd_engine_cycle_ms")

#: coordinator tag for the snapshot allgather; fixed string — the
#: store's per-tag sequence numbers make repeated reports unique
_REPORT_TAG = "obs-metrics-report"


@contextlib.contextmanager
def step_timer(name: str = "hvd_step_time_ms",
               registry: Optional[MetricsRegistry] = None):
    """Observe the wrapped block's wall time (ms) into the step-time
    histogram. Host-timed: on a GPU, end the block with a synchronize
    (or a readback) to time the device's work rather than its launch."""
    h = (registry or get_registry()).histogram(
        name, "per-step wall time (ms), worker-loop timed")
    t0 = time.perf_counter()
    try:
        yield h
    finally:
        h.observe((time.perf_counter() - t0) * 1000.0)


def _hist_rollup(entry: Optional[dict]) -> Optional[dict]:
    if entry is None or not entry.get("count"):
        return None
    b, c = entry["bounds"], entry["counts"]
    p50 = percentile_from_buckets(b, c, 0.50)
    p99 = percentile_from_buckets(b, c, 0.99)
    return {"count": int(entry["count"]),
            "mean_ms": round(entry["sum"] / entry["count"], 3),
            "p50_ms": None if p50 is None else round(p50, 3),
            "p99_ms": None if p99 is None else round(p99, 3)}


def _find_hist(snap: dict, name: str) -> Optional[dict]:
    """The series' unlabeled child, or the sum of its labeled children
    (e.g. hvd_serve_step_ms{kind=prefill|decode})."""
    entries = [e for e in snap.get("histograms", []) if e["name"] == name]
    if not entries:
        return None
    if len(entries) == 1:
        return entries[0]
    return merge_snapshots([{"histograms": [dict(e, labels={})]}
                            for e in entries])["histograms"][0]


def _recovery_rollup(snaps: Sequence[dict],
                     merged: dict) -> Optional[dict]:
    """The fleet's elastic-recovery view: merged
    ``hvd_elastic_recovery_ms`` histogram rollup plus ``last_ms`` — the
    slowest rank's most recent recovery (gauges must NOT be read from
    the merged snapshot, which sums them; take the per-rank max)."""
    roll = _hist_rollup(_find_hist(merged, "hvd_elastic_recovery_ms"))
    if roll is None:
        return None
    last = [e["value"] for snap in snaps
            for e in snap.get("gauges", [])
            if e["name"] == "hvd_elastic_last_recovery_ms"
            and e["value"] > 0]
    roll["last_ms"] = round(max(last), 3) if last else None
    return roll


def _median(vals: Sequence[float]) -> float:
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def build_report(snaps: Sequence[dict], *,
                 step_metrics: Sequence[str] = DEFAULT_STEP_METRICS,
                 rank: int = 0) -> dict:
    """Pure merge+rank core of ``metrics_report`` (unit-testable without
    a coordinator). ``snaps`` is one registry snapshot per rank, rank
    order."""
    merged = merge_snapshots(snaps)
    step_metric = next(
        (m for m in step_metrics if _find_hist(merged, m) is not None),
        None)
    report = {"world_size": len(snaps), "rank": rank, "merged": merged,
              "step_metric": step_metric, "step_time": None,
              "per_rank": {}, "skew": None, "stragglers": [],
              "recovery": _recovery_rollup(snaps, merged)}
    if step_metric is None:
        return report
    report["step_time"] = _hist_rollup(_find_hist(merged, step_metric))
    per_rank = {}
    for r, snap in enumerate(snaps):
        roll = _hist_rollup(_find_hist(snap, step_metric))
        if roll is not None:
            per_rank[r] = roll
    report["per_rank"] = per_rank
    if per_rank:
        med = _median([v["mean_ms"] for v in per_rank.values()]) or None
        ranking = sorted(per_rank.items(),
                         key=lambda kv: kv[1]["mean_ms"], reverse=True)
        report["stragglers"] = [
            {"rank": r, **roll,
             "skew": (round(roll["mean_ms"] / med, 3)
                      if med else None)}
            for r, roll in ranking]
        if med:
            report["skew"] = {
                "median_mean_ms": round(med, 3),
                "max_over_median": report["stragglers"][0]["skew"]}
    return report


def metrics_report(*, registry: Optional[MetricsRegistry] = None,
                   step_metrics: Sequence[str] = DEFAULT_STEP_METRICS
                   ) -> dict:
    """Fleet-wide metrics report (collective in multi-process mode).

    Every process contributes its registry snapshot over the native
    coordinator; every process gets the same merged report back (so any
    rank can act on it — e.g. the launcher's rank 0 logs the straggler
    table). Single-process/SPMD mode reports locally.
    """
    reg = registry or get_registry()
    snap = reg.snapshot()
    snaps, rank = [snap], 0
    coord = _runtime_coordinator()
    if coord is not None and coord.size > 1:
        blob = json.dumps(snap, sort_keys=True).encode()
        # the allgather reply packs ALL ranks' blobs into one buffer:
        # size the cap by the fleet (peers' snapshots are the same
        # families, so 2x our own blob per rank is a generous bound)
        cap = max(1 << 22, coord.size * (2 * len(blob) + 4096))
        blobs = coord.allgather(blob, tag=_REPORT_TAG, max_bytes=cap)
        snaps = [json.loads(b.decode()) for b in blobs]
        rank = coord.rank
    return build_report(snaps, step_metrics=step_metrics, rank=rank)


def _runtime_coordinator() -> Optional[object]:
    """The live runtime's coordinator, if initialized."""
    from ..core import basics
    if not basics.is_initialized():
        return None
    return basics.get_state().coordinator
