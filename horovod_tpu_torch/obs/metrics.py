"""Zero-dependency, thread-safe metrics primitives + labeled registry.

The port's own copy of the reference's registry
(``horovod_tpu/obs/metrics.py``): ``Counter`` / ``Gauge`` /
``Histogram`` behind one ``MetricsRegistry`` with ``snapshot()`` and
``to_prometheus()``. Histogram buckets are fixed log-spaced bounds, so
two histograms of the same series merge by bucket addition and
percentiles are read back with linear in-bucket interpolation.

A component that is re-constructed within one process calls
``registry.unregister(name)`` before re-creating its series, so its
instance-level views count from zero. :class:`HistogramWindow` reads
windowed percentiles off a live histogram; :func:`merge_snapshots` and
:func:`snapshot_to_prometheus` merge several registries' snapshots and
render the result. stdlib only.
"""
from __future__ import annotations

import math
import re
import threading
from collections import OrderedDict
from typing import (Callable, Dict, Iterable, List, Optional,
                    Sequence, Tuple)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def log_buckets(lo: float, hi: float) -> Tuple[float, ...]:
    """Fixed log-spaced bucket bounds: the (1, 2.5, 5) mantissa ladder
    over every decade touching [lo, hi]."""
    if not (lo > 0 and hi > lo):
        raise ValueError(f"need 0 < lo < hi; got {lo}, {hi}")
    out: List[float] = []
    e = math.floor(math.log10(lo) + 1e-9)
    while True:
        for m in (1.0, 2.5, 5.0):
            v = m * (10.0 ** e)
            v = float(f"{v:.6g}")       # kill 1e-17 float dust
            if v > hi * (1 + 1e-9):
                return tuple(out)
            if v >= lo * (1 - 1e-9):
                out.append(v)
        e += 1


#: default latency ladder (milliseconds): 0.1 ms .. 100 s
LATENCY_MS_BUCKETS = log_buckets(0.1, 100_000.0)
#: payload sizes (bytes): 100 B .. 10 GB
BYTES_BUCKETS = log_buckets(100.0, 1e10)
#: small counts (tensors per fusion bucket ...): 1 .. 10k
COUNT_BUCKETS = log_buckets(1.0, 10_000.0)


def _fmt(v: float) -> str:
    """Prometheus sample formatting: integers without a trailing .0."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace("\n", r"\n").replace(
        '"', r"\"")


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    """Monotonic counter. ``inc`` only; negative increments raise."""

    __slots__ = ("labels", "_value", "_lock")

    def __init__(self, labels: Optional[Dict[str, str]] = None):
        self.labels = dict(labels or {})
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counters only go up; got inc({n})")
        with self._lock:
            self._value += n

    def _set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value; settable, or backed by a callback."""

    __slots__ = ("labels", "_value", "_fn", "_lock")

    def __init__(self, labels: Optional[Dict[str, str]] = None):
        self.labels = dict(labels or {})
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._fn = None
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    def set_fn(self, fn: Callable[[], float]) -> None:
        """Sample ``fn()`` at read time."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            v = float(fn())
        except Exception:  # noqa: BLE001 — a dead callback must not
            with self._lock:    # take down /metrics: report the last
                return self._value   # good sample instead
        with self._lock:
            if self._fn is not fn:
                return self._value
            self._value = v
        return v


class Histogram:
    """Fixed-bound histogram; per-bucket counts + sum + count.

    ``counts`` has ``len(bounds) + 1`` entries — the last is the
    overflow (+Inf) bucket."""

    __slots__ = ("labels", "bounds", "counts", "sum", "count", "_lock")

    def __init__(self, bounds: Sequence[float],
                 labels: Optional[Dict[str, str]] = None):
        b = tuple(float(x) for x in bounds)
        if not b or list(b) != sorted(set(b)):
            raise ValueError(
                f"histogram bounds must be strictly ascending; got {b}")
        self.labels = dict(labels or {})
        self.bounds = b
        self.counts = [0] * (len(b) + 1)
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        for i, bound in enumerate(self.bounds):
            if v <= bound:
                break
        else:
            i = len(self.bounds)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def percentile(self, q: float) -> Optional[float]:
        with self._lock:
            counts = list(self.counts)
        return percentile_from_buckets(self.bounds, counts, q)

    @property
    def mean(self) -> Optional[float]:
        with self._lock:
            return (self.sum / self.count) if self.count else None


def percentile_from_buckets(bounds: Sequence[float],
                            counts: Sequence[int],
                            q: float) -> Optional[float]:
    """q-th percentile (q in [0, 1]) from cumulative bucket math with
    linear interpolation inside the landing bucket. None on an empty
    histogram; a landing in the +Inf bucket reports the highest bound."""
    total = sum(counts)
    if total <= 0:
        return None
    target = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if cum + c >= target - 1e-12:
            if i >= len(bounds):          # overflow bucket
                return float(bounds[-1])
            lo = 0.0 if i == 0 else float(bounds[i - 1])
            hi = float(bounds[i])
            frac = (target - cum) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        cum += c
    return float(bounds[-1])


class HistogramWindow:
    """Windowed percentiles over a live :class:`Histogram`: diff the
    bucket counts against the previous ``sample()`` and interpolate the
    percentile from the DELTA — so a burst shows up within one poll
    instead of being averaged away by the process-lifetime histogram.

    Optional EWMA smoothing (``alpha`` in (0, 1]; ``alpha=1`` disables
    the memory), the reference's semantics exactly.

    Stateful but histogram-agnostic: ``sample(h)`` windows whichever
    histogram it is handed (keyed by object identity), returning the
    smoothed windowed percentile or the previous value when the window saw no new observations (a quiet
    poll must not read as "latency recovered"). Not thread-safe; each
    sampler thread owns its window.
    """

    __slots__ = ("_q", "_alpha", "_last_counts", "_ewma")

    def __init__(self, q: float = 0.99, alpha: float = 1.0):
        if not (0.0 <= q <= 1.0):
            raise ValueError(f"quantile must be in [0, 1]; got {q}")
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1]; got {alpha}")
        self._q = float(q)
        self._alpha = float(alpha)
        self._last_counts: Dict[int, List[int]] = {}
        self._ewma: Optional[float] = None

    @property
    def value(self) -> Optional[float]:
        """The last smoothed sample (None until one lands)."""
        return self._ewma

    def sample(self, h: Optional[Histogram]) -> Optional[float]:
        """Window ``h`` against the previous call: percentile of the
        bucket-count delta, EWMA-merged. ``h=None`` (series not created
        yet) and an empty window both carry the previous value."""
        if h is None:
            return self._ewma
        with h._lock:
            counts = list(h.counts)
        prev = self._last_counts.get(id(h))
        self._last_counts = {id(h): counts}
        if prev is None or len(prev) != len(counts):
            return self._ewma
        delta = [max(c - p, 0) for c, p in zip(counts, prev)]
        p = percentile_from_buckets(h.bounds, delta, self._q)
        if p is None:
            return self._ewma
        if self._ewma is None:
            self._ewma = float(p)
        else:
            self._ewma += self._alpha * (float(p) - self._ewma)
        return self._ewma


class _Family:
    __slots__ = ("name", "kind", "help", "bounds", "children")

    def __init__(self, name: str, kind: str, help_: str,
                 bounds: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.kind = kind
        self.help = help_
        self.bounds = bounds
        self.children: "OrderedDict[Tuple, object]" = OrderedDict()


class MetricsRegistry:
    """Named, labeled metric families. Thread-safe; one per process in
    practice (``get_registry()``), but instantiable for tests."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: "OrderedDict[str, _Family]" = OrderedDict()

    def _family(self, name: str, kind: str, help_: str,
                bounds: Optional[Sequence[float]] = None) -> _Family:
        if not _NAME_RE.match(name or ""):
            raise ValueError(f"invalid metric name {name!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, help_,
                              tuple(bounds) if bounds else None)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"not {kind}")
            if help_ and not fam.help:
                fam.help = help_
            return fam

    def _child(self, fam: _Family, labels: Optional[Dict[str, str]],
               ctor) -> object:
        labels = {str(k): str(v) for k, v in (labels or {}).items()}
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"invalid label name {k!r}")
        key = tuple(sorted(labels.items()))
        with self._lock:
            child = fam.children.get(key)
            if child is None:
                child = ctor(labels)
                fam.children[key] = child
            return child

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        fam = self._family(name, "counter", help)
        return self._child(fam, labels, Counter)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        fam = self._family(name, "gauge", help)
        return self._child(fam, labels, Gauge)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        fam = self._family(name, "histogram", help,
                           bounds or LATENCY_MS_BUCKETS)
        return self._child(fam, labels,
                           lambda lb: Histogram(fam.bounds, lb))

    def unregister(self, name: str) -> None:
        """Drop a family (and all its children)."""
        with self._lock:
            self._families.pop(name, None)

    def get(self, name: str,
            labels: Optional[Dict[str, str]] = None) -> Optional[object]:
        """Existing child or None (never creates)."""
        key = tuple(sorted({str(k): str(v)
                            for k, v in (labels or {}).items()}.items()))
        with self._lock:
            fam = self._families.get(name)
            return fam.children.get(key) if fam else None

    def snapshot(self) -> dict:
        """JSON-serializable dump of every series."""
        out = {"counters": [], "gauges": [], "histograms": []}
        with self._lock:
            fams = [(f.name, f.kind, list(f.children.values()))
                    for f in self._families.values()]
        for name, kind, children in fams:
            for c in children:
                if kind == "counter":
                    out["counters"].append(
                        {"name": name, "labels": c.labels,
                         "value": c.value})
                elif kind == "gauge":
                    out["gauges"].append(
                        {"name": name, "labels": c.labels,
                         "value": c.value})
                else:
                    with c._lock:
                        out["histograms"].append(
                            {"name": name, "labels": dict(c.labels),
                             "bounds": list(c.bounds),
                             "counts": list(c.counts),
                             "sum": c.sum, "count": c.count})
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (format version 0.0.4)."""
        lines: List[str] = []
        with self._lock:
            fams = [(f.name, f.kind, f.help, list(f.children.values()))
                    for f in self._families.values()]
        for name, kind, help_, children in sorted(fams,
                                                  key=lambda f: f[0]):
            if not children:
                continue
            if help_:
                lines.append(f"# HELP {name} {_escape(help_)}")
            lines.append(f"# TYPE {name} {kind}")
            for c in sorted(children,
                            key=lambda m: sorted(m.labels.items())):
                if kind in ("counter", "gauge"):
                    lines.append(
                        f"{name}{_label_str(c.labels)} {_fmt(c.value)}")
                    continue
                with c._lock:
                    counts, hsum, hcount = \
                        list(c.counts), c.sum, c.count
                cum = 0
                for bound, cnt in zip(c.bounds, counts):
                    cum += cnt
                    lb = dict(c.labels, le=_fmt(bound))
                    lines.append(f"{name}_bucket{_label_str(lb)} {cum}")
                lb = dict(c.labels, le="+Inf")
                lines.append(
                    f"{name}_bucket{_label_str(lb)} {hcount}")
                lines.append(
                    f"{name}_sum{_label_str(c.labels)} {_fmt(hsum)}")
                lines.append(
                    f"{name}_count{_label_str(c.labels)} {hcount}")
        return "\n".join(lines) + ("\n" if lines else "")


#: the process-global registry every runtime component instruments into
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY


def merge_snapshots(snaps: Iterable[dict]) -> dict:
    """Merge per-rank ``snapshot()`` dicts into one fleet-wide snapshot:
    counters and gauges sum by (name, labels); histograms add their
    bucket counts element-wise (bounds must match — they do, because
    every rank runs the same code with the same fixed buckets)."""
    counters: "OrderedDict[Tuple, dict]" = OrderedDict()
    gauges: "OrderedDict[Tuple, dict]" = OrderedDict()
    hists: "OrderedDict[Tuple, dict]" = OrderedDict()
    for snap in snaps:
        for e in snap.get("counters", []):
            key = (e["name"], tuple(sorted(e.get("labels", {}).items())))
            slot = counters.setdefault(
                key, {"name": e["name"],
                      "labels": dict(e.get("labels", {})), "value": 0.0})
            slot["value"] += e["value"]
        for e in snap.get("gauges", []):
            key = (e["name"], tuple(sorted(e.get("labels", {}).items())))
            slot = gauges.setdefault(
                key, {"name": e["name"],
                      "labels": dict(e.get("labels", {})), "value": 0.0})
            slot["value"] += e["value"]
        for e in snap.get("histograms", []):
            key = (e["name"], tuple(sorted(e.get("labels", {}).items())))
            slot = hists.get(key)
            if slot is None:
                hists[key] = {"name": e["name"],
                              "labels": dict(e.get("labels", {})),
                              "bounds": list(e["bounds"]),
                              "counts": list(e["counts"]),
                              "sum": float(e["sum"]),
                              "count": int(e["count"])}
                continue
            if slot["bounds"] != list(e["bounds"]):
                raise ValueError(
                    f"histogram {e['name']!r}: bucket bounds differ "
                    f"across ranks — not mergeable")
            slot["counts"] = [a + b for a, b in
                              zip(slot["counts"], e["counts"])]
            slot["sum"] += e["sum"]
            slot["count"] += e["count"]
    return {"counters": list(counters.values()),
            "gauges": list(gauges.values()),
            "histograms": list(hists.values())}


def snapshot_to_prometheus(snap: dict,
                           help_from: Optional["MetricsRegistry"] = None
                           ) -> str:
    """Render a ``snapshot()``/``merge_snapshots()`` dict as Prometheus
    text exposition — the fleet-wide ``/metrics?fleet=1`` read path
    (serve/http.py), where the merged series exist only as a snapshot,
    never as a live registry. HELP/TYPE lines come from ``help_from``
    (the local registry, which carries the same families) when the
    family exists there; TYPE is always derivable from the snapshot
    section."""
    lines: List[str] = []
    by_name: Dict[str, Tuple[str, List[dict]]] = {}
    for kind, section in (("counter", "counters"), ("gauge", "gauges"),
                          ("histogram", "histograms")):
        for e in snap.get(section, []):
            by_name.setdefault(e["name"], (kind, []))[1].append(e)
    for name in sorted(by_name):
        kind, entries = by_name[name]
        help_ = ""
        if help_from is not None:
            fam = help_from._families.get(name)
            if fam is not None:
                help_ = fam.help
        if help_:
            lines.append(f"# HELP {name} {_escape(help_)}")
        lines.append(f"# TYPE {name} {kind}")
        for e in sorted(entries,
                        key=lambda m: sorted(m.get("labels", {}).items())):
            labels = {str(k): str(v)
                      for k, v in e.get("labels", {}).items()}
            if kind in ("counter", "gauge"):
                lines.append(
                    f"{name}{_label_str(labels)} {_fmt(e['value'])}")
                continue
            cum = 0
            for bound, cnt in zip(e["bounds"], e["counts"]):
                cum += cnt
                lb = dict(labels, le=_fmt(float(bound)))
                lines.append(f"{name}_bucket{_label_str(lb)} {cum}")
            lb = dict(labels, le="+Inf")
            lines.append(f"{name}_bucket{_label_str(lb)} {e['count']}")
            lines.append(f"{name}_sum{_label_str(labels)} "
                         f"{_fmt(e['sum'])}")
            lines.append(f"{name}_count{_label_str(labels)} "
                         f"{e['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


#: help strings of the KV integrity and KV tier families, one literal per
#: family, the reference's (``horovod_tpu/serve/batcher.py`` and
#: ``serve/kvtier/tier.py``): every registration site reads them here
KV_CORRUPTIONS_HELP = ("KV slots whose verify-on-read crc failed "
                       "(corruption caught before reaching a client)")
KVTIER_DEMOTIONS_HELP = ("prefix-run blocks demoted down the KV tier ladder "
                         "(tier = where they landed)")
KVTIER_PROMOTIONS_HELP = ("prefix-run blocks promoted back to HBM through "
                          "the verified install path (tier = where they "
                          "came from)")
KVTIER_HITS_HELP = "KV tier lookups that found a promotable block (by tier)"
KVTIER_MISSES_HELP = ("KV tier lookups that found nothing promotable (the "
                      "re-prefill fallback)")
KVTIER_BYTES_HELP = "bytes resident in a KV tier (by tier)"
KVTIER_CORRUPT_HELP = ("KV tier blocks whose crc32 failed verification "
                       "(caught before any device byte landed)")
KVTIER_PULLS_HELP = ("cross-replica prefix-run pulls over the migration wire "
                     "(router-orchestrated, crc-gated on arrival)")
KVTIER_ROUTED_HELP = ("requests dispatched to the replica the fleet index "
                      "says holds their longest cached prefix run")
MIGRATE_CORRUPT_HELP = ("migrated-KV payloads whose per-block crc failed on "
                        "arrival (corruption caught before install)")
