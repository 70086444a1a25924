"""Host-side metrics plane: counters, gauges and histograms, the
counterpart of ``src/repro/serving/metrics.py`` (the same classes, names
and OpenMetrics exposition, byte for byte).

* **Zero device syncs.** Every value recorded here is a plain Python
  number already on the host (queue lengths, epoch counters, wall-clock
  seconds); nothing here touches a tensor, so a scrape never waits on the
  card.
* **Consistent snapshots.** One :class:`MetricsRegistry` owns one lock;
  every update and the whole :meth:`MetricsRegistry.snapshot` serialize on
  it, so related metrics written under one ``registry.lock`` hold (the
  shadow queue's enqueue counter and depth gauge) are never seen torn.
* **Cheap.** An update is one uncontended lock acquire and an int/float
  op; histograms keep a bounded reservoir (halved by decimation when
  full).

The shadow queue mirrors its stats here under ``shadow/...`` names; the
adaptive drain policy (:class:`repro_torch.core.shadow.AdaptiveDrainPolicy`)
fits its cost model on the same drain observations.
"""
from __future__ import annotations

import re
import threading


class Counter:
    """Monotone counter. ``inc`` only; a decreasing value is a bug the
    snapshot-consistency tests would flag."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: threading.RLock):
        self.name = name
        self.value = 0
        self._lock = lock

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def get(self) -> int:
        with self._lock:
            return self.value


class Gauge:
    """Last-write-wins instantaneous value (queue depth, staleness)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: threading.RLock):
        self.name = name
        self.value = 0.0
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v

    def get(self) -> float:
        with self._lock:
            return self.value


class Histogram:
    """Bounded-reservoir distribution (drain cost, staleness-at-drain).

    Keeps exact count/total plus a reservoir of observed values for
    percentiles; when the reservoir fills it is decimated (every other
    sample dropped, stride doubled) so long runs keep a uniform-ish
    spread at O(max_samples) memory. Percentiles are nearest-rank over
    the reservoir — plenty for p50/p99 reporting.
    """

    __slots__ = ("name", "count", "total", "_samples", "_stride", "_skip",
                 "_max", "_lock")

    def __init__(self, name: str, lock: threading.RLock,
                 max_samples: int = 2048):
        self.name = name
        self.count = 0
        self.total = 0.0
        self._samples: list[float] = []
        self._stride = 1          # keep every _stride-th observation
        self._skip = 0
        self._max = max_samples
        self._lock = lock

    def observe(self, v: float) -> None:
        with self._lock:
            self.count += 1
            self.total += v
            self._skip += 1
            if self._skip >= self._stride:
                self._skip = 0
                self._samples.append(float(v))
                if len(self._samples) >= self._max:
                    self._samples = self._samples[::2]
                    self._stride *= 2

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the reservoir (0 when empty)."""
        with self._lock:
            if not self._samples:
                return 0.0
            s = sorted(self._samples)
            k = min(len(s) - 1, max(0, int(round(p / 100.0 * (len(s) - 1)))))
            return s[k]

    @property
    def mean(self) -> float:
        with self._lock:
            return self.total / self.count if self.count else 0.0

    def summary(self) -> dict:
        with self._lock:
            s = sorted(self._samples)

            def pct(p):
                if not s:
                    return 0.0
                return s[min(len(s) - 1,
                             max(0, int(round(p / 100.0 * (len(s) - 1)))))]
            return {"count": self.count, "total": self.total,
                    "mean": (self.total / self.count if self.count
                             else 0.0),
                    "p50": pct(50.0), "p99": pct(99.0)}


class MetricsRegistry:
    """Named metric store with get-or-create accessors and one shared
    lock (see module doc for why a single lock). Metric kinds are
    type-stable per name: asking for an existing name with a different
    kind raises rather than silently aliasing."""

    def __init__(self):
        self.lock = threading.RLock()
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, name: str, kind):
        with self.lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = kind(name, self.lock)
            elif type(m) is not kind:
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {kind.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> dict:
        """One consistent host-side view: ``{name: number}`` for
        counters/gauges, ``{name: {count,total,mean,p50,p99}}`` for
        histograms. Taken under the registry lock, so no update can
        interleave mid-snapshot (no torn reads across related metrics)."""
        with self.lock:
            out = {}
            for name in sorted(self._metrics):
                m = self._metrics[name]
                if isinstance(m, Histogram):
                    out[name] = m.summary()
                elif isinstance(m, Counter):
                    out[name] = m.value
                else:
                    out[name] = m.value
            return out

    def to_openmetrics(self) -> str:
        """Render one consistent snapshot in OpenMetrics / Prometheus
        text exposition format, scrape-ready:

        - counters → ``# TYPE name counter`` + ``name_total``
        - gauges → ``# TYPE name gauge`` + ``name``
        - histograms → ``# TYPE name summary`` with ``quantile="0.5"``
          / ``quantile="0.99"`` series plus ``name_sum``/``name_count``
          (the reservoir keeps exact count/total; quantiles are the
          same nearest-rank values :meth:`Histogram.summary` reports)

        Metric names are sanitized to the OpenMetrics charset (the
        registry's ``/``-separated paths become ``_``-separated), and
        the exposition ends with the mandatory ``# EOF`` marker.
        Rendered under the registry lock — same no-torn-reads guarantee
        as :meth:`snapshot`.
        """
        lines: list[str] = []
        with self.lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                om = _openmetrics_name(name)
                if isinstance(m, Counter):
                    lines.append(f"# TYPE {om} counter")
                    lines.append(f"{om}_total {_fmt(m.value)}")
                elif isinstance(m, Gauge):
                    lines.append(f"# TYPE {om} gauge")
                    lines.append(f"{om} {_fmt(m.value)}")
                else:
                    s = m.summary()
                    lines.append(f"# TYPE {om} summary")
                    lines.append(
                        f'{om}{{quantile="0.5"}} {_fmt(s["p50"])}')
                    lines.append(
                        f'{om}{{quantile="0.99"}} {_fmt(s["p99"])}')
                    lines.append(f"{om}_sum {_fmt(s['total'])}")
                    lines.append(f"{om}_count {s['count']}")
        lines.append("# EOF")
        return "\n".join(lines) + "\n"


def _openmetrics_name(name: str) -> str:
    """Map a registry path to the OpenMetrics name charset
    (``[a-zA-Z_:][a-zA-Z0-9_:]*``)."""
    om = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not om or not re.match(r"[a-zA-Z_:]", om[0]):
        om = "_" + om
    return om


def _fmt(v) -> str:
    """Render a metric value: ints verbatim, floats via repr (full
    precision, no scientific-notation surprises for typical ranges)."""
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)
