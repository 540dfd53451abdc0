"""User-defined and runtime metrics with Prometheus exposition.

Parity with ``python/ray/util/metrics.py`` (Counter :155, Histogram :220,
Gauge :295) and the export side of the reference's metrics agent
(``python/ray/_private/metrics_agent.py:63,197`` — OpenCensus aggregation
to a Prometheus endpoint). One in-process registry replaces the per-node
agent: the host-granular runtime has one process per host, so exposition
is a text endpoint on the driver process.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

_DEFAULT_HISTOGRAM_BOUNDARIES = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0)


class _Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, "Metric"] = {}

    def register(self, metric: "Metric"):
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None and type(existing) is not type(metric):
                raise ValueError(
                    f"metric {metric.name!r} already registered with a "
                    f"different type")
            self._metrics[metric.name] = metric

    def metrics(self) -> List["Metric"]:
        with self._lock:
            return list(self._metrics.values())

    def clear(self):
        with self._lock:
            self._metrics.clear()


_registry = _Registry()

# Extra sample sources: callables returning snapshot()-shaped family
# dicts, merged into every snapshot/exposition.  The perf plane
# (observability/perf.py) registers here so its lock-free histograms
# export without living inside the registry's Metric class hierarchy.
_sources_lock = threading.Lock()
_extra_sources: List = []  # raylint: guarded-by(_sources_lock)


def register_sample_source(fn) -> None:
    """Register a zero-arg callable returning a list of family dicts
    (``{"name","type","help","samples",...}``) to include in
    :func:`snapshot` and the Prometheus expositions."""
    with _sources_lock:
        if fn not in _extra_sources:
            _extra_sources.append(fn)


def _extra_families() -> List[dict]:
    with _sources_lock:
        sources = list(_extra_sources)
    out: List[dict] = []
    for fn in sources:
        try:
            out.extend(fn())
        except Exception:  # raylint: allow(swallow) one bad source must not kill the scrape
            pass
    return out


def _escape_label(value: str) -> str:
    """Prometheus label escaping: backslash, quote, newline — one bad
    value must not invalidate the whole scrape."""
    return (str(value).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _fmt_tags(tags: Tuple[Tuple[str, str], ...]) -> str:
    if not tags:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in tags)
    return "{" + inner + "}"


class Metric:
    """Base: named, described, tagged. Subclasses record values."""

    TYPE = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        if not name or any(c in name for c in " -"):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys or ())
        self._lock = threading.Lock()
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}  # raylint: guarded-by(self._lock)
        self._default_tags: Dict[str, str] = {}  # raylint: guarded-by(self._lock)
        _registry.register(self)

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        with self._lock:
            self._default_tags = dict(tags)
        return self

    def _key(self, tags: Optional[Dict[str, str]]
             ) -> Tuple[Tuple[str, str], ...]:
        with self._lock:
            merged = dict(self._default_tags)
        if tags:
            unknown = set(tags) - set(self.tag_keys)
            if unknown:
                raise ValueError(
                    f"unknown tag keys {sorted(unknown)} for {self.name!r} "
                    f"(declared: {list(self.tag_keys)})")
            merged.update(tags)
        return tuple(sorted(merged.items()))

    def samples(self) -> List[Tuple[str, Tuple[Tuple[str, str], ...], float]]:
        with self._lock:
            return [(self.name, tags, v) for tags, v in self._values.items()]


class Counter(Metric):
    """Monotonic count (``metrics.py:155``)."""

    TYPE = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None):
        if value < 0:
            raise ValueError("counters only increase")
        key = self._key(tags)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value


class Gauge(Metric):
    """Point-in-time value (``metrics.py:295``)."""

    TYPE = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        key = self._key(tags)  # outside the lock: _key re-acquires it
        with self._lock:
            self._values[key] = float(value)


class Histogram(Metric):
    """Bucketed distribution (``metrics.py:220``)."""

    TYPE = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[Sequence[float]] = None,
                 tag_keys: Optional[Sequence[str]] = None):
        super().__init__(name, description, tag_keys)
        self.boundaries = tuple(sorted(boundaries
                                       or _DEFAULT_HISTOGRAM_BOUNDARIES))
        self._buckets: Dict[Tuple[Tuple[str, str], ...], List[int]] = {}  # raylint: guarded-by(self._lock)
        self._sums: Dict[Tuple[Tuple[str, str], ...], float] = {}  # raylint: guarded-by(self._lock)
        self._counts: Dict[Tuple[Tuple[str, str], ...], int] = {}  # raylint: guarded-by(self._lock)

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        key = self._key(tags)
        with self._lock:
            buckets = self._buckets.setdefault(
                key, [0] * (len(self.boundaries) + 1))
            idx = len(self.boundaries)
            for i, b in enumerate(self.boundaries):
                if value <= b:
                    idx = i
                    break
            buckets[idx] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._counts[key] = self._counts.get(key, 0) + 1

    def samples(self):
        out = []
        with self._lock:
            for key, buckets in self._buckets.items():
                cum = 0
                for b, n in zip(self.boundaries, buckets):
                    cum += n
                    out.append((f"{self.name}_bucket",
                                key + (("le", str(b)),), float(cum)))
                cum += buckets[-1]
                out.append((f"{self.name}_bucket",
                            key + (("le", "+Inf"),), float(cum)))
                out.append((f"{self.name}_sum", key, self._sums[key]))
                out.append((f"{self.name}_count", key,
                            float(self._counts[key])))
        return out


def generate_prometheus_text() -> str:
    """Prometheus text exposition format of every registered metric."""
    lines = []
    for m in _registry.metrics():
        if m.description:
            lines.append(f"# HELP {m.name} {m.description}")
        lines.append(f"# TYPE {m.name} {m.TYPE}")
        for name, tags, value in m.samples():
            lines.append(f"{name}{_fmt_tags(tags)} {value}")
    for fam in _extra_families():
        if fam.get("help"):
            lines.append(f"# HELP {fam['name']} {fam['help']}")
        lines.append(f"# TYPE {fam['name']} {fam['type']}")
        for name, tags, value in fam["samples"]:
            lines.append(f"{name}{_fmt_tags(tuple(map(tuple, tags)))} {value}")
    return "\n".join(lines) + "\n"


def snapshot() -> List[dict]:
    """JSON-able dump of every registered metric — the per-host half of
    cluster metrics federation (shipped in NODE_DEBUG replies and merged
    by the dashboard head into one exposition)."""
    out = []
    for m in _registry.metrics():
        out.append({
            "name": m.name,
            "type": m.TYPE,
            "help": m.description,
            "samples": [[name, list(map(list, tags)), value]
                        for name, tags, value in m.samples()],
        })
    out.extend(_extra_families())
    return out


def render_federated(snapshots: Dict[str, List[dict]],
                     missing_hosts: Optional[List[dict]] = None) -> str:
    """Prometheus text for many hosts' :func:`snapshot` dumps, each
    sample labeled with its source ``node`` — the cluster-wide exposition
    endpoint (one scrape covers every host, the reference's per-node
    metrics agents rolled up by the dashboard). Hosts the head could not
    reach this scrape surface as ``federation_missing_hosts`` samples so
    alerting can distinguish "node quiet" from "node unscraped"."""
    lines = []
    typed = set()
    for node, families in snapshots.items():
        for fam in families:
            if fam["name"] not in typed:
                typed.add(fam["name"])
                if fam.get("help"):
                    lines.append(f"# HELP {fam['name']} {fam['help']}")
                lines.append(f"# TYPE {fam['name']} {fam['type']}")
            for name, tags, value in fam["samples"]:
                merged = (("node", node),) + tuple(
                    (k, v) for k, v in tags)
                lines.append(f"{name}{_fmt_tags(merged)} {value}")
    if missing_hosts:
        lines.append("# HELP federation_missing_hosts Hosts registered "
                     "alive but unreachable during this federated scrape")
        lines.append("# TYPE federation_missing_hosts gauge")
        for h in missing_hosts:
            tags = (("node", str(h.get("node_id", ""))[:8]),
                    ("address", str(h.get("address", ""))))
            lines.append(f"federation_missing_hosts{_fmt_tags(tags)} 1.0")
    return "\n".join(lines) + "\n"


_server = None


def start_metrics_server(port: int = 0) -> int:
    """Serve ``/metrics`` on a daemon thread; returns the bound port
    (the reference's Prometheus endpoint, ``metrics_agent.py:197``)."""
    global _server
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path not in ("/metrics", "/"):
                self.send_response(404)
                self.end_headers()
                return
            body = generate_prometheus_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    _server = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
    t = threading.Thread(target=_server.serve_forever, daemon=True,
                         name="metrics-server")
    t.start()
    return _server.server_address[1]


def stop_metrics_server():
    global _server
    if _server is not None:
        _server.shutdown()
        _server.server_close()  # release the listening socket now, not at GC
        _server = None
