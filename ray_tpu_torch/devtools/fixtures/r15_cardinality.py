"""R15 fixture: metric tags must not carry unbounded runtime values."""
from ray_tpu_torch.util import metrics

_counter = metrics.Counter("fixture_requests", "fixture")
_gauge = metrics.Gauge("fixture_state", "fixture")


def unbounded_hex(oid):
    _counter.inc(tags={"object_id": oid.hex()})


def unbounded_name(task_id, peer_addr):
    _gauge.set(1.0, tags={"task": task_id, "peer": peer_addr})


def unbounded_fstring(trace_id):
    _counter.inc(tags={"trace": f"trace-{trace_id}"})


def unbounded_default_tags(node_id):
    _gauge.set_default_tags({"node": node_id.hex()})


def allowed_small_cluster(peer):
    # raylint: allow(metrics-cardinality) bounded by cluster size
    _counter.inc(tags={"peer": peer})


def clean(route):
    _counter.inc(tags={"route": "/a", "method": "GET"})
    _gauge.set(0.0, tags={"phase": route})
