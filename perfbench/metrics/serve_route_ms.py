"""serve_route_ms: the mean of the program's ``serve.route`` histogram
(a request's handle call to its admission by the replica: the router's
pick, the actor call's submit and transport, the actor thread's pick-up)
over the window; the perf plane is on in traced runs."""

from perfbench.core.readers import perf_mean_ms


def read(record):
    if record.get("kind") != "serve":
        return None
    return perf_mean_ms(record, "serve.route")
