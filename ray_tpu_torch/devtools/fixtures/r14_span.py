"""R14 fixture: spans must be context-managed outside observability."""
from ray_tpu_torch import observability
from ray_tpu_torch.observability import span


def leaky():
    s = observability.span("fixture.leak", cat="fixture")
    s.__enter__()
    return s


def leaky_bare_import():
    return span("fixture.leak2")


def clean():
    with observability.span("fixture.clean", cat="fixture"):
        pass
    with span("fixture.clean2") as s:
        return s.trace_id
