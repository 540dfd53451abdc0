"""R13 fixture: config-knob and chaos-point drift (runtime half)."""
from ray_tpu_torch import chaos
from ray_tpu_torch._private.config import _config

_config.define("fixture_live_knob", int, 1, "read below: not dead")
_config.define("fixture_dead_knob", int, 2, "never read anywhere")


def read_knobs():
    a = _config.get("fixture_live_knob")
    b = _config.get("fixture_missing_knob")
    return a + b


def fault_paths():
    chaos.inject("fixture.point.tested")
    chaos.inject("fixture.point.untested")
