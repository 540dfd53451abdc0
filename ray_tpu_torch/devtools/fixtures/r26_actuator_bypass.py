"""R26 fixture: direct ``_config.set`` writes to autopilot-owned knobs.

Positives: a literal write to a knob listed in
``ray_tpu_torch/autopilot/knobs.py`` through the bare ``_config`` receiver and
through a module-alias receiver.  Negatives: a write to a knob the
autopilot does not own, a dynamic knob name, a *read* of an owned knob,
and a ``.set`` on an unrelated object.
"""
from ray_tpu_torch._private.config import _config
from ray_tpu_torch._private import config as cfgmod


def bad_direct_set():
    # raylint: allow(config-drift) owned knob lives in the runtime config
    _config.set("data_streams_per_peer", 8)


def bad_alias_set():
    cfgmod._config.set("collective_compression", "q8")


def good_unowned_set():
    _config.set("fixture_live_knob", 3)


def good_dynamic_name(knob):
    cfgmod._config.set(knob, 8)


def good_owned_read():
    # raylint: allow(config-drift) owned knob lives in the runtime config
    return _config.get("data_prefetch_batches")


class _Store(dict):
    def set(self, key, value):
        self[key] = value


def good_unrelated_receiver():
    store = _Store()
    store.set("data_streams_per_peer", 8)
    return store
