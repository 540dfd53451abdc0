"""In-trial session API: ``tune.report`` / ``tune.get_checkpoint``.

Parity with the reference's ``ray.tune.report`` routed through
``air/session.py`` into the function trainable's reporter queue.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

_local = threading.local()


def _init_session(trainable):
    _local.trainable = trainable


def _shutdown_session():
    _local.trainable = None


def _get() -> Optional[Any]:
    return getattr(_local, "trainable", None)


def report(metrics: Optional[Dict[str, Any]] = None,
           checkpoint: Optional[Dict[str, Any]] = None, **kwargs):
    """Report metrics (and optionally a checkpoint dict) from inside a
    function trainable. Accepts both ``report({...})`` and
    ``report(loss=..)`` forms like the reference."""
    t = _get()
    m = dict(metrics or {})
    m.update(kwargs)
    if t is None:
        # Running outside tune (e.g. the bare function called directly):
        # no-op, matching reference behavior of session-less report.
        return
    t._report(m, checkpoint)


def get_checkpoint() -> Optional[Dict[str, Any]]:
    t = _get()
    if t is None:
        return None
    return t._get_checkpoint()


def get_trial_id() -> Optional[str]:
    t = _get()
    return getattr(t, "_trial_id", None) if t is not None else None
