"""Serializability inspection.

Parity with ``python/ray/util/check_serialize.py``
(``inspect_serializability``): attempt cloudpickle, and on failure walk
closures/attributes to pinpoint the unserializable leaves instead of
surfacing one opaque error.
"""

from __future__ import annotations

import inspect
from typing import Any, Set, Tuple

import cloudpickle


class FailureTuple:
    """One unserializable object found during inspection."""

    def __init__(self, obj: Any, name: str, parent: str):
        self.obj = obj
        self.name = name
        self.parent = parent

    def __repr__(self):
        return f"FailureTuple(obj={self.obj!r}, name={self.name}, " \
               f"parent={self.parent})"


def _serializable(obj: Any) -> bool:
    try:
        cloudpickle.dumps(obj)
        return True
    except Exception:  # raylint: allow(swallow) the whole point is try-pickle
        return False


def inspect_serializability(obj: Any, name: str = "object", depth: int = 3
                            ) -> Tuple[bool, Set[FailureTuple]]:
    """-> (is_serializable, failures). Failures name the deepest
    unserializable members found within ``depth`` levels."""
    failures: Set[FailureTuple] = set()
    _inspect(obj, name, "root", depth, failures)
    return (not failures, failures)


def _inspect(obj: Any, name: str, parent: str, depth: int,
             failures: Set[FailureTuple]) -> bool:
    if _serializable(obj):
        return True
    if depth <= 0:
        failures.add(FailureTuple(obj, name, parent))
        return False
    found_deeper = False
    # Closures of functions.
    if inspect.isfunction(obj) and obj.__closure__:
        for var, cell in zip(obj.__code__.co_freevars, obj.__closure__):
            try:
                contents = cell.cell_contents
            except ValueError:
                continue
            if not _serializable(contents):
                found_deeper = True
                _inspect(contents, var, name, depth - 1, failures)
    # Instance attributes.
    attrs = getattr(obj, "__dict__", None)
    if isinstance(attrs, dict):
        for k, v in attrs.items():
            if not _serializable(v):
                found_deeper = True
                _inspect(v, k, name, depth - 1, failures)
    # Container elements.
    if isinstance(obj, (list, tuple, set)):
        for i, v in enumerate(obj):
            if not _serializable(v):
                found_deeper = True
                _inspect(v, f"{name}[{i}]", name, depth - 1, failures)
    if isinstance(obj, dict):
        for k, v in obj.items():
            if not _serializable(v):
                found_deeper = True
                _inspect(v, f"{name}[{k!r}]", name, depth - 1, failures)
    if not found_deeper:
        failures.add(FailureTuple(obj, name, parent))
    return False
