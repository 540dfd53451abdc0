"""Lazy task/actor DAGs.

Parity with ``python/ray/dag/`` (``dag_node.py``, ``function_node.py``,
``class_node.py``): ``.bind()`` builds a graph, ``.execute()`` materializes it
by submitting the underlying tasks/actors. Used by Serve graphs and Workflows.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple


class DAGNode:
    def __init__(self, args: Tuple[Any, ...], kwargs: Dict[str, Any]):
        self._bound_args = args
        self._bound_kwargs = kwargs

    def _resolve_deps(self, executed: Dict[int, Any]):
        def resolve(v):
            if isinstance(v, DAGNode):
                key = id(v)
                if key not in executed:
                    executed[key] = v._execute_impl(executed)
                return executed[key]
            return v
        args = tuple(resolve(a) for a in self._bound_args)
        kwargs = {k: resolve(v) for k, v in self._bound_kwargs.items()}
        return args, kwargs

    def execute(self, *exec_args):
        executed: Dict[Any, Any] = {}
        if exec_args:
            executed["__input__"] = exec_args[0] if len(exec_args) == 1 else exec_args
        return self._execute_impl(executed, exec_args)

    def _execute_impl(self, executed, exec_args=()):
        raise NotImplementedError

    def get_other_args_to_resolve(self):
        return {}


class FunctionNode(DAGNode):
    def __init__(self, remote_fn, args, kwargs):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn

    def _execute_impl(self, executed, exec_args=()):
        args, kwargs = self._resolve_deps(executed)
        return self._remote_fn.remote(*args, **kwargs)


class InputNode(DAGNode):
    """Placeholder for the DAG's runtime input (reference: dag/input_node.py)."""

    _current: List["InputNode"] = []

    def __init__(self):
        super().__init__((), {})

    def __enter__(self):
        InputNode._current.append(self)
        return self

    def __exit__(self, *a):
        InputNode._current.pop()

    def _execute_impl(self, executed, exec_args=()):
        return executed.get("__input__")


class ClassNode(DAGNode):
    def __init__(self, actor_cls, args, kwargs):
        super().__init__(args, kwargs)
        self._actor_cls = actor_cls

    def _execute_impl(self, executed, exec_args=()):
        args, kwargs = self._resolve_deps(executed)
        return self._actor_cls.remote(*args, **kwargs)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _ClassMethodBinder(self, name)


class _ClassMethodBinder:
    def __init__(self, class_node: ClassNode, method_name: str):
        self._class_node = class_node
        self._method_name = method_name

    def bind(self, *args, **kwargs):
        return ClassMethodNode(self._class_node, self._method_name, args, kwargs)


class ClassMethodNode(DAGNode):
    def __init__(self, class_node, method_name, args, kwargs):
        super().__init__(args, kwargs)
        self._class_node = class_node
        self._method_name = method_name

    def _execute_impl(self, executed, exec_args=()):
        key = id(self._class_node)
        if key not in executed:
            executed[key] = self._class_node._execute_impl(executed)
        handle = executed[key]
        args, kwargs = self._resolve_deps(executed)
        return getattr(handle, self._method_name).remote(*args, **kwargs)
