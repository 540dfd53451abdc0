"""Workflow executor: durable DAG evaluation.

Parity with ``python/ray/workflow/workflow_executor.py:32`` +
``workflow_state_from_dag.py``: the DAG is flattened into tasks with
deterministic IDs (structural position + function name), each task runs as
a cluster task, its result is persisted before dependents are scheduled,
and resume replays persisted results instead of recomputing
(``workflow_state_from_storage.py`` semantics).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

from ray_tpu_torch import dag as dag_mod
from ray_tpu_torch.workflow.storage import WorkflowStorage

logger = logging.getLogger("ray_tpu.workflow")


class WorkflowExecutionError(Exception):
    def __init__(self, workflow_id: str, cause: BaseException):
        super().__init__(f"Workflow {workflow_id!r} failed: {cause!r}")
        self.cause = cause


def _node_children(node: dag_mod.DAGNode):
    for a in list(node._bound_args) + list(node._bound_kwargs.values()):
        if isinstance(a, dag_mod.DAGNode):
            yield a


def topo_order(root: dag_mod.DAGNode) -> list:
    """Dependencies-before-dependents node list, iteratively (deep chains
    must not hit the recursion limit). The single source of truth for DAG
    traversal order — task-id assignment and execution both use it, so
    resume matching can never desynchronize from run order."""
    order = []
    stack = [(root, False)]
    seen = set()
    while stack:
        node, processed = stack.pop()
        if processed:
            order.append(node)
            continue
        if id(node) in seen:
            continue
        seen.add(id(node))
        stack.append((node, True))
        # Reversed so the first child is visited (and ordered) first,
        # matching depth-first order.
        for child in reversed(list(_node_children(node))):
            stack.append((child, False))
    return order


def assign_task_ids(root: dag_mod.DAGNode) -> Dict[int, str]:
    """Deterministic structural task IDs: depth-first position + name.

    The same DAG built twice gets the same IDs, which is what makes
    resume able to match persisted results to nodes.
    """
    def name_of(node) -> str:
        if isinstance(node, dag_mod.FunctionNode):
            fn = getattr(node._remote_fn, "_function", None)
            return getattr(fn, "__name__", "task")
        return type(node).__name__.lower()

    return {id(node): f"{i:04d}_{name_of(node)}"
            for i, node in enumerate(topo_order(root))}


class WorkflowExecutor:
    def __init__(self, workflow_id: str, storage: WorkflowStorage):
        self.workflow_id = workflow_id
        self.storage = storage

    def execute(self, root: dag_mod.DAGNode) -> Any:
        """Run the DAG to completion, persisting each task result.

        Iterative (deep chains must not hit the recursion limit) and
        submission-eager: every task whose dependencies are submitted is
        itself submitted with the upstream ``ObjectRef``s as arguments, so
        independent branches run concurrently on the cluster; results are
        then gathered and persisted in topological order. Crash-safety is
        unchanged — an unpersisted task is simply re-run on resume.

        The workflow's ROOT step may return ``workflow.continuation(dag)``:
        the sub-DAG runs in its place (the reference's dynamic-workflow
        core, supporting recursive tail chains of unbounded length). The
        chain is driven by a LOOP — one stack frame and one id segment
        total, regardless of length — and every link's result (including
        the continuation markers themselves) is persisted, so a resume
        replays completed links and re-runs only the unfinished tail.
        Non-root steps may not return continuations in this engine: their
        dependents are submitted eagerly and would consume the marker.
        """
        from ray_tpu_torch.workflow.api import Continuation
        self.storage.save_status("RUNNING")
        try:
            result, top_id = self._run_level(root, prefix="")
            depth = 0
            while isinstance(result, Continuation):
                result, _ = self._run_level(result.dag,
                                            prefix=f"{top_id}/c{depth}/")
                depth += 1
            if depth:
                # expose the chain's FINAL value under the root id so
                # get_output/resume read a value, not a marker
                self.storage.save_task_result(top_id, result)
        except Exception as e:
            self.storage.save_status("FAILED", error=repr(e))
            raise WorkflowExecutionError(self.workflow_id, e) from e
        except BaseException as e:
            # KeyboardInterrupt/SystemExit: persist FAILED (resumable) but
            # let the interrupt propagate unwrapped.
            self.storage.save_status("FAILED", error=repr(e))
            raise
        self.storage.save_status("SUCCESS", root_task_id=top_id)
        return result

    def _run_level(self, root: dag_mod.DAGNode, prefix: str):
        """One DAG level; returns (value, root_task_id). The root's value
        may be a ``Continuation`` marker (persisted as such — a replayed
        marker resumes the chain exactly where it left off); the caller's
        loop drives the chain."""
        import ray_tpu_torch as ray_tpu
        from ray_tpu_torch.workflow.api import Continuation
        order = topo_order(root)
        ids = {k: prefix + t for k, t in assign_task_ids(root).items()}

        refs: Dict[int, Any] = {}      # submitted this run
        memo: Dict[int, Any] = {}      # replayed from storage

        def resolve(v):
            if isinstance(v, dag_mod.DAGNode):
                k = id(v)
                return memo[k] if k in memo else refs[k]
            return v

        for node in order:
            key = id(node)
            task_id = ids[key]
            if self.storage.has_task_result(task_id):
                logger.info("workflow %s: task %s replayed from storage",
                            self.workflow_id, task_id)
                memo[key] = self.storage.load_task_result(task_id)
                continue
            if not isinstance(node, dag_mod.FunctionNode):
                # InputNode included: workflows take no runtime input,
                # so an InputNode in the DAG is a user error.
                raise TypeError(
                    f"Workflows support function nodes, got "
                    f"{type(node)}; wrap stateful steps in tasks")
            args = tuple(resolve(a) for a in node._bound_args)
            kwargs = {k: resolve(v)
                      for k, v in node._bound_kwargs.items()}
            refs[key] = node._remote_fn.remote(*args, **kwargs)
        for node in order:
            key = id(node)
            if key in refs:
                value = ray_tpu.get(refs[key])
                if isinstance(value, Continuation) and node is not root:
                    raise TypeError(
                        f"step {ids[key]} returned a continuation but is "
                        f"not the (sub-)workflow root; this engine "
                        f"supports continuations only as the final step "
                        f"of a DAG (tail recursion)")
                self.storage.save_task_result(ids[key], value)
                memo[key] = value
        return memo[id(root)], ids[id(root)]
