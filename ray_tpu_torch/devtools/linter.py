"""Framework-aware AST lint engine.

The engine walks every ``*.py`` file under the given roots, parses each
once, and runs two kinds of rules over the parse trees:

- **file rules** see one file at a time (R1, R3, R4, R5);
- **project rules** see the whole tree at once and can correlate across
  files (R2 lock-order consistency, R6 proto/pb2 drift).

Suppression has two layers, mirroring the sanitizer stance of the native
side (``run_sanitizers.sh``):

- an inline justification comment on the finding line or the line above::

      except Exception:  # raylint: allow(swallow) best-effort close
          pass

  The tag in ``allow(...)`` is the rule's short tag (``swallow``,
  ``lock-order``, ...) or its id (``R4``); ``allow(all)`` suppresses every
  rule on that line.  The justification text after the tag is *required
  culture*, not enforced syntax.
- a per-file allowlist baseline (``--baseline FILE``): lines of
  ``RULE<whitespace>path`` that tolerate pre-existing findings while a
  cleanup is in flight.  The shipped baseline is empty — the tree lints
  clean — and CI fails on any finding not covered by one of the two.

Rules (see ARCHITECTURE.md "Static analysis & concurrency invariants"):

==== ============== ====================================================
id   tag            what it catches
==== ============== ====================================================
R1   async-blocking blocking call (``time.sleep``, ``.result()``,
                    lock ``.acquire()`` without timeout, ``ray_tpu_torch.get``)
                    inside an ``async def`` body
R2   lock-order     two locks statically acquired in both A→B and B→A
                    nesting orders anywhere in the tree
R3   unguarded-state self-attribute written both from a thread-entry
                    method and from on-thread code with no lock held
R4   swallow        ``except Exception:`` that neither re-raises, logs,
                    nor uses the caught exception
R5   host-sync      host-device sync (``.item()``, ``float()``,
                    ``np.asarray``, ``jax.device_get``) reachable from a
                    jitted step function
R6   proto-drift    field/enum-number drift between ``raytpu.proto`` and
                    the committed ``raytpu_pb2.py``
R7   bare-retry     hand-rolled retry loop: constant ``time.sleep`` inside
                    a loop that also catches exceptions (use
                    ``ray_tpu_torch._private.backoff.BackoffPolicy``)
R8   hidden-copy    ``bytes(<memoryview/bytearray/slice>)`` casts and
                    ``b"".join`` chunk reassembly inside modules marked
                    ``# raylint: hot-path`` (payload-plane copies the
                    zero-copy data plane exists to eliminate)
R9   direct-checkpoint-io
                    ``.to_directory()`` / ``.from_directory()`` calls in
                    the ``train/``, ``tune/`` or ``serve/`` subtrees —
                    directory blobs bypass the checkpoint engine's
                    crash-atomic manifest commit; go through
                    ``ray_tpu_torch.checkpoint`` (the engine itself and
                    ``air/`` are out of scope)
R10  async-transitive
                    a blocking primitive (R1's set) reachable from an
                    ``async def`` through the whole-program call graph —
                    the interprocedural closure of R1
R11  lock-order-graph
                    lock acquisitions collected across function
                    boundaries into one global order graph; cycles are
                    reported with the full call path and in lockwatch's
                    runtime cycle format
R12  collective-divergence
                    a collective/barrier/checkpoint-commit call (direct
                    or transitive) dominated by a branch on rank-,
                    world-size-, or local-exception-dependent state —
                    the classic SPMD deadlock
R13  config-drift   every config knob must be read somewhere and every
                    ``_config.<name>`` read must be defined; same
                    closure for chaos points declared in the runtime
                    vs. exercised by ``tests/``
R14  span-leak      ``observability.span(...)`` used outside a ``with``
                    statement (outside the observability package): a
                    span not closed on every exit path leaks its
                    context var and never records
R15  metrics-cardinality
                    a metric tag value derived from unbounded runtime
                    data (object/task/trace ids, raw peer addresses):
                    every entity mints a new time series, growing the
                    registry and every scrape without bound
R16  resource-leak  an OS-backed resource (socket, file, mmap,
                    non-daemon thread, executor) acquired on some path
                    but neither released nor ownership-transferred
                    before the function exits on that path (incl.
                    ``__init__`` aborts); dynamic handoffs are asserted
                    with ``# raylint: transfer(<kind>) <why>``
R17  deadline-drop  a blocking primitive with no bound (bare
                    ``.wait()``/``.join()``/``.acquire()``/``.get()``,
                    ``.result()`` without timeout) reachable over call
                    edges from a deadline-scoped entry point — the
                    budget the caller was promised is silently dropped
R18  protocol       RPC vocabulary + lifecycle conformance: every sent
                    ``pb.<METHOD>`` has a dispatch arm and vice versa,
                    handlers reply exactly once per completed path, and
                    every static ``.state = "<STATE>"`` write is a
                    transition ``dataflow.NODE_LIFECYCLE`` declares
==== ============== ====================================================

R10-R12 run on the whole-program call graph built by
:mod:`ray_tpu_torch.devtools.callgraph`; unresolvable dynamic calls degrade to
"unknown" (no edges), so the interprocedural rules can under-report but
never invent a path.  R16-R18 add the path-sensitive layer in
:mod:`ray_tpu_torch.devtools.dataflow` on top of that graph — same
under-approximation stance, with witness paths kept for messages.
"""

from __future__ import annotations

import ast
import hashlib
import io
import json
import os
import re
import sys
import tempfile
import time
import tokenize
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Set, Tuple

from ray_tpu_torch.devtools import callgraph as _cg
from ray_tpu_torch.devtools import dataflow as _df
from ray_tpu_torch.devtools import shardprop as _sp

# The package whose runtime the rules know (config registry, chaos,
# observability, checkpoint, autopilot): this analyzer's own package.
_PKG = _cg.PKG

__all__ = ["Finding", "LintEngine", "rule", "project_rule", "RULES",
           "PROJECT_RULES", "rule_listing"]

_ALLOW_RE = re.compile(r"#\s*raylint:\s*allow\(([A-Za-z0-9_,\- ]+)\)")


@dataclass(frozen=True)
class Finding:
    rule: str          # "R4"
    tag: str           # "swallow"
    path: str          # path relative to the lint root
    line: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}({self.tag}): {self.message}"

    def to_json(self) -> dict:
        return {"rule": self.rule, "tag": self.tag, "path": self.path,
                "line": self.line, "message": self.message}


class FileContext:
    """One parsed source file plus the lookups rules keep re-needing."""

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.allow = self._collect_allows(source)
        # name -> module it was imported from ("from ray_tpu_torch import get")
        self.from_imports: Dict[str, str] = {}
        # name -> fully-qualified origin ("from ray_tpu_torch import chaos as ch"
        # binds ch -> "ray_tpu_torch.chaos"; "import ray_tpu_torch.chaos as ch" likewise)
        self.import_origin: Dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    bound = alias.asname or alias.name
                    self.from_imports[bound] = node.module
                    self.import_origin[bound] = \
                        node.module + "." + alias.name
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.asname:
                        self.import_origin[alias.asname] = alias.name
                    else:
                        top = alias.name.split(".")[0]
                        self.import_origin[top] = top

    @staticmethod
    def _collect_allows(source: str) -> Dict[int, Set[str]]:
        """line -> set of allowed tags, from ``# raylint: allow(tag)``."""
        allows: Dict[int, Set[str]] = {}
        try:
            tokens = tokenize.generate_tokens(io.StringIO(source).readline)
            for tok in tokens:
                if tok.type == tokenize.COMMENT:
                    m = _ALLOW_RE.search(tok.string)
                    if m:
                        tags = {t.strip() for t in m.group(1).split(",")}
                        allows.setdefault(tok.start[0], set()).update(tags)
        except tokenize.TokenError:
            pass
        return allows

    def allowed(self, line: int, rule_id: str, tag: str) -> bool:
        """A finding is suppressed by an allow comment on its own line, the
        line above, or the enclosing statement's first line (for multi-line
        statements the AST anchors mid-construct)."""
        for cand in (line, line - 1):
            tags = self.allow.get(cand)
            if tags and ({rule_id, tag, "all"} & tags):
                return True
        return False


# --------------------------------------------------------------------------
# rule registry

RULES: List[Tuple[str, str, Callable]] = []           # (id, tag, fn(ctx))
PROJECT_RULES: List[Tuple[str, str, Callable]] = []   # (id, tag, fn(ctxs, engine))


def rule(rule_id: str, tag: str):
    def deco(fn):
        RULES.append((rule_id, tag, fn))
        return fn
    return deco


def project_rule(rule_id: str, tag: str):
    def deco(fn):
        PROJECT_RULES.append((rule_id, tag, fn))
        return fn
    return deco


# --------------------------------------------------------------------------
# shared AST helpers

def _dotted(node: ast.AST) -> Optional[str]:
    """Best-effort dotted name for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


_LOCKISH = re.compile(r"(^|[._])(lock|mutex|cv|cond|sem)", re.IGNORECASE)


def _is_lockish(expr_text: Optional[str]) -> bool:
    return bool(expr_text and _LOCKISH.search(expr_text))


def _has_kwarg(call: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in call.keywords)


def _walk_pruned(root: ast.AST) -> Iterator[ast.AST]:
    """``ast.walk`` that does not descend into nested def/lambda bodies
    (those run in another context — executors, callbacks, later)."""
    stack: List[ast.AST] = [root]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            stack.append(child)


def _funcs_with_class(tree: ast.Module):
    """Yield (class_name_or_None, FunctionDef/AsyncFunctionDef)."""
    def walk(node, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from walk(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield cls, child
                yield from walk(child, cls)
            else:
                yield from walk(child, cls)
    yield from walk(tree, None)


# --------------------------------------------------------------------------
# R1: blocking calls inside async def bodies

_BLOCKING_SLEEP = {"time.sleep", "sleep"}


@rule("R1", "async-blocking")
def check_async_blocking(ctx: FileContext) -> Iterator[Finding]:
    """An ``async def`` body must not make blocking calls: they stall the
    event loop the serve/router/long-poll layer multiplexes on.  Flags
    ``time.sleep``, ``Future.result()``, lock ``.acquire()`` with no
    timeout/non-blocking arg, and ``ray_tpu_torch.get(...)``."""

    def scan(body_node, fname):
        for node in _walk_pruned(body_node):
            if not isinstance(node, ast.Call):
                continue
            dn = _dotted(node.func)
            if dn in _BLOCKING_SLEEP and (
                    dn != "sleep" or
                    ctx.from_imports.get("sleep") == "time"):
                yield node, f"blocking time.sleep() inside 'async def {fname}'"
            elif isinstance(node.func, ast.Attribute):
                attr = node.func.attr
                if attr == "result" and not node.args and \
                        not _has_kwarg(node, "timeout"):
                    yield node, (f"blocking Future.result() inside "
                                 f"'async def {fname}' — await it instead")
                elif attr == "acquire" and _is_lockish(_dotted(node.func.value)):
                    if not node.args and not (_has_kwarg(node, "timeout") or
                                              _has_kwarg(node, "blocking")):
                        yield node, (f"lock .acquire() with no timeout inside "
                                     f"'async def {fname}' can deadlock the "
                                     f"event loop")
                elif attr == "get" and _dotted(node.func.value) == _PKG:
                    yield node, (f"blocking {_PKG}.get() inside "
                                 f"'async def {fname}' — resolve off-loop")
            elif isinstance(node.func, ast.Name) and node.func.id == "get" and \
                    ctx.from_imports.get("get", "").startswith(_PKG):
                yield node, (f"blocking {_PKG}.get() inside "
                             f"'async def {fname}' — resolve off-loop")

    for _cls, fn in _funcs_with_class(ctx.tree):
        if not isinstance(fn, ast.AsyncFunctionDef):
            continue
        for node, msg in scan(fn, fn.name):
            if not ctx.allowed(node.lineno, "R1", "async-blocking"):
                yield Finding("R1", "async-blocking", ctx.relpath,
                              node.lineno, msg)


# --------------------------------------------------------------------------
# R2: statically inconsistent lock order (project rule)

def _lock_identity(expr: ast.AST, cls: Optional[str]) -> Optional[str]:
    text = _dotted(expr)
    if not _is_lockish(text):
        return None
    if text.startswith("self."):
        return f"{cls or '?'}.{text[5:]}"
    return text


def _iter_with_pairs(ctx: FileContext):
    """Yield (outer_id, inner_id, lineno) for every nested lock ``with``."""
    for cls, fn in _funcs_with_class(ctx.tree):
        stack: List[str] = []

        def visit(node):
            pushed = 0
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    lid = _lock_identity(item.context_expr, cls)
                    if lid:
                        for outer in stack:
                            if outer != lid:
                                yield (outer, lid, node.lineno)
                        stack.append(lid)
                        pushed += 1
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda)):
                    continue  # nested defs run elsewhere/later
                yield from visit(child)
            for _ in range(pushed):
                stack.pop()

        for item in visit(fn):
            yield item


@project_rule("R2", "lock-order")
def check_lock_order(ctxs: List[FileContext], _engine) -> Iterator[Finding]:
    """If lock A is ever taken while holding B *and* B while holding A,
    two threads interleaving those paths deadlock.  Lock identity is the
    attribute path qualified by class name (``Router._lock``), so the rule
    correlates orderings across files."""
    edges: Dict[Tuple[str, str], List[Tuple[FileContext, int]]] = {}
    for ctx in ctxs:
        for outer, inner, line in _iter_with_pairs(ctx):
            edges.setdefault((outer, inner), []).append((ctx, line))
    seen: Set[Tuple[str, str]] = set()
    for (a, b), sites in sorted(edges.items()):
        if (b, a) in edges and (b, a) not in seen:
            seen.add((a, b))
            other = edges[(b, a)][0]
            for ctx, line in sites:
                if ctx.allowed(line, "R2", "lock-order"):
                    continue
                yield Finding(
                    "R2", "lock-order", ctx.relpath, line,
                    f"lock order {a} -> {b} here conflicts with "
                    f"{b} -> {a} at {other[0].relpath}:{other[1]} "
                    f"(potential deadlock)")


# --------------------------------------------------------------------------
# R3: unguarded cross-thread shared-state mutation

def _self_attr_writes(fn: ast.AST) -> Iterator[Tuple[str, ast.AST]]:
    for node in ast.walk(fn):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Attribute) and \
                    isinstance(t.value, ast.Name) and t.value.id == "self":
                yield t.attr, node


def _guarded_by_lock(fn: ast.AST, write: ast.AST) -> bool:
    """True if *write* sits inside a ``with <lock-ish>:`` in *fn*."""
    class Visitor(ast.NodeVisitor):
        def __init__(self):
            self.depth = 0
            self.guarded = False

        def visit_With(self, node):
            lockish = any(_is_lockish(_dotted(i.context_expr))
                          for i in node.items)
            self.depth += lockish
            self.generic_visit(node)
            self.depth -= lockish

        visit_AsyncWith = visit_With

        def generic_visit(self, node):
            if node is write and self.depth > 0:
                self.guarded = True
            super().generic_visit(node)

    v = Visitor()
    v.visit(fn)
    return v.guarded


@rule("R3", "unguarded-state")
def check_unguarded_state(ctx: FileContext) -> Iterator[Finding]:
    """Inside one class, an attribute REBOUND both by a thread-entry method
    (a ``threading.Thread(target=self.x)`` target, an executor-submitted
    method, or ``run`` of a Thread subclass) and by on-thread code has two
    concurrent writers; every such write must hold a lock.  Single-writer
    attributes (the daemon owns them) are fine — the GIL makes the store
    itself atomic, ordering is what needs the lock."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        methods = {n.name: n for n in node.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        # 1. thread-entry methods
        entries: Set[str] = set()
        base_names = {_dotted(b) for b in node.bases}
        if {"threading.Thread", "Thread"} & base_names and "run" in methods:
            entries.add("run")
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            dn = _dotted(sub.func)
            cand = None
            if dn in ("threading.Thread", "Thread"):
                for kw in sub.keywords:
                    if kw.arg == "target":
                        cand = kw.value
            elif isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr in ("submit", "call_soon_threadsafe"):
                cand = sub.args[0] if sub.args else None
            if isinstance(cand, ast.Attribute) and \
                    isinstance(cand.value, ast.Name) and \
                    cand.value.id == "self" and cand.attr in methods:
                entries.add(cand.attr)
        if not entries:
            continue
        # 2. close entries over same-class self.method() calls
        reach = set(entries)
        frontier = list(entries)
        while frontier:
            m = frontier.pop()
            for sub in ast.walk(methods[m]):
                if isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Attribute) and \
                        isinstance(sub.func.value, ast.Name) and \
                        sub.func.value.id == "self" and \
                        sub.func.attr in methods and \
                        sub.func.attr not in reach:
                    reach.add(sub.func.attr)
                    frontier.append(sub.func.attr)
        # 3. writers per attribute, split by side of the thread boundary
        writes: Dict[str, List[Tuple[str, ast.AST]]] = {}
        for mname, fn in methods.items():
            if mname == "__init__":
                continue
            for attr, wnode in _self_attr_writes(fn):
                writes.setdefault(attr, []).append((mname, wnode))
        for attr, sites in sorted(writes.items()):
            owners = {m for m, _ in sites}
            off = owners & reach
            on = owners - reach
            if not off or not on:
                continue  # single side owns it
            for mname, wnode in sites:
                if _guarded_by_lock(methods[mname], wnode):
                    continue
                if ctx.allowed(wnode.lineno, "R3", "unguarded-state"):
                    continue
                side = "thread-entry" if mname in reach else "on-thread"
                yield Finding(
                    "R3", "unguarded-state", ctx.relpath, wnode.lineno,
                    f"self.{attr} written from {side} method "
                    f"'{mname}' without a lock, but also written from "
                    f"{'on-thread' if side == 'thread-entry' else 'thread-entry'}"
                    f" methods {sorted(on if side == 'thread-entry' else off)}"
                    f" of class {node.name}")


# --------------------------------------------------------------------------
# R4: silent exception swallows

_LOG_ATTRS = {"debug", "info", "warning", "warn", "error", "exception",
              "critical", "log", "record", "print_exc", "print_exception"}


def _handler_is_silent(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return False
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in _LOG_ATTRS:
                return False
            if isinstance(fn, ast.Name) and fn.id in ("print", "warn"):
                return False
        if handler.name and isinstance(node, ast.Name) and \
                node.id == handler.name and isinstance(node.ctx, ast.Load):
            return False  # the exception object is used, not dropped
    return True


def _broad_catch(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True
    types = handler.type.elts if isinstance(handler.type, ast.Tuple) \
        else [handler.type]
    for t in types:
        if _dotted(t) in ("Exception", "BaseException"):
            return True
    return False


@rule("R4", "swallow")
def check_swallow(ctx: FileContext) -> Iterator[Finding]:
    """A broad ``except`` that neither re-raises, logs, nor *uses* the
    caught exception hides faults — exactly the ones chaos tests try to
    surface in daemon threads and RPC/scheduler/object-store paths.  Either
    handle it visibly or justify with ``# raylint: allow(swallow) <why>``."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if not _broad_catch(node) or not _handler_is_silent(node):
            continue
        if ctx.allowed(node.lineno, "R4", "swallow"):
            continue
        yield Finding(
            "R4", "swallow", ctx.relpath, node.lineno,
            "broad except swallows the exception silently: re-raise, log "
            "with context, or justify with '# raylint: allow(swallow) <why>'")


# --------------------------------------------------------------------------
# R5: host-device sync reachable from compiled / captured step functions
#
# The PyTorch form of the rule.  A device-to-host read inside code that
# ``torch.compile`` traces breaks the graph there (TorchDynamo falls back to
# eager around it, and with ``fullgraph=True`` the trace fails); inside
# ``torch.jit.script``/``trace`` it freezes a traced constant; inside a
# CUDA-graph capture (``with torch.cuda.graph(g):`` or
# ``torch.cuda.make_graphed_callables``) it raises, because a capture may
# not synchronize.  Outside those the same read costs one host sync per
# step.  Names resolve through the file's imports, so ``from torch import
# compile`` and ``import torch._dynamo`` spellings resolve too.

_SYNC_CALLS = {"numpy.asarray", "numpy.array", "torch.cuda.synchronize"}
_SYNC_ATTRS = {"item": ".item() forces a device->host sync",
               "cpu": ".cpu() copies device data to host",
               "tolist": ".tolist() copies device data to host",
               "numpy": ".numpy() copies device data to host"}
_COMPILE_NAMES = {"torch.compile", "torch.jit.script", "torch.jit.trace",
                  "torch.cuda.make_graphed_callables"}
_TRACED_HOFS = {"torch.func." + n for n in (
    "grad", "grad_and_value", "vmap", "jacrev", "jacfwd", "hessian",
    "vjp", "jvp", "linearize", "functionalize")} | {"torch.vmap"}
_GRAPH_CAPTURE = "torch.cuda.graph"


def _resolved_name(node: ast.AST, ctx: FileContext) -> Optional[str]:
    """Fully-qualified dotted name of *node* (a Name/Attribute chain),
    its head resolved through the file's imports (``np`` -> ``numpy``,
    ``from torch import func`` -> ``torch.func``)."""
    full = _dotted(node)
    if not full:
        return None
    head, _, rest = full.partition(".")
    origin = ctx.import_origin.get(head)
    if origin:
        return origin + ("." + rest if rest else "")
    return full


def _compile_decorated(fn: ast.AST, ctx: FileContext) -> bool:
    for dec in getattr(fn, "decorator_list", []):
        target = dec.func if isinstance(dec, ast.Call) else dec
        dn = _resolved_name(target, ctx)
        if dn in _COMPILE_NAMES:
            return True
        if dn == "functools.partial" and isinstance(dec, ast.Call) and \
                dec.args and _resolved_name(dec.args[0], ctx) in \
                _COMPILE_NAMES:
            return True
    return False


def _sync_message(node: ast.Call, ctx: FileContext) -> Optional[str]:
    if isinstance(node.func, ast.Attribute) and \
            node.func.attr in _SYNC_ATTRS and not node.args and \
            not node.keywords:
        return _SYNC_ATTRS[node.func.attr]
    dn = _resolved_name(node.func, ctx)
    if dn in _SYNC_CALLS:
        return (f"{_dotted(node.func)}() "
                + ("blocks the host on the device"
                   if dn == "torch.cuda.synchronize"
                   else "copies device data to host"))
    if isinstance(node.func, ast.Name) and \
            node.func.id in ("float", "int", "bool") and node.args and \
            not isinstance(node.args[0], ast.Constant):
        return (f"{node.func.id}() of a tensor forces a device->host "
                f"sync")
    return None


@rule("R5", "host-sync")
def check_host_sync(ctx: FileContext) -> Iterator[Finding]:
    """``.item()`` / ``.cpu()`` / ``.tolist()`` / ``.numpy()`` /
    ``float``/``int``/``bool`` of a tensor / ``np.asarray`` /
    ``torch.cuda.synchronize()`` inside a function reachable from a
    compiled or captured step either breaks the trace (a graph break
    under ``torch.compile``, a capture error under CUDA graphs) or
    silently forces a device->host sync per step.  Roots are functions
    decorated by, or passed to, ``torch.compile``, ``torch.jit.script``/
    ``trace`` or ``torch.cuda.make_graphed_callables``, functions handed
    to a ``torch.func`` transform, and the body of ``with
    torch.cuda.graph(...)``; reachability is the module-local call
    graph."""
    module_fns: Dict[str, ast.AST] = {}
    for _cls, fn in _funcs_with_class(ctx.tree):
        module_fns.setdefault(fn.name, fn)

    roots: Set[str] = set()
    for name, fn in module_fns.items():
        if _compile_decorated(fn, ctx):
            roots.add(name)
    captures: List[Tuple[str, List[ast.stmt]]] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call) and \
                        _resolved_name(expr.func, ctx) == _GRAPH_CAPTURE:
                    captures.append((f"<graph capture at line "
                                     f"{node.lineno}>", node.body))
            continue
        if not isinstance(node, ast.Call) or not node.args:
            continue
        dn = _resolved_name(node.func, ctx)
        if dn in _COMPILE_NAMES or dn in _TRACED_HOFS:
            arg = node.args[0]
            cands = arg.elts if isinstance(arg, (ast.Tuple, ast.List)) \
                else [arg]
            for c in cands:
                name = _dotted(c)
                if name in module_fns:
                    roots.add(name)
    if not roots and not captures:
        return

    def callees(stmts: Iterable[ast.AST]) -> Set[str]:
        out: Set[str] = set()
        for stmt in stmts:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Name) and \
                        node.func.id in module_fns:
                    out.add(node.func.id)
        return out

    # module-local call-graph closure (plain Name calls only); a capture
    # body is a root whose callees are reached like a function's
    reach = set(roots)
    for _label, body in captures:
        reach |= callees(body)
    frontier = list(reach)
    while frontier:
        fname = frontier.pop()
        for callee in callees([module_fns[fname]]):
            if callee not in reach:
                reach.add(callee)
                frontier.append(callee)
    labels = sorted(roots & reach) + [label for label, _ in captures]

    bodies: List[Tuple[str, List[ast.AST]]] = [
        (fname, [module_fns[fname]]) for fname in sorted(reach)]
    bodies += [(label, list(body)) for label, body in captures]
    seen: Set[int] = set()
    for where, stmts in bodies:
        for stmt in stmts:
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call) or id(node) in seen:
                    continue
                msg = _sync_message(node, ctx)
                if msg is None or \
                        ctx.allowed(node.lineno, "R5", "host-sync"):
                    continue
                seen.add(id(node))
                yield Finding(
                    "R5", "host-sync", ctx.relpath, node.lineno,
                    f"{msg} inside '{where}', reachable from compiled or "
                    f"captured root(s) {labels}")


# --------------------------------------------------------------------------
# R7: hand-rolled retry loops (constant sleep + except in the same loop)

def _const_sleep_arg(node: ast.Call, ctx: FileContext) -> Optional[ast.AST]:
    """Return the argument node if *node* is a ``time.sleep(...)`` call,
    else None.  Accepts ``sleep`` imported from ``time``."""
    dn = _dotted(node.func)
    if dn == "time.sleep":
        pass
    elif dn == "sleep" and ctx.from_imports.get("sleep") == "time":
        pass
    else:
        return None
    return node.args[0] if node.args else None


@rule("R7", "bare-retry")
def check_bare_retry(ctx: FileContext) -> Iterator[Finding]:
    """A loop that catches exceptions and paces itself with a constant
    ``time.sleep`` is a hand-rolled retry: no jitter (thundering herd on
    recovery), no cap, no deadline budget.  That also covers the
    ``for delay in (0.1, 0.5, 2.0): ... sleep(delay)`` ladder — a
    hard-coded schedule with the same problems.  Use
    ``ray_tpu_torch._private.backoff.BackoffPolicy`` / ``retry_call`` instead,
    or justify with ``# raylint: allow(bare-retry) <why>``."""

    def loop_const_names(loop: ast.AST) -> Set[str]:
        """Names bound by a ``for X in (const, ...)`` header."""
        if not isinstance(loop, ast.For):
            return set()
        it = loop.iter
        if isinstance(it, (ast.Tuple, ast.List)) and it.elts and \
                all(isinstance(e, ast.Constant) and
                    isinstance(e.value, (int, float)) for e in it.elts):
            if isinstance(loop.target, ast.Name):
                return {loop.target.id}
        return set()

    for loop in ast.walk(ctx.tree):
        if not isinstance(loop, (ast.While, ast.For)):
            continue
        body_nodes = [n for stmt in loop.body for n in _walk_pruned(stmt)]
        if not any(isinstance(n, ast.ExceptHandler) for n in body_nodes):
            continue
        const_names = loop_const_names(loop)
        for node in body_nodes:
            if not isinstance(node, ast.Call):
                continue
            arg = _const_sleep_arg(node, ctx)
            if arg is None:
                continue
            constant = (
                isinstance(arg, ast.Constant) and
                isinstance(arg.value, (int, float))) or (
                isinstance(arg, ast.Name) and arg.id in const_names)
            if not constant:
                continue
            if ctx.allowed(node.lineno, "R7", "bare-retry"):
                continue
            yield Finding(
                "R7", "bare-retry", ctx.relpath, node.lineno,
                "constant time.sleep() paces a retry loop (loop also "
                "catches exceptions): no jitter, cap, or deadline — use "
                f"{_PKG}._private.backoff.BackoffPolicy, or justify with "
                "'# raylint: allow(bare-retry) <why>'")


# --------------------------------------------------------------------------
# R8: hidden payload copies in hot-path (bulk-transfer) modules

_HOT_PATH_RE = re.compile(r"#\s*raylint:\s*hot-path")
_BUFFERISH_CALLS = {"memoryview", "bytearray"}


@rule("R8", "hidden-copy")
def check_hidden_copy(ctx: FileContext) -> Iterator[Finding]:
    """Inside a module annotated ``# raylint: hot-path`` (the payload
    plane: rpc / object transfer / store), a ``bytes(...)`` cast of a
    memoryview, bytearray, or slice duplicates payload bytes the zero-copy
    framing exists to avoid — and ``b"".join(chunks)`` is the classic
    reassembly copy (land chunks in a preallocated buffer instead).
    Metadata-sized casts are justified with
    ``# raylint: allow(hidden-copy) <why>``."""
    if not _HOT_PATH_RE.search(ctx.source):
        return
    # File-level approximation of buffer-ish bindings: any name ever
    # assigned from memoryview(...)/bytearray(...) counts everywhere —
    # hot-path modules are exactly where that heuristic is accurate.
    bufferish: Set[str] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and isinstance(node.value.func, ast.Name) \
                and node.value.func.id in _BUFFERISH_CALLS:
            for t in node.targets:
                if isinstance(t, ast.Name):
                    bufferish.add(t.id)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        msg = None
        if isinstance(node.func, ast.Name) and node.func.id == "bytes" \
                and len(node.args) == 1 and not node.keywords:
            arg = node.args[0]
            if isinstance(arg, ast.Subscript):
                msg = ("bytes(<slice>) materializes a payload copy — pass "
                       "the memoryview (or a gather list) through instead")
            elif isinstance(arg, ast.Call) and \
                    isinstance(arg.func, ast.Name) and \
                    arg.func.id in _BUFFERISH_CALLS:
                msg = (f"bytes({arg.func.id}(...)) copies the whole "
                       f"buffer — keep the view")
            elif isinstance(arg, ast.Name) and arg.id in bufferish:
                msg = (f"bytes({arg.id}) copies a buffer-backed value — "
                       f"keep the view or write into the destination")
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr == "join" and \
                isinstance(node.func.value, ast.Constant) and \
                isinstance(node.func.value.value, bytes):
            msg = ("b\"\".join(...) reassembles chunks through an extra "
                   "copy — recv_into a preallocated destination instead")
        if msg and not ctx.allowed(node.lineno, "R8", "hidden-copy"):
            yield Finding("R8", "hidden-copy", ctx.relpath, node.lineno, msg)


# --------------------------------------------------------------------------
# R9: checkpoint directory I/O that bypasses the manifest commit path

_CKPT_IO_SCOPES = {"train", "tune", "serve"}
_CKPT_IO_METHODS = {"to_directory", "from_directory"}


@rule("R9", "direct-checkpoint-io")
def check_direct_checkpoint_io(ctx: FileContext) -> Iterator[Finding]:
    """In the train/tune/serve subtrees, ``Checkpoint.to_directory`` /
    ``from_directory`` write/read whole-value blobs with none of the
    engine's guarantees: no crash-atomic commit, no content dedup, no
    reshard-on-restore. Those layers must move checkpoints as manifest
    refs through ``ray_tpu_torch.checkpoint``. The engine itself and ``air/``
    (the conversion layer) are out of scope; deliberate blob I/O is
    justified with ``# raylint: allow(direct-checkpoint-io) <why>``."""
    segments = set(ctx.relpath.replace("\\", "/").split("/")[:-1])
    if not segments & _CKPT_IO_SCOPES:
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if not (isinstance(node.func, ast.Attribute)
                and node.func.attr in _CKPT_IO_METHODS):
            continue
        if ctx.allowed(node.lineno, "R9", "direct-checkpoint-io"):
            continue
        yield Finding(
            "R9", "direct-checkpoint-io", ctx.relpath, node.lineno,
            f".{node.func.attr}() bypasses the checkpoint engine's "
            "crash-atomic manifest commit — persist/restore through "
            f"{_PKG}.checkpoint (manifest refs) instead")


# --------------------------------------------------------------------------
# R6: proto <-> pb2 wire-schema drift (project rule)

def parse_proto_text(source: str) -> Dict[str, Dict[str, int]]:
    """Parse message fields and enum values out of .proto text.

    Returns ``{"Msg": {"field": number}, "Enum": {"VALUE": number}}`` with
    nested messages flattened as ``Outer.Inner``.
    """
    src = re.sub(r"//[^\n]*", "", source)
    src = re.sub(r"/\*.*?\*/", "", src, flags=re.S)
    field_re = re.compile(
        r"(?:repeated\s+|optional\s+|required\s+)?"
        r"(?:map\s*<[^>]+>|[\w.]+)\s+(\w+)\s*=\s*(\d+)\s*(?:\[[^\]]*\])?\s*;$")
    enum_val_re = re.compile(r"(\w+)\s*=\s*(\d+)\s*;$")
    # one token per block open / close / terminated statement
    token_re = re.compile(
        r"\b(message|enum|oneof)\s+(\w+)\s*\{|(\{)|(\})|([^{};]+;)")
    out: Dict[str, Dict[str, int]] = {}
    stack: List[Tuple[str, str]] = []  # (kind, qualified name)

    for m in token_re.finditer(src):
        if m.group(1):
            kind, name = m.group(1), m.group(2)
            if kind == "oneof":
                # oneof members belong to the enclosing message
                stack.append(("oneof", stack[-1][1] if stack else name))
            else:
                parent = stack[-1][1] + "." if stack and \
                    stack[-1][0] == "message" else ""
                qual = parent + name
                out.setdefault(qual, {})
                stack.append((kind, qual))
        elif m.group(3):
            stack.append(("block", stack[-1][1] if stack else ""))
        elif m.group(4):
            if stack:
                stack.pop()
        elif stack:
            stmt = " ".join(m.group(5).split())
            kind, qual = stack[-1]
            if kind in ("message", "oneof"):
                fm = field_re.match(stmt)
                if fm:
                    out[qual][fm.group(1)] = int(fm.group(2))
            elif kind == "enum":
                em = enum_val_re.match(stmt)
                if em:
                    out[qual][em.group(1)] = int(em.group(2))
    return out


def parse_pb2_descriptor(pb2_source: str) -> Dict[str, Dict[str, int]]:
    """Extract the serialized FileDescriptorProto from generated pb2 source
    and flatten it to the same shape as :func:`parse_proto_text`.

    Works on the source text (no import), so fixture copies never collide
    with the process-wide protobuf descriptor pool.
    """
    tree = ast.parse(pb2_source)
    blob: Optional[bytes] = None
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "AddSerializedFile" and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, bytes):
            blob = node.args[0].value
            break
    if blob is None:
        raise ValueError("no AddSerializedFile(...) blob in pb2 source")
    from google.protobuf import descriptor_pb2
    fdp = descriptor_pb2.FileDescriptorProto()
    fdp.MergeFromString(blob)

    out: Dict[str, Dict[str, int]] = {}

    def walk_msg(msg, prefix):
        qual = prefix + msg.name
        fields = out.setdefault(qual, {})
        for f in msg.field:
            fields[f.name] = f.number
        for nested in msg.nested_type:
            if nested.options.map_entry:
                continue  # synthetic map<>-entry message
            walk_msg(nested, qual + ".")
        for enum in msg.enum_type:
            out[qual + "." + enum.name] = {v.name: v.number
                                           for v in enum.value}

    for msg in fdp.message_type:
        walk_msg(msg, "")
    for enum in fdp.enum_type:
        out[enum.name] = {v.name: v.number for v in enum.value}
    return out


@project_rule("R6", "proto-drift")
def check_proto_drift(ctxs: List[FileContext], engine) -> Iterator[Finding]:
    """The committed ``raytpu_pb2.py`` must agree with ``raytpu.proto`` on
    every field and enum number: daemons deserialize each other's frames by
    number, so silent drift corrupts the wire, not a test."""
    pairs = engine.proto_pairs
    if pairs is None:
        pairs = []
        for ctx in ctxs:
            if os.path.basename(ctx.path) != "raytpu_pb2.py":
                continue
            proto = os.path.join(os.path.dirname(ctx.path), "raytpu.proto")
            if os.path.exists(proto):
                pairs.append((proto, ctx.path, ctx.relpath))
    for proto_path, pb2_path, relpath in pairs:
        with open(proto_path, encoding="utf-8") as f:
            want = parse_proto_text(f.read())
        with open(pb2_path, encoding="utf-8") as f:
            got = parse_pb2_descriptor(f.read())
        for qual, fields in sorted(want.items()):
            if qual not in got:
                yield Finding("R6", "proto-drift", relpath, 1,
                              f"{qual} declared in raytpu.proto but absent "
                              f"from the generated pb2")
                continue
            for name, num in sorted(fields.items()):
                gnum = got[qual].get(name)
                if gnum is None:
                    yield Finding(
                        "R6", "proto-drift", relpath, 1,
                        f"{qual}.{name} (= {num}) missing from pb2 — "
                        f"run {_PKG}.protocol.regenerate()")
                elif gnum != num:
                    yield Finding(
                        "R6", "proto-drift", relpath, 1,
                        f"{qual}.{name}: proto says {num}, pb2 says {gnum} "
                        f"— wire numbers drifted, regenerate")
        for qual, fields in sorted(got.items()):
            for name in sorted(set(fields) - set(want.get(qual, {}))):
                yield Finding(
                    "R6", "proto-drift", relpath, 1,
                    f"{qual}.{name} present in pb2 but not in raytpu.proto")


# --------------------------------------------------------------------------
# R10: blocking primitives reachable from async defs (whole-program)

@project_rule("R10", "async-transitive")
def check_async_transitive(ctxs: List[FileContext],
                           engine) -> Iterator[Finding]:
    """R1 catches ``time.sleep`` written *inside* an ``async def``; this is
    its interprocedural closure: a blocking primitive (R1's set) anywhere
    in the synchronous call graph below an async function still stalls the
    event loop.  Propagation follows ``call`` edges and ``loop`` edges
    (``asyncio.create_task`` coroutines run on the same loop) but never
    ``spawn`` edges (thread targets / executor submissions run off-loop).
    Blocking sites written directly in an ``async def`` body are R1's job
    and are not re-reported here."""
    idx = engine.index(ctxs)
    direct: Dict[str, List[Tuple[int, Tuple[str, int, str]]]] = {}
    for q, fn in idx.functions.items():
        if fn.synthetic:
            continue              # arm statements belong to the dispatcher
        for line, desc in fn.blocking:
            direct.setdefault(q, []).append((line, (q, line, desc)))
    closure = idx.transitive_paths(direct, kinds=("call", "loop"))
    seen: Set[Tuple[str, int]] = set()
    for q in sorted(idx.functions):
        root = idx.functions[q]
        if not root.is_async:
            continue
        for key, path in sorted(closure.get(q, {}).items()):
            site_q, site_line, desc = key
            site_fn = idx.functions[site_q]
            if site_fn.is_async:
                continue  # inline in an async body: R1 reports it
            if (site_q, site_line) in seen:
                continue
            seen.add((site_q, site_line))
            if site_fn.ctx.allowed(site_line, "R10", "async-transitive"):
                continue
            chain = " -> ".join(
                f"{idx.functions[s].cls + '.' if idx.functions[s].cls else ''}"
                f"{idx.functions[s].name}" for s, _ in path)
            yield Finding(
                "R10", "async-transitive", site_fn.ctx.relpath, site_line,
                f"{desc} inside '{site_fn.name}' is reachable from "
                f"'async def {root.name}' ({root.ctx.relpath}) via "
                f"{chain} — it blocks the event loop; resolve off-loop or "
                f"justify with '# raylint: allow(async-transitive) <why>'")


# --------------------------------------------------------------------------
# R11: global static lock-order graph (whole-program closure of R2)

@project_rule("R11", "lock-order-graph")
def check_lock_order_graph(ctxs: List[FileContext],
                           engine) -> Iterator[Finding]:
    """R2 sees lock nestings written in one function; this collects lock
    acquisitions *across* function boundaries into one global order graph:
    holding A while calling ``f()`` orders A before every lock ``f`` may
    acquire transitively.  Cycles are potential deadlocks; each is
    reported once, anchored at an interprocedural edge's call site, with
    the full call path and in lockwatch's runtime cycle format (same
    ``sites`` identity), so a static finding and a lockwatch runtime
    report of the same inversion correlate.  Cycles whose every edge is a
    single-function nesting in ONE file are R2's findings and are not
    re-reported; cross-file direct nestings stay here, because R2's
    syntactic lock identity cannot merge ``LOCK`` with ``othermod.LOCK``."""
    from ray_tpu_torch.devtools import lockwatch
    idx = engine.index(ctxs)
    direct: Dict[str, List[Tuple[int, str]]] = {}
    for q, fn in idx.functions.items():
        if fn.synthetic:
            continue              # arm statements belong to the dispatcher
        for lid, line, _held in fn.acquires:
            direct.setdefault(q, []).append((line, lid))
    closure = idx.transitive_paths(direct, kinds=("call",))
    # edge (a, b): a held while b acquired; witness = (fn, line, path, inter)
    edges: Dict[Tuple[str, str], Tuple[object, int, List[Tuple[str, int]],
                                       bool]] = {}
    for q in sorted(idx.functions):
        fn = idx.functions[q]
        if fn.synthetic:
            continue
        for lid, line, held in fn.acquires:
            for h in held:
                if h != lid:
                    edges.setdefault((h, lid), (fn, line, [(q, line)], False))
        for site in fn.call_sites:
            if site.kind != "call" or not site.locks_held or \
                    site.target not in idx.functions:
                continue
            for lid, path in closure.get(site.target, {}).items():
                for h in site.locks_held:
                    if h != lid:
                        edges.setdefault(
                            (h, lid),
                            (fn, site.line, [(q, site.line)] + path, True))
    succ: Dict[str, List[str]] = {}
    for a, b in edges:
        succ.setdefault(a, []).append(b)
    for comp in lockwatch._sccs(sorted(succ), succ):
        if len(comp) < 2:
            continue
        in_comp = set(comp)
        comp_edges = [(k, v) for k, v in sorted(edges.items())
                      if k[0] in in_comp and k[1] in in_comp]
        inter = [(k, v) for k, v in comp_edges if v[3]]
        files = {v[0].ctx.relpath for _, v in comp_edges}
        if not inter and len(files) < 2:
            continue  # single-file intra-function nesting: R2's domain
        anchor = None
        for key, (fn, line, path, _i) in (inter or comp_edges):
            if not fn.ctx.allowed(line, "R11", "lock-order-graph"):
                anchor = (key, fn, line, path)
                break
        if anchor is None:
            continue  # every interprocedural edge carries a justification
        (a, b), fn, line, path = anchor
        steps = " -> ".join(
            f"{idx.functions[s].name}@{idx.functions[s].ctx.relpath}:{ln}"
            for s, ln in path)
        others = "; ".join(
            f"{x} -> {y} at {v[0].ctx.relpath}:{v[1]}"
            for (x, y), v in comp_edges if (x, y) != (a, b))
        yield Finding(
            "R11", "lock-order-graph", fn.ctx.relpath, line,
            f"static {lockwatch.format_cycle('site-order', sorted(comp))}; "
            f"edge {a} -> {b} via {steps}"
            + (f"; conflicting edges: {others}" if others else "")
            + " (potential deadlock — same cycle identity as a lockwatch "
              "runtime report over these sites)")


# --------------------------------------------------------------------------
# R12: SPMD collective divergence (rank-dependent control flow)

_RANKISH = re.compile(
    r"(^|[._])(rank|world_rank|local_rank|node_rank|global_rank|world_size|"
    r"process_index|process_count|num_hosts|host_id|is_head|is_master|"
    r"is_chief|is_coordinator)($|[._(])", re.IGNORECASE)

_EXIT_CALLS = {"sys.exit", "os._exit", "exit", "quit", "os.abort"}


def _rank_dependent(test: ast.AST) -> Optional[str]:
    """The rank-ish name that makes *test* SPMD-divergent, or None."""
    for node in ast.walk(test):
        dn = _dotted(node) if isinstance(node, (ast.Name, ast.Attribute)) \
            else None
        if dn and _RANKISH.search(dn):
            return dn
        if isinstance(node, ast.Call):
            dn = _dotted(node.func)
            if dn and _RANKISH.search(dn):
                return dn + "()"
    return None


def _arm_exits(stmts: List[ast.stmt]) -> bool:
    """True if the statement list can leave the function (return/raise/
    sys.exit) — execution past the enclosing If then differs by rank."""
    for stmt in stmts:
        for node in _walk_pruned(stmt):
            if isinstance(node, (ast.Return, ast.Raise)):
                return True
            if isinstance(node, ast.Call) and \
                    _dotted(node.func) in _EXIT_CALLS:
                return True
    return False


@project_rule("R12", "collective-divergence")
def check_collective_divergence(ctxs: List[FileContext],
                                engine) -> Iterator[Finding]:
    """Every rank must execute the same collective sequence (podracer /
    pjit-at-scale SPMD contract): a collective, barrier, or
    checkpoint-commit call — direct or through the call graph — that only
    *some* ranks reach deadlocks the others.  Flagged shapes: a collective
    under a branch on rank/world-size state that the other arm does not
    match; a collective after a rank-dependent early exit; a collective
    inside a rank-dependent loop; a collective inside an ``except``
    handler (locally-divergent exception state — one rank's fault must
    not desync the collective schedule); and a ``CollectiveConfig``
    built from rank-dependent state — the (compression scheme, block
    size) pair folds into every rank's rendezvous fingerprint, so a
    per-rank config raises CollectiveDivergenceError at the group's
    first op rather than corrupting a half-quantized reduction.
    Uniform-by-construction shapes are justified with
    ``# raylint: allow(collective-divergence) <why>``."""
    idx = engine.index(ctxs)
    direct: Dict[str, List[Tuple[int, str]]] = {}
    for q, fn in idx.functions.items():
        for line, name in fn.collectives:
            direct.setdefault(q, []).append((line, name))
    closure = idx.transitive_paths(direct, kinds=("call",))

    def site_for(fn, node):
        return fn.site_by_node.get(id(node))

    def collectives_in(fn, stmts) -> Dict[str, Tuple[int, str]]:
        """name -> (line, via) for collectives in *stmts*, direct or
        through resolved calls (one witness each)."""
        out: Dict[str, Tuple[int, str]] = {}
        for stmt in stmts:
            for node in _walk_pruned(stmt):
                if not isinstance(node, ast.Call):
                    continue
                dn = _dotted(node.func) or ""
                last = dn.rsplit(".", 1)[-1]
                site = site_for(fn, node)
                if last in _cg.COLLECTIVE_NAMES or (
                        site and site.target in _cg.BARRIER_QNAMES):
                    out.setdefault(last, (node.lineno, dn))
                elif site and site.target in closure:
                    for name, path in closure[site.target].items():
                        chain = " -> ".join(
                            idx.functions[s].name for s, _ in path)
                        out.setdefault(name,
                                       (node.lineno, f"{dn} -> {chain}"))
        return out

    findings: Dict[Tuple[str, int, str], Finding] = {}

    def flag(fn, line, name, via, why):
        if fn.ctx.allowed(line, "R12", "collective-divergence"):
            return
        key = (fn.ctx.relpath, line, name)
        if key in findings:
            return
        findings[key] = Finding(
            "R12", "collective-divergence", fn.ctx.relpath, line,
            f"collective '{name}'"
            + (f" (via {via})" if via and via != name else "")
            + f" {why} — ranks that skip it deadlock the ones that don't; "
            f"make the schedule rank-uniform or justify with "
            f"'# raylint: allow(collective-divergence) <why>'")

    def walk_stmts(fn, stmts, div: Optional[str]):
        for stmt in stmts:
            if div is not None:
                for name, (line, via) in sorted(
                        collectives_in(fn, [stmt]).items()):
                    flag(fn, line, name, via, div)
            if isinstance(stmt, ast.If):
                dep = _rank_dependent(stmt.test)
                if dep and div is None:
                    body_cols = collectives_in(fn, stmt.body)
                    else_cols = collectives_in(fn, stmt.orelse)
                    for name, (line, via) in sorted(body_cols.items()):
                        if name not in else_cols:
                            flag(fn, line, name, via,
                                 f"is dominated by a branch on '{dep}' "
                                 f"(line {stmt.lineno}) with no matching "
                                 f"call on the other path")
                    for name, (line, via) in sorted(else_cols.items()):
                        if name not in body_cols:
                            flag(fn, line, name, via,
                                 f"is dominated by a branch on '{dep}' "
                                 f"(line {stmt.lineno}) with no matching "
                                 f"call on the other path")
                    # arms still get walked (except handlers, nested
                    # rank branches); duplicate sites dedup by key
                    walk_stmts(fn, stmt.body, div)
                    walk_stmts(fn, stmt.orelse, div)
                    body_exit = _arm_exits(stmt.body)
                    else_exit = _arm_exits(stmt.orelse) if stmt.orelse \
                        else False
                    if body_exit != else_exit:
                        div = (f"follows a rank-dependent early exit "
                               f"(branch on '{dep}' at line {stmt.lineno})")
                else:
                    walk_stmts(fn, stmt.body, div)
                    walk_stmts(fn, stmt.orelse, div)
            elif isinstance(stmt, (ast.While, ast.For)):
                cond = stmt.test if isinstance(stmt, ast.While) else stmt.iter
                dep = _rank_dependent(cond)
                loop_div = div
                if dep and div is None:
                    loop_div = (f"sits in a loop whose trip count depends "
                                f"on '{dep}' (line {stmt.lineno})")
                    for name, (line, via) in sorted(
                            collectives_in(fn, stmt.body).items()):
                        flag(fn, line, name, via, loop_div)
                else:
                    walk_stmts(fn, stmt.body, loop_div)
                walk_stmts(fn, stmt.orelse, div)
            elif isinstance(stmt, ast.Try):
                walk_stmts(fn, stmt.body, div)
                for handler in stmt.handlers:
                    hdiv = div or ("sits in an 'except' handler — entered "
                                   "only on the rank that hit the fault")
                    for name, (line, via) in sorted(
                            collectives_in(fn, handler.body).items()):
                        flag(fn, line, name, via, hdiv)
                walk_stmts(fn, stmt.orelse, div)
                walk_stmts(fn, stmt.finalbody, div)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                walk_stmts(fn, stmt.body, div)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                continue  # separate FunctionInfo / scope
        return

    def flag_config(fn, node, dep):
        if fn.ctx.allowed(node.lineno, "R12", "collective-divergence"):
            return
        key = (fn.ctx.relpath, node.lineno, "CollectiveConfig")
        if key in findings:
            return
        findings[key] = Finding(
            "R12", "collective-divergence", fn.ctx.relpath, node.lineno,
            f"CollectiveConfig built from rank-dependent state ('{dep}') "
            f"— the (compression scheme, block size) pair folds into "
            f"every rank's rendezvous fingerprint, so per-rank configs "
            f"raise CollectiveDivergenceError at the group's first op; "
            f"build ONE config for the whole group or justify with "
            f"'# raylint: allow(collective-divergence) <why>'")

    for q in sorted(idx.functions):
        fn = idx.functions[q]
        if fn.synthetic:
            continue              # arm statements belong to the dispatcher
        walk_stmts(fn, list(fn.node.body), None)
        for node in ast.walk(fn.node):
            if not isinstance(node, ast.Call):
                continue
            dn = _dotted(node.func) or ""
            if dn.rsplit(".", 1)[-1] != "CollectiveConfig":
                continue
            for sub in list(node.args) + [kw.value for kw in node.keywords]:
                dep = _rank_dependent(sub)
                if dep:
                    flag_config(fn, node, dep)
                    break
    for key in sorted(findings):
        yield findings[key]


# --------------------------------------------------------------------------
# R13: config-knob and chaos-point drift (declared vs. used closure)

_CONFIG_METHODS = {"get", "set", "define", "apply_system_config", "to_dict",
                   "keys", "items", "values", "setdefault", "snapshot",
                   "reset"}
_CHAOS_SPEC_RE = re.compile(
    r"^(?:\d+\s*:)?\s*([a-z_][a-z0-9_]*(?:\.[a-z0-9_]+)+)\s*"
    r"(?:\[[^\]]*\])*\s*(?:@[\w%+.]+)?\s*=\s*(?:delay|drop|reset|error|exit)")


def _is_test_path(relpath: str) -> bool:
    """A test file of this package's chaos closure.  ``tests/`` holds the
    suites of two packages side by side; only ``test_<pkg>_*`` files
    there (``tests/test_torch_*.py`` for ``ray_tpu_torch``) exercise this
    package's injection points, so the others are not tests of it."""
    norm = relpath.replace("\\", "/")
    base = os.path.basename(norm)
    if norm.startswith("tests/") or "/tests/" in norm:
        return base.startswith(_TEST_PREFIX)
    return base.startswith("test_")


_TEST_PREFIX = "test_" + _PKG.rsplit("_", 1)[-1] + "_"


def _config_receiver(name: str, ctx: FileContext) -> bool:
    """Is local name *name* bound to the global ``_config`` registry?

    True only when the file imported it from ``ray_tpu_torch._private.config``
    (any alias) or *is* that module — bare ``cfg`` locals elsewhere are
    plain dicts/dataclasses, not the knob registry."""
    origin = ctx.import_origin.get(name, "")
    if origin == _PKG + "._private.config._config" or \
            origin == _PKG + "._private.config":
        return True
    return name == "_config" and \
        ctx.relpath.replace("\\", "/").endswith("_private/config.py")


def _chaos_inject_point(node: ast.Call, ctx: FileContext) -> Optional[str]:
    """Constant point name if *node* is a ``chaos.inject("...")`` call."""
    dn = _dotted(node.func)
    is_inject = False
    if dn is not None and dn.split(".")[-1] == "inject":
        head = dn.split(".")[0]
        origin = ctx.import_origin.get(head, "")
        is_inject = ("chaos" in dn or "chaos" in origin or
                     ctx.from_imports.get("inject", "").startswith(
                         _PKG + ".chaos"))
    if is_inject and node.args and isinstance(node.args[0], ast.Constant) \
            and isinstance(node.args[0].value, str):
        return node.args[0].value
    return None


@project_rule("R13", "config-drift")
def check_config_drift(ctxs: List[FileContext], _engine) -> Iterator[Finding]:
    """Two declared-vs-used closures that otherwise drift silently.

    **Config knobs**: every ``_config.define("name", ...)`` must be read
    somewhere (``_config.get("name")`` or ``_config.name``) — a dead knob
    is a promise the runtime no longer keeps — and every read/set must
    name a defined knob (an undefined name fails at runtime, but only on
    the path that reads it).  **Chaos points**: every
    ``chaos.inject("point")`` site in the runtime must be exercised by at
    least one test (a spec string or direct inject in ``tests/``), else
    the fault path is dead weight chaos never validates; and every
    dotted point a test spec references must exist in the runtime (or be
    injected by the test itself), else the test silently runs fault-free."""
    defines: Dict[str, Tuple[FileContext, int]] = {}
    reads: Set[str] = set()
    uses: List[Tuple[str, FileContext, int]] = []   # get/set/attr sites
    dynamic_access = False
    declared_points: Dict[str, Tuple[FileContext, int]] = {}
    test_points: Set[str] = set()
    test_injects: Set[str] = set()
    spec_refs: List[Tuple[str, FileContext, int]] = []
    have_tests = any(_is_test_path(c.relpath) for c in ctxs)

    for ctx in ctxs:
        is_test = _is_test_path(ctx.relpath)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                point = _chaos_inject_point(node, ctx)
                if point is not None:
                    if is_test:
                        test_injects.add(point)
                        test_points.add(point)
                    else:
                        declared_points.setdefault(point,
                                                   (ctx, node.lineno))
                if isinstance(node.func, ast.Attribute) and \
                        isinstance(node.func.value, ast.Name) and \
                        _config_receiver(node.func.value.id, ctx):
                    attr = node.func.attr
                    if attr in ("get", "set", "define") and node.args:
                        arg = node.args[0]
                        if isinstance(arg, ast.Constant) and \
                                isinstance(arg.value, str):
                            if attr == "define":
                                defines.setdefault(arg.value,
                                                   (ctx, node.lineno))
                            else:
                                if attr == "get":
                                    reads.add(arg.value)
                                uses.append((arg.value, ctx, node.lineno))
                        else:
                            dynamic_access = True
            elif isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Name) and \
                    _config_receiver(node.value.id, ctx) and \
                    isinstance(node.ctx, ast.Load) and \
                    node.attr not in _CONFIG_METHODS and \
                    not node.attr.startswith("_"):
                reads.add(node.attr)
                uses.append((node.attr, ctx, node.lineno))
            elif isinstance(node, ast.Constant) and is_test and \
                    isinstance(node.value, str) and "=" in node.value:
                for seg in node.value.split(";"):
                    m = _CHAOS_SPEC_RE.match(seg.strip())
                    if m:
                        test_points.add(m.group(1))
                        spec_refs.append((m.group(1), ctx,
                                          getattr(node, "lineno", 1)))

    if defines:
        if not dynamic_access:
            for name in sorted(defines):
                ctx, line = defines[name]
                if name in reads or ctx.allowed(line, "R13", "config-drift"):
                    continue
                yield Finding(
                    "R13", "config-drift", ctx.relpath, line,
                    f"config knob '{name}' is defined but never read "
                    f"anywhere in the tree — dead knob or missing wiring; "
                    f"wire it in, delete it, or justify with "
                    f"'# raylint: allow(config-drift) <why>'")
        for name, ctx, line in sorted(uses, key=lambda u: (u[1].relpath,
                                                           u[2], u[0])):
            if name in defines or ctx.allowed(line, "R13", "config-drift"):
                continue
            yield Finding(
                "R13", "config-drift", ctx.relpath, line,
                f"config knob '{name}' is accessed here but never defined "
                f"— this raises at runtime, but only on the path that "
                f"reads it")

    if have_tests and declared_points:
        for point in sorted(declared_points):
            ctx, line = declared_points[point]
            if point in test_points or \
                    ctx.allowed(line, "R13", "config-drift"):
                continue
            yield Finding(
                "R13", "config-drift", ctx.relpath, line,
                f"chaos point '{point}' is declared here but never "
                f"exercised by tests/ — the fault path is unvalidated; "
                f"add a chaos test or justify with "
                f"'# raylint: allow(config-drift) <why>'")
        for point, ctx, line in sorted(spec_refs,
                                       key=lambda r: (r[1].relpath, r[2])):
            if point in declared_points or point in test_injects or \
                    ctx.allowed(line, "R13", "config-drift"):
                continue
            yield Finding(
                "R13", "config-drift", ctx.relpath, line,
                f"test chaos spec references injection point '{point}' "
                f"which no runtime inject() declares — the test runs "
                f"fault-free")


# --------------------------------------------------------------------------
# R14: observability spans must be context-managed (closed on every path)

_OBS_MODULE = _PKG + ".observability"


def _is_obs_span_call(node: ast.Call, ctx: FileContext) -> bool:
    """True when *node* calls ``ray_tpu_torch.observability``'s ``span``."""
    dn = _dotted(node.func)
    if dn is None:
        return False
    if dn == "span":
        origin = ctx.import_origin.get("span", "")
        return origin == _OBS_MODULE + ".span" or \
            ctx.from_imports.get("span", "") == _OBS_MODULE
    if not dn.endswith(".span"):
        return False
    head = dn.split(".")[0]
    origin = ctx.import_origin.get(head, "")
    return origin == _OBS_MODULE or \
        origin + "." + dn.split(".", 1)[1] == _OBS_MODULE + ".span" or \
        dn == _OBS_MODULE + ".span"


@rule("R14", "span-leak")
def check_span_leak(ctx: FileContext) -> Iterator[Finding]:
    """``observability.span(...)`` is context-manager-only outside the
    observability package: constructed bare (bound to a name, passed
    around, or ``__enter__``-ed by hand) there is an exit path — an
    exception between enter and exit — on which the span never records
    and its context var never resets, silently re-parenting every later
    span in that thread.  ``with observability.span(...):`` closes both
    on every path."""
    norm = ctx.relpath.replace("\\", "/")
    if "observability" in norm.split("/")[:-1]:
        return  # the package itself implements the context manager
    with_calls: Set[int] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if isinstance(item.context_expr, ast.Call):
                    with_calls.add(id(item.context_expr))
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or id(node) in with_calls:
            continue
        if not _is_obs_span_call(node, ctx):
            continue
        if ctx.allowed(node.lineno, "R14", "span-leak"):
            continue
        yield Finding(
            "R14", "span-leak", ctx.relpath, node.lineno,
            "observability.span(...) outside a 'with' statement: the span "
            "is not closed on every exit path (leaked context var, span "
            "never recorded) — use 'with observability.span(...):', or "
            "justify with '# raylint: allow(span-leak) <why>'")


# R15: metric label cardinality (unbounded tag values)

_METRIC_METHODS = {"inc", "set", "observe", "set_default_tags"}
_UNBOUNDED_ID_RE = re.compile(
    r"(?:^|_)(?:task_id|object_id|actor_id|trace_id|span_id|request_id|"
    r"job_id|node_id|oid|uuid|addr|address|peer)$", re.IGNORECASE)


def _unbounded_tag_value(expr: ast.expr) -> bool:
    """True when a tag-value expression smells like per-entity runtime
    data (an id hex, a raw address, an f-string embedding one) rather
    than a small closed set of label values."""
    if isinstance(expr, ast.Call):
        fn = expr.func
        if isinstance(fn, ast.Attribute) and fn.attr == "hex":
            return True
        if isinstance(fn, ast.Name) and fn.id in ("str", "repr") and \
                expr.args:
            return _unbounded_tag_value(expr.args[0])
        return False
    if isinstance(expr, ast.Name):
        return bool(_UNBOUNDED_ID_RE.search(expr.id))
    if isinstance(expr, ast.Attribute):
        return bool(_UNBOUNDED_ID_RE.search(expr.attr))
    if isinstance(expr, ast.JoinedStr):
        return any(isinstance(v, ast.FormattedValue)
                   and _unbounded_tag_value(v.value)
                   for v in expr.values)
    if isinstance(expr, ast.BinOp):
        return _unbounded_tag_value(expr.left) or \
            _unbounded_tag_value(expr.right)
    if isinstance(expr, ast.Subscript):
        return _unbounded_tag_value(expr.value)
    return False


@rule("R15", "metrics-cardinality")
def check_metrics_cardinality(ctx: FileContext) -> Iterator[Finding]:
    """A metric tag whose value is per-entity runtime data (object/task/
    trace ids, raw peer addresses) mints a new time series per entity:
    the registry, every scrape and the federated export all grow without
    bound, and the aggregation the label was supposed to enable drowns
    in one-sample series.  Flags ``inc``/``set``/``observe``/
    ``set_default_tags`` calls whose ``tags`` dict-literal values look
    unbounded (``.hex()`` of an id, id-ish names, f-strings embedding
    either).  Values genuinely bounded by something small (cluster
    size) are justified in place with
    ``# raylint: allow(metrics-cardinality) <why>``."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or \
                not isinstance(node.func, ast.Attribute) or \
                node.func.attr not in _METRIC_METHODS:
            continue
        tags = None
        for kw in node.keywords:
            if kw.arg == "tags":
                tags = kw.value
        if tags is None and node.func.attr == "set_default_tags" and \
                node.args:
            tags = node.args[0]
        if not isinstance(tags, ast.Dict):
            continue
        bad = [k.value for k, v in zip(tags.keys, tags.values)
               if isinstance(k, ast.Constant) and _unbounded_tag_value(v)]
        if not bad:
            continue
        if ctx.allowed(node.lineno, "R15", "metrics-cardinality"):
            continue
        yield Finding(
            "R15", "metrics-cardinality", ctx.relpath, node.lineno,
            f"metric tag(s) {', '.join(repr(b) for b in bad)} take "
            "per-entity runtime values (ids / raw addresses): every "
            "entity mints a new time series, growing the registry and "
            "every scrape without bound — tag with a bounded category "
            "instead, or justify with "
            "'# raylint: allow(metrics-cardinality) <why>'")


# --------------------------------------------------------------------------
# R16: resource lifecycle — acquire/release on every path (dataflow layer)

@project_rule("R16", "resource-leak")
def check_resource_leak(ctxs: List[FileContext],
                        engine) -> Iterator[Finding]:
    """An OS-backed resource (socket, file handle, mmap, non-daemon
    thread, executor pool) acquired on some path but neither released
    nor ownership-transferred before the function exits on that path.
    The path-sensitive walk in :mod:`ray_tpu_torch.devtools.dataflow` models
    explicit control flow — ``return``/``raise``, ``try``/``except``/
    ``finally`` exception edges, and constructor aborts inside
    ``__init__`` — and treats anything it cannot prove it understands
    (stores, container adds, resolved callees that keep their argument,
    captures) as a transfer, so it under-reports rather than guesses.
    Dynamic handoffs the walker cannot see are asserted in place with
    ``# raylint: transfer(<kind>) <why>`` on the acquire line; wrong-rule
    findings use ``# raylint: allow(resource-leak) <why>``."""
    idx = engine.index(ctxs)
    for q in sorted(idx.functions):
        fn = idx.functions[q]
        if fn.synthetic:
            continue              # arm statements belong to the dispatcher
        for fact, exit_state in _df.resource_leaks(fn, idx):
            if fn.ctx.allowed(fact.line, "R16", "resource-leak"):
                continue
            where = {"return": "the return at line %d" % exit_state.line,
                     "fall": "the fall-through exit at line %d"
                             % exit_state.line,
                     "raise": "the raise at line %d" % exit_state.line,
                     "ctor-raise": "__init__ aborting if line %d raises"
                                   % exit_state.line}[exit_state.kind]
            steps = " -> ".join(
                f"{note}@{ln}" for ln, note in exit_state.trail[-6:])
            yield Finding(
                "R16", "resource-leak", fn.ctx.relpath, fact.line,
                f"{fact.kind} '{fact.var or '<anon>'}' acquired here in "
                f"'{fn.name}' is still open at {where}"
                + (f" (path: {steps})" if steps else "")
                + " — release it on every path, hand it to an owner, or "
                  "mark the handoff with '# raylint: transfer("
                + fact.kind + ") <why>'")


# --------------------------------------------------------------------------
# R17: deadline propagation — no naked blocking under a time budget

@project_rule("R17", "deadline-drop")
def check_deadline_drop(ctxs: List[FileContext],
                        engine) -> Iterator[Finding]:
    """A blocking primitive with no timeout (``.wait()`` / zero-arg
    ``.join()`` / ``.result()`` / lock ``.acquire()`` / queue ``.get()``
    / ``concurrent.futures.wait``) reachable over ``call`` edges from a
    deadline-scoped entry point — a function that takes a ``deadline``/
    ``timeout``/``budget`` parameter or arms a ``BackoffPolicy``
    deadline.  Such a call silently drops the budget the caller was
    promised: the drain orchestrator, checkpoint engine and RPC layer
    all size their budgets assuming callees stay bounded.  Pass the
    remaining budget down (``timeout=deadline - time.monotonic()``), or
    justify with ``# raylint: allow(deadline-drop) <why>``."""
    idx = engine.index(ctxs)
    direct: Dict[str, List[Tuple[int, Tuple[str, int, str]]]] = {}
    for q, fn in idx.functions.items():
        if fn.is_async or fn.synthetic:
            continue              # event-loop blocking is R1/R10's domain
        for line, desc in _df.naked_blocking(fn.node, fn.ctx):
            direct.setdefault(q, []).append((line, (q, line, desc)))
    closure = idx.transitive_paths(direct, kinds=("call",))
    seen: Set[Tuple[str, int]] = set()
    for q in sorted(idx.functions):
        root = idx.functions[q]
        if root.is_async or root.synthetic:
            continue
        params = _df.deadline_params(root.node)
        scope = (f"'{root.name}({', '.join(params)})'" if params else None)
        if scope is None:
            line = _df.arms_backoff_budget(root.node)
            if line is None:
                continue
            scope = f"'{root.name}' (BackoffPolicy deadline at line {line})"
        for key, path in sorted(closure.get(q, {}).items()):
            site_q, site_line, desc = key
            site_fn = idx.functions[site_q]
            if site_fn.is_async or (site_q, site_line) in seen:
                continue
            seen.add((site_q, site_line))
            if site_fn.ctx.allowed(site_line, "R17", "deadline-drop"):
                continue
            chain = " -> ".join(
                f"{idx.functions[s].name}@{ln}" for s, ln in path)
            yield Finding(
                "R17", "deadline-drop", site_fn.ctx.relpath, site_line,
                f"{desc} blocks with no bound under the deadline scope "
                f"{scope} (witness: {chain}) — pass the remaining budget "
                "down, or justify with "
                "'# raylint: allow(deadline-drop) <why>'")


# --------------------------------------------------------------------------
# R18: protocol conformance — senders, handlers, replies, lifecycle

@project_rule("R18", "protocol")
def check_protocol_conformance(ctxs: List[FileContext],
                               engine) -> Iterator[Finding]:
    """Cross-checks the RPC message vocabulary and the PR 8 node
    lifecycle, in four parts: (a) every ``pb.<METHOD>`` handed to a send
    primitive must have a dispatch arm somewhere (python ``.method ==``
    comparisons or a native ``case raytpu::M:``); (b) every
    python-side dispatch arm must have a sender somewhere (python or a
    native ``set_method``); (c) a handler that replies through its
    ``RpcContext`` must reply exactly once on every non-raising path it
    completes (the conn loop error-replies for raising paths); (d) every
    static ``<node>.state = "<STATE>"`` write must be a transition the
    declared ``dataflow.NODE_LIFECYCLE`` table admits.  Unknowns (a
    context that escapes, an unguarded write to a reachable state)
    degrade to silence, never to a guessed finding."""
    idx = engine.index(ctxs)
    base = ""
    for ctx in ctxs:
        rel = ctx.relpath.replace("\\", "/")
        if rel.startswith(_PKG + "/") or f"/{_PKG}/" in rel:
            base = ctx.path[:-len(ctx.relpath)] if \
                ctx.path.endswith(ctx.relpath) else \
                ctx.path[:ctx.path.rfind(rel.split("/", 1)[0])]
            break
    native_handled, native_sent = _df.native_protocol_facts(
        os.path.join(base, _PKG, "_native")) if base else (set(), set())
    proto_names = _df.proto_method_names(
        os.path.join(base, _PKG, "protocol", "raytpu.proto")) \
        if base else set()

    sends = _df.protocol_sends(ctxs)
    handlers = _df.protocol_handlers(ctxs)
    sent_names = {m for m, _c, _l in sends} | native_sent
    handled_names = {m for m, _c, _l in handlers} | native_handled
    skip = {"METHOD_UNSPECIFIED"}
    if proto_names:
        # names outside the Method enum (other pb constants riding the
        # same attribute shape) are not protocol methods at all
        universe = proto_names - skip
    else:
        universe = (sent_names | handled_names) - skip

    reported: Set[Tuple[str, str, int]] = set()
    for m, ctx, line in sorted(sends, key=lambda s: (s[1].relpath, s[2])):
        if m not in universe or m in handled_names:
            continue
        if (m, ctx.relpath, line) in reported:
            continue
        reported.add((m, ctx.relpath, line))
        if ctx.allowed(line, "R18", "protocol"):
            continue
        yield Finding(
            "R18", "protocol", ctx.relpath, line,
            f"message kind {m} is sent here but no dispatcher handles it "
            "(checked python '.method ==' arms and the native "
            "'case raytpu::' switch) — the peer will error-reply every "
            "call; add the handler or retire the sender")
    seen_handler: Set[str] = set()
    for m, ctx, line in sorted(handlers,
                               key=lambda s: (s[1].relpath, s[2])):
        if m not in universe or m in sent_names or m in seen_handler:
            continue
        seen_handler.add(m)
        if ctx.allowed(line, "R18", "protocol"):
            continue
        yield Finding(
            "R18", "protocol", ctx.relpath, line,
            f"dispatch arm for {m} has no sender anywhere (python send "
            "primitives and native set_method checked) — dead protocol "
            "surface; retire the arm or wire up the caller")

    for q in sorted(idx.functions):
        fn = idx.functions[q]
        if fn.is_async or fn.synthetic:
            continue
        recv = _df.reply_candidates(fn)
        if recv is None:
            continue
        flow = _df.FunctionDataflow(fn.node, fn.ctx, reply_recv=recv)
        if flow.is_generator:
            continue
        exits = flow.run()
        if flow.reply_recv_escaped:
            continue              # a helper we can't see may reply
        for ex in exits:
            if ex.kind in ("raise", "ctor-raise"):
                if ex.replies <= 1:
                    continue      # conn loop error-replies raising paths
            if ex.replies == 1:
                continue
            line = ex.line if ex.replies else fn.node.lineno
            if fn.ctx.allowed(line, "R18", "protocol"):
                continue
            steps = " -> ".join(f"{note}@{ln}" for ln, note in ex.trail[-6:])
            what = ("never replies" if ex.replies == 0
                    else f"replies {ex.replies} times")
            yield Finding(
                "R18", "protocol", fn.ctx.relpath, line,
                f"handler '{fn.name}' {what} on the path exiting at line "
                f"{ex.line}" + (f" (path: {steps})" if steps else "")
                + f" — every completed path must call {recv}.reply/"
                  f"{recv}.reply_error exactly once")
            break                 # one witness path per handler

    legal_targets = {t for _f, t in _df.NODE_LIFECYCLE["transitions"]}
    for ctx, line, recv, froms, to, guard_line in \
            _df.lifecycle_writes(ctxs):
        if ctx.allowed(line, "R18", "protocol"):
            continue
        if froms == {"*"}:
            if to in legal_targets:
                continue
            yield Finding(
                "R18", "protocol", ctx.relpath, line,
                f"node-lifecycle write '{recv}.state = \"{to}\"' targets "
                "a state no declared transition reaches "
                "(dataflow.NODE_LIFECYCLE) — fix the write or extend the "
                "declared machine")
            continue
        bad = sorted(f for f in froms
                     if (f, to) not in _df.NODE_LIFECYCLE["transitions"])
        if bad:
            yield Finding(
                "R18", "protocol", ctx.relpath, line,
                f"undeclared node-lifecycle transition "
                f"{' / '.join(repr(b) for b in bad)} -> {to!r} (guard at "
                f"line {guard_line}) — dataflow.NODE_LIFECYCLE is the "
                "declared machine; fix the transition or extend the table")


# --------------------------------------------------------------------------
# R19: distributed deadlock — blocking-wait cycles over the stitched graph

@project_rule("R19", "distributed-deadlock")
def check_distributed_deadlock(ctxs: List[FileContext],
                               engine) -> Iterator[Finding]:
    """Deadlocks that only exist once the process boundary is crossed,
    found on the cross-process edges the stitch pass adds (rpc ``kind``
    call sites into synthesized dispatch arms).  Two arms: (a) a
    *wait cycle* — handling method M can issue a synchronous RPC whose
    handler (transitively) issues a synchronous RPC back into M; with
    the request/reply slots saturated in both directions, two daemons
    wait on each other forever; (b) *lock held across RPC* — a thread
    holds lock L while blocking on a synchronous send of M, and M's
    handler can re-acquire the same lock node L: two symmetric daemons
    doing this to each other is AB/BA across the wire.  Both arms
    report in lockwatch's ``CYCLE (site-order)`` format over
    ``rpc:<METHOD>`` / lock sites, so a static finding and a runtime
    lockwatch report of the same shape correlate.  Fire-and-forget
    sends (``call_async``/``send_oneway``/``push``) never wait and are
    never part of a cycle here."""
    from ray_tpu_torch.devtools import lockwatch
    idx = engine.index(ctxs)
    # facts: synchronous sends, keyed for the method-level closure
    direct: Dict[str, List[Tuple[int, Tuple[str, str, int]]]] = {}
    for q, line, m, sync, _held, _targets in idx.rpc_sites:
        if sync:
            direct.setdefault(q, []).append((line, (m, q, line)))
    closure = idx.transitive_paths(direct, kinds=("call",))

    # (a) method graph: rpc:M -> rpc:M2 when an arm handling M can reach
    # a synchronous send of M2 over ordinary call edges
    out_sends: Dict[str, List[Tuple[str, Tuple[str, int],
                                    List[Tuple[str, int]]]]] = {}
    succ: Dict[str, List[str]] = {}
    for m in sorted(idx.rpc_arms):
        node = f"rpc:{m}"
        outs: Set[str] = set()
        for aq in idx.rpc_arms[m]:
            for key, path in sorted(closure.get(aq, {}).items()):
                m2, sq, sline = key
                outs.add(f"rpc:{m2}")
                out_sends.setdefault(node, []).append(
                    (f"rpc:{m2}", (sq, sline), path))
        succ[node] = sorted(outs)
    for comp in lockwatch._sccs(sorted(succ), succ):
        if len(comp) < 2 and comp[0] not in succ.get(comp[0], ()):
            continue
        in_comp = set(comp)
        anchor = None
        for node in sorted(in_comp):
            for to, (sq, sline), path in sorted(out_sends.get(node, [])):
                if to not in in_comp:
                    continue
                site_fn = idx.functions[sq]
                if site_fn.ctx.allowed(sline, "R19", "distributed-deadlock"):
                    continue
                anchor = (node, to, site_fn, sline, path)
                break
            if anchor:
                break
        if anchor is None:
            continue              # every edge carries a justification
        node, to, site_fn, sline, path = anchor
        chain = " -> ".join(
            f"{idx.functions[s].name}@{ln}" for s, ln in path)
        yield Finding(
            "R19", "distributed-deadlock", site_fn.ctx.relpath, sline,
            f"static {lockwatch.format_cycle('site-order', sorted(in_comp))}"
            f"; handling {node[4:]} can synchronously send {to[4:]} here "
            f"(witness: {chain}) — with request slots saturated both ways "
            "the two daemons wait on each other forever; make one hop "
            "asynchronous or justify with "
            "'# raylint: allow(distributed-deadlock) <why>'")

    # (b) lock held across a synchronous send whose handler can
    # re-acquire the same lock node
    acq: Dict[str, List[Tuple[int, str]]] = {}
    for q, fn in idx.functions.items():
        for lid, line, _held in fn.acquires:
            acq.setdefault(q, []).append((line, lid))
    acq_closure = idx.transitive_paths(acq, kinds=("call",))
    seen: Set[Tuple[str, int, str, str]] = set()
    for q, line, m, sync, held, targets in sorted(idx.rpc_sites):
        if not sync or not held:
            continue
        fn = idx.functions[q]
        for aq in targets:
            reacquired = set(acq_closure.get(aq, {}))
            for lid in sorted(set(held) & reacquired):
                key = (fn.ctx.relpath, line, lid, m)
                if key in seen:
                    continue
                seen.add(key)
                if fn.ctx.allowed(line, "R19", "distributed-deadlock"):
                    continue
                lpath = acq_closure[aq][lid]
                chain = " -> ".join(
                    f"{idx.functions[s].name}@{ln}" for s, ln in lpath)
                yield Finding(
                    "R19", "distributed-deadlock", fn.ctx.relpath, line,
                    f"static "
                    f"{lockwatch.format_cycle('site-order', sorted([lid, 'rpc:' + m]))}"
                    f"; '{fn.name}' holds {lid} while synchronously "
                    f"sending {m}, and the {m} handler can re-acquire "
                    f"{lid} ({chain}) — two peers doing this to each "
                    "other is AB/BA across the wire (lockwatch reports "
                    "the same cycle at runtime under RAY_TPU_LOCKWATCH); "
                    "release the lock before the call or justify with "
                    "'# raylint: allow(distributed-deadlock) <why>'")


# --------------------------------------------------------------------------
# R20: handler stall — unbounded blocking reachable from an RPC handler

@project_rule("R20", "handler-stall")
def check_handler_stall(ctxs: List[FileContext],
                        engine) -> Iterator[Finding]:
    """R17's naked-blocking catalog (bare ``.wait()`` / ``.join()`` /
    ``.result()`` / lock ``.acquire()`` / queue ``.get()``), rooted not
    at deadline scopes but at RPC dispatch arms: a handler that blocks
    without a bound stalls a dispatch-pool thread — and with the pool
    saturated, frame dispatch for *every* caller of that server.  A
    witness function on the path that takes a ``deadline``/``timeout``
    parameter or arms a ``BackoffPolicy`` budget bounds the wait (and
    puts it in R17's jurisdiction), so those paths are suppressed
    here."""
    idx = engine.index(ctxs)
    direct: Dict[str, List[Tuple[int, Tuple[str, int, str]]]] = {}
    for q, fn in idx.functions.items():
        # synthetic arms keep their facts: a bare wait written lexically
        # inside a dispatch arm must anchor under that arm's qname
        if fn.is_async:
            continue
        for line, desc in _df.naked_blocking(fn.node, fn.ctx):
            direct.setdefault(q, []).append((line, (q, line, desc)))
    closure = idx.transitive_paths(direct, kinds=("call",))
    seen: Set[Tuple[str, int]] = set()
    for m in sorted(idx.rpc_arms):
        for aq in idx.rpc_arms[m]:
            for key, path in sorted(closure.get(aq, {}).items()):
                site_q, site_line, desc = key
                site_fn = idx.functions[site_q]
                if (site_fn.ctx.relpath, site_line) in seen:
                    continue
                seen.add((site_fn.ctx.relpath, site_line))
                if any(_df.deadline_params(idx.functions[s].node)
                       or _df.arms_backoff_budget(idx.functions[s].node)
                       is not None for s, _ln in path):
                    continue      # budget-scoped: bounded, and R17's job
                if site_fn.ctx.allowed(site_line, "R20", "handler-stall"):
                    continue
                chain = " -> ".join(
                    f"{idx.functions[s].name}@{ln}" for s, ln in path)
                yield Finding(
                    "R20", "handler-stall", site_fn.ctx.relpath, site_line,
                    f"{desc} blocks with no bound and is reachable from "
                    f"the {m} dispatch arm (witness: {chain}) — a stalled "
                    "handler pins a dispatch thread and, pool exhausted, "
                    "stalls every caller of this server; bound the wait "
                    "or justify with '# raylint: allow(handler-stall) "
                    "<why>'")


# --------------------------------------------------------------------------
# R21: compile stability — rebuild hazards at torch.compile / CUDA-graph
# sites, and tensors written in place after they were put

_R21_CTORS = {"torch.compile": "torch.compile",
              "torch.jit.script": "torch.jit.script",
              "torch.jit.trace": "torch.jit.trace",
              "torch.cuda.CUDAGraph": "CUDAGraph",
              "torch.cuda.graphs.CUDAGraph": "CUDAGraph"}
_R21_CACHED_DECOS = {"functools.lru_cache", "lru_cache",
                     "functools.cache", "cache"}


def _compile_ctor_name(node: ast.Call, ctx: FileContext) -> Optional[str]:
    """The constructor ("torch.compile", "torch.jit.script", "CUDAGraph",
    ...) when *node* builds a compiled callable or a CUDA graph, else
    None.  The name must resolve into torch through the file's imports,
    so a local helper named ``compile`` does not trip the rule."""
    return _R21_CTORS.get(_resolved_name(node.func, ctx) or "")


def _put_target(node: ast.Call, ctx: FileContext) -> bool:
    """True when *node* calls this package's ``put``."""
    return _resolved_name(node.func, ctx) in (
        _PKG + ".put", _PKG + "._private.worker.put")


def _inplace_writes(fn: ast.AST, name: str,
                    after: int) -> List[Tuple[int, str]]:
    """In-place writes to *name* after line *after* (``name.add_(...)``,
    ``name[...] = ...``, ``name += ...``, ``out=name``) before the first
    line at which *name* is bound anew (from there on it is another
    tensor)."""
    writes: List[Tuple[int, str]] = []
    rebound: Optional[int] = None
    for m in _walk_pruned(fn):
        line = getattr(m, "lineno", 0)
        if line <= after:
            continue
        if isinstance(m, ast.Assign):
            for t in m.targets:
                if _dotted(t) == name:
                    rebound = line if rebound is None else min(rebound, line)
                elif isinstance(t, ast.Subscript) and \
                        _dotted(t.value) == name:
                    writes.append((line, f"{name}[...] = ..."))
        elif isinstance(m, ast.AugAssign):
            t = m.target
            if _dotted(t) == name or (isinstance(t, ast.Subscript)
                                      and _dotted(t.value) == name):
                writes.append((line, f"augmented assignment to {name}"))
        elif isinstance(m, ast.Call):
            f = m.func
            if isinstance(f, ast.Attribute) and _dotted(f.value) == name \
                    and f.attr.endswith("_") and not f.attr.startswith("_"):
                writes.append((line, f"{name}.{f.attr}(...)"))
            for kw in m.keywords:
                if kw.arg == "out" and _dotted(kw.value) == name:
                    writes.append((line, f"out={name}"))
        elif isinstance(m, ast.For) and any(
                _dotted(t) == name for t in ast.walk(m.target)
                if isinstance(t, (ast.Name, ast.Attribute))):
            rebound = line if rebound is None else min(rebound, line)
    if rebound is not None:
        writes = [w for w in writes if w[0] < rebound]
    return sorted(writes)


def _r21_msg(what: str) -> str:
    return (what + " — every rebuild re-traces and recompiles ("
            "compile time is a first-order cost at scale); "
            "justify with '# raylint: allow(jit-stability) <why>'")


@rule("R21", "jit-stability")
def check_jit_stability(ctx: FileContext) -> Iterator[Finding]:
    """Rebuild and stale-buffer hazards, the PyTorch form: (a) a
    ``torch.compile`` / ``torch.jit.script``/``trace`` callable or a
    ``torch.cuda.CUDAGraph`` constructed inside a loop, or (b) per call —
    built and invoked (called, or ``.replay()``-ed) within one function
    without being stored on an object, returned to a caching caller, or
    memoized — throws the compiled code or the captured graph away every
    iteration/call; (c) a tensor handed to this package's ``put`` and then
    written in place in the same function (``t.add_()``, ``t[...] =``,
    ``t += ...``, ``out=t``) before being bound anew: the store keeps the
    tensor by reference and ``get`` refuses it once its version counter
    moves ("modified in place").  JAX forms with no PyTorch counterpart
    stay out: ``static_argnums`` does not exist, and ``torch.compile``
    marks an int argument dynamic after its first change rather than
    re-tracing per batch size.  Dynamic constructs degrade to
    silence."""

    seen: Set[Tuple[int, str]] = set()

    def emit(line: int, check: str, what: str) -> Iterator[Finding]:
        if (line, check) in seen:
            return
        seen.add((line, check))
        if not ctx.allowed(line, "R21", "jit-stability"):
            yield Finding("R21", "jit-stability", ctx.relpath, line,
                          what if check == "put-write" else _r21_msg(what))

    # (a) construction inside a loop — any scope, module level too
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.For, ast.While)):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                leaf = _compile_ctor_name(sub, ctx)
                if leaf:
                    yield from emit(
                        sub.lineno, "loop",
                        f"'{leaf}' constructed inside a loop (line "
                        f"{node.lineno}): a fresh callable or graph per "
                        "iteration never reuses its compiled code; hoist "
                        "it out")

    for cls, fn in _funcs_with_class(ctx.tree):
        cached = any(_dotted(d.func if isinstance(d, ast.Call) else d)
                     in _R21_CACHED_DECOS for d in fn.decorator_list)

        # (b) constructed and invoked per call of this function
        if fn.name != "__init__" and not cached:
            local_ctors: Dict[str, Tuple[int, str]] = {}
            returned: Set[str] = set()
            called: Set[str] = set()
            for n in _walk_pruned(fn):
                if isinstance(n, ast.Call):
                    inner = n.func
                    if isinstance(inner, ast.Call):
                        ileaf = _compile_ctor_name(inner, ctx)
                        if ileaf:
                            yield from emit(
                                inner.lineno, "per-call",
                                f"'{ileaf}(...)' built and invoked in one "
                                f"expression inside '{fn.name}': every "
                                "call recompiles; build once and reuse")
                    if isinstance(n.func, ast.Name):
                        called.add(n.func.id)
                    elif isinstance(n.func, ast.Attribute) and \
                            n.func.attr == "replay" and \
                            isinstance(n.func.value, ast.Name):
                        called.add(n.func.value.id)
                elif isinstance(n, ast.Assign) and len(n.targets) == 1 \
                        and isinstance(n.targets[0], ast.Name) \
                        and isinstance(n.value, ast.Call):
                    leaf = _compile_ctor_name(n.value, ctx)
                    if leaf:
                        local_ctors[n.targets[0].id] = (n.value.lineno, leaf)
                elif isinstance(n, ast.Return) and n.value is not None:
                    if isinstance(n.value, ast.Name):
                        returned.add(n.value.id)
            for name, (line, leaf) in sorted(local_ctors.items()):
                if name in called and name not in returned:
                    yield from emit(
                        line, "per-call",
                        f"'{leaf}' result bound to local '{name}' and "
                        f"invoked inside '{fn.name}': it dies with the "
                        "frame, so every call rebuilds it; cache it "
                        "(module level, an attribute, or "
                        "functools.lru_cache)")

        # (c) a put tensor written in place before it is bound anew
        for n in _walk_pruned(fn):
            if not isinstance(n, ast.Call) or not n.args or \
                    not _put_target(n, ctx):
                continue
            ptxt = _dotted(n.args[0])
            if ptxt is None:
                continue
            call_end = getattr(n, "end_lineno", n.lineno)
            writes = _inplace_writes(fn, ptxt, call_end)
            if writes:
                wline, how = writes[0]
                yield from emit(
                    wline, "put-write",
                    f"'{ptxt}' was handed to put() at line {n.lineno} and "
                    f"is written in place here ({how}): the store holds "
                    "the tensor by reference, so get() of that ref raises "
                    "'modified in place'; put a clone, or write into a "
                    "copy, or justify with '# raylint: allow(jit-stability) "
                    "<why>'")


# --------------------------------------------------------------------------
# R22: metric-name registry — perf/ledger name literals must be declared

_METRIC_REGISTRY: Optional[Tuple[frozenset, frozenset]] = None

# resolved call target -> which registry its first literal arg must hit
_R22_PERF_CALLS = frozenset({_OBS_MODULE + ".perf.observe"})
_R22_LEDGER_CALLS = frozenset({_OBS_MODULE + ".goodput.account",
                               _OBS_MODULE + ".goodput.interval"})


def _metric_registry() -> Tuple[frozenset, frozenset]:
    """(PERF_HISTOGRAMS, LEDGER_CATEGORIES) from
    ``ray_tpu_torch/observability/metric_names.py``.  The module is
    deliberately import-free, and exec'ing its source keeps the linter
    from dragging the observability package (config, runtime state)
    into a static-analysis process."""
    global _METRIC_REGISTRY
    if _METRIC_REGISTRY is None:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            os.pardir, "observability", "metric_names.py")
        ns: Dict[str, object] = {}
        with open(path, encoding="utf-8") as f:
            exec(compile(f.read(), path, "exec"), ns)  # noqa: S102
        _METRIC_REGISTRY = (frozenset(ns["PERF_HISTOGRAMS"]),
                            frozenset(ns["LEDGER_CATEGORIES"]))
    return _METRIC_REGISTRY


def _resolved_call_target(node: ast.Call, ctx: FileContext
                          ) -> Optional[str]:
    """Fully-qualified dotted target of a call, resolving the head
    segment through the file's imports (``from ray_tpu_torch.observability
    import perf`` makes ``perf.observe`` resolve to
    ``ray_tpu_torch.observability.perf.observe``)."""
    return _resolved_name(node.func, ctx)


@rule("R22", "metric-registry")
def check_metric_registry(ctx: FileContext) -> Iterator[Finding]:
    """A literal metric name passed to ``perf.observe(...)`` or a
    literal ledger category passed to ``goodput.account(...)`` /
    ``goodput.interval(...)`` that is not declared in
    ``ray_tpu_torch/observability/metric_names.py``.  A typo'd name does not
    fail at runtime — it silently mints a parallel histogram family
    every consumer (head quantiles, ``ray-tpu top``, doctor baselines)
    ignores, and a misspelled category raises only when that code path
    finally runs.  Non-literal names are dynamic and out of scope."""
    perf_names, ledger_names = _metric_registry()
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        target = _resolved_call_target(node, ctx)
        if target in _R22_PERF_CALLS:
            registry, kind, where = perf_names, "histogram", "PERF_HISTOGRAMS"
        elif target in _R22_LEDGER_CALLS:
            registry, kind, where = (ledger_names, "ledger category",
                                     "LEDGER_CATEGORIES")
        else:
            continue
        arg = node.args[0]
        if not isinstance(arg, ast.Constant) or \
                not isinstance(arg.value, str):
            continue  # dynamic name: statically unverifiable
        if arg.value in registry:
            continue
        if ctx.allowed(node.lineno, "R22", "metric-registry"):
            continue
        yield Finding(
            "R22", "metric-registry", ctx.relpath, node.lineno,
            f"{kind} {arg.value!r} is not declared in "
            f"{_PKG}/observability/metric_names.py ({where}): a typo "
            "here silently mints a parallel series no consumer reads — "
            "fix the name or declare it in the registry")


# --------------------------------------------------------------------------
# R26: actuator bypass — autopilot-owned knobs move only through apply()

_AUTOPILOT_KNOBS: Optional[frozenset] = None


def _autopilot_owned_knobs() -> frozenset:
    """Knob names from ``ray_tpu_torch/autopilot/knobs.py`` (OWNED_KNOBS).
    Same exec-don't-import contract as :func:`_metric_registry`: the
    registry module is import-free by design, so the linter reads the
    ownership table without dragging the runtime in."""
    global _AUTOPILOT_KNOBS
    if _AUTOPILOT_KNOBS is None:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            os.pardir, "autopilot", "knobs.py")
        ns: Dict[str, object] = {}
        with open(path, encoding="utf-8") as f:
            exec(compile(f.read(), path, "exec"), ns)  # noqa: S102
        _AUTOPILOT_KNOBS = frozenset(ns["OWNED_KNOBS"])
    return _AUTOPILOT_KNOBS


@rule("R26", "actuator-bypass")
def check_actuator_bypass(ctx: FileContext) -> Iterator[Finding]:
    """A runtime ``_config.set("<knob>", ...)`` write to an
    autopilot-owned knob (``ray_tpu_torch/autopilot/knobs.py``) outside the
    guardrailed ``autopilot.actuators.apply()`` path.  Such a write
    forks control of the knob: the controller's journal no longer
    explains the value, its SLO watch/revert guarantee silently does
    not cover the foreign write, and the next policy pass may fight it.
    Tests that pin owned knobs run under the scoped allow profile in
    ``run_static_analysis.sh``; dynamic knob names are out of scope."""
    rel = ctx.relpath.replace("\\", "/")
    if "autopilot" in rel.split("/"):
        return  # the actuator layer is the single allowlisted write path
    owned = _autopilot_owned_knobs()
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        if not (isinstance(node.func, ast.Attribute)
                and node.func.attr == "set"):
            continue
        is_registry = (isinstance(node.func.value, ast.Name)
                       and _config_receiver(node.func.value.id, ctx))
        if not is_registry:
            is_registry = (_resolved_call_target(node, ctx)
                           == _PKG + "._private.config._config.set")
        if not is_registry:
            continue
        arg = node.args[0]
        if not isinstance(arg, ast.Constant) or \
                not isinstance(arg.value, str):
            continue  # dynamic knob name: statically unverifiable
        if arg.value not in owned:
            continue
        if ctx.allowed(node.lineno, "R26", "actuator-bypass"):
            continue
        yield Finding(
            "R26", "actuator-bypass", ctx.relpath, node.lineno,
            f"'{arg.value}' is autopilot-owned ({_PKG}/autopilot/"
            f"knobs.py): a direct _config.set bypasses the guardrailed "
            f"actuator layer — no journal record, no bounds clamp, no "
            f"SLO watch/revert; go through {_PKG}.autopilot.actuators"
            f".apply()")


# --------------------------------------------------------------------------
# R23-R25: field-level thread-safety — whole-program lockset analysis
#
# All three rules consume ``ProjectIndex.field_plan()``: per shared
# attribute (``self._x`` / module global), every access site reachable
# from >=2 thread roots, with the *effective* lockset there (locks held
# lexically, unioned with the must-hold intersection over every call
# path from the thread root).  Under-approximation stance throughout:
# a lock only counts as held when provably held, a context only exists
# when the spawn edge resolved — so the rules can under-report but a
# reported witness is real modulo the documented suppressions.


def _field_site(rel: str, line: int) -> str:
    """lockwatch's ``pkg/file.py:line`` site format, so static witnesses
    and runtime lockwatch reports correlate by string."""
    return (f"{os.path.basename(os.path.dirname(rel))}/"
            f"{os.path.basename(rel)}:{line}")


def _ctx_label(plan: "_cg.FieldPlan", cname: str) -> str:
    """Human name for a thread context: ``main`` or the root's
    provenance plus its spawn/dispatch site."""
    root = plan.roots.get(cname)
    if root is None:
        return cname
    rel, line, how = root
    return f"{how} @ {_field_site(rel, line)}"


def _lockset_str(locks: Iterable[str]) -> str:
    inner = ", ".join(sorted(locks))
    return "[" + inner + "]" if inner else "[none]"


def _happens_before_spawn(plan: "_cg.FieldPlan", access: "_cg.FieldAccess",
                          other_ctx: str) -> bool:
    """*access* sits in a function that itself spawns *other_ctx*'s root
    at a later line: the classic single-writer-before-spawn handoff —
    Thread.start() publishes everything written before it."""
    for root, line in plan.spawns_in.get(access.fnq, ()):
        if root == other_ctx and access.line <= line:
            return True
    return False


def _guard_decl_for(idx: "_cg.ProjectIndex", plan: "_cg.FieldPlan",
                    key: str) -> Optional[Tuple[str, str, int]]:
    """The ``guarded-by`` declaration covering *key*: exact match, or one
    declared on a related class — the field is assigned (and declared) in
    a base-class ``__init__``, but accesses from subclass-defined methods
    key under the subclass (``Counter._values`` vs ``Metric._values``)."""
    hit = plan.guarded.get(key)
    if hit is not None or ":" not in key:
        return hit
    fld = key.split(":", 1)[1]
    if "." not in fld:
        return None
    kcls, attr = fld.rsplit(".", 1)
    for dkey in sorted(plan.guarded):
        if ":" not in dkey:
            continue
        dfld = dkey.split(":", 1)[1]
        if "." not in dfld:
            continue
        dcls, dattr = dfld.rsplit(".", 1)
        if dattr == attr and _classes_related(idx, kcls, dcls):
            return plan.guarded[dkey]
    return None


def _field_race_witness(plan: "_cg.FieldPlan", w: "_cg.FieldAccess",
                        o: "_cg.FieldAccess"
                        ) -> Optional[Tuple[str, str]]:
    """A (write-context, other-context) pair under which *w* and *o* can
    interleave with no common lock, or None.  Deterministic: contexts are
    scanned in sorted order, so the first witness is stable across runs."""
    for wc in sorted(w.ctxs):
        for oc in sorted(o.ctxs):
            if wc == oc:
                continue
            if w.ctxs[wc] & o.ctxs[oc]:
                continue
            if _happens_before_spawn(plan, w, oc) or \
                    _happens_before_spawn(plan, o, wc):
                continue
            return wc, oc
    return None


@project_rule("R23", "data-race")
def check_data_race(ctxs: List[FileContext], engine) -> Iterator[Finding]:
    """Whole-program data race: a shared attribute (``self._x`` or a
    module global) written in one thread context and read/written in
    another with an empty lockset intersection between the two sites.
    Thread contexts are the spawn roots the call graph proves distinct —
    ``threading.Thread`` targets, executor submits, RPC dispatch arms,
    ``Thread`` subclass ``run`` methods — plus ``main``.  Suppressed, to
    keep the rule honest: fields only touched during construction
    (immutable-after-init), writes that happen before the racing thread
    is spawned (single-writer handoff), bool/None fast-path flags (torn
    writes are impossible for a pointer-sized constant), atomic-style
    containers (``queue.Queue``, ``deque``, ``Event``, ...), and fields
    carrying a ``guarded-by`` declaration (R25 enforces those).  The
    witness names both thread roots in lockwatch's site format."""
    idx = engine.index(ctxs)
    plan = idx.field_plan()
    ctx_by_rel = {c.relpath: c for c in ctxs}
    for key in sorted(plan.accesses):
        if key in plan.flag_keys or \
                _guard_decl_for(idx, plan, key) is not None:
            continue
        sites = plan.accesses[key]
        emitted = False
        for w in sites:
            if emitted:
                break
            if w.mode not in ("write", "mutate"):
                continue
            for o in sites:
                wit = _field_race_witness(plan, w, o)
                if wit is None:
                    continue
                fctx = ctx_by_rel.get(w.rel)
                if fctx is not None and \
                        fctx.allowed(w.line, "R23", "data-race"):
                    break       # justified at the write: next write site
                wc, oc = wit
                yield Finding(
                    "R23", "data-race", w.rel, w.line,
                    f"data race on {_cg.field_display(key)}: "
                    f"{w.mode}@{_field_site(w.rel, w.line)} vs "
                    f"{o.mode}@{_field_site(o.rel, o.line)} with no common "
                    f"lock (contexts: {_ctx_label(plan, wc)} vs "
                    f"{_ctx_label(plan, oc)}; locks: "
                    f"{_lockset_str(w.ctxs[wc])} vs "
                    f"{_lockset_str(o.ctxs[oc])}) — guard both sites with "
                    "one lock and declare it with '# raylint: "
                    "guarded-by(<lock>)', or justify with '# raylint: "
                    "allow(data-race) <why>'")
                emitted = True
                break
    return


@project_rule("R24", "atomicity-split")
def check_atomicity_split(ctxs: List[FileContext],
                          engine) -> Iterator[Finding]:
    """Atomicity split on a shared attribute: a check-then-act
    (``if self._n < cap: ... self._n += 1`` with the test outside the
    write's critical section) or a read-modify-write whose read and
    dependent write hold no common lock — the lock was released between
    the two halves, so another thread can interleave and the decision
    acts on stale state.  Only fields that are actually shared are
    audited (a ``guarded-by`` declaration, or reachability from >=2
    thread contexts); construction-only code, atomic-style containers,
    and bool fast-path flags are exempt, and double-checked locking
    (re-read under the lock that guards the write) stays quiet."""
    idx = engine.index(ctxs)
    plan = idx.field_plan()
    seen: Set[Tuple[str, int, str]] = set()
    for fnq, key, rline, wline, kind in sorted(plan.splits):
        if key in plan.atomic_keys or key in plan.flag_keys:
            continue
        if fnq in plan.init_only or not plan.contexts.get(fnq):
            continue
        fn = idx.functions.get(fnq)
        if fn is None:
            continue
        shared = _guard_decl_for(idx, plan, key) is not None
        if not shared:
            names: Set[str] = set()
            for a in plan.accesses.get(key, ()):
                names.update(a.ctxs)
            shared = len(names) >= 2
        if not shared:
            continue
        rel = fn.ctx.relpath
        ident = (rel, wline, key)
        if ident in seen:
            continue
        seen.add(ident)
        if fn.ctx.allowed(wline, "R24", "atomicity-split"):
            continue
        yield Finding(
            "R24", "atomicity-split", rel, wline,
            f"atomicity split on {_cg.field_display(key)} ({kind}): the "
            f"read at {_field_site(rel, rline)} and the dependent write "
            f"at {_field_site(rel, wline)} hold no common lock — another "
            "thread can interleave between check and act; widen the "
            "critical section to cover both, or justify with "
            "'# raylint: allow(atomicity-split) <why>'")


def _base_leaf_names(idx: "_cg.ProjectIndex", name: str) -> Set[str]:
    """Transitive base-class leaf names of every class called *name*."""
    out: Set[str] = set()
    work = [name]
    while work:
        n = work.pop()
        for cls in idx.classes.values():
            if cls.name != n:
                continue
            for base in cls.bases:
                leaf = base.rsplit(".", 1)[-1]
                if leaf not in out:
                    out.add(leaf)
                    work.append(leaf)
    return out


def _classes_related(idx: "_cg.ProjectIndex", a: str, b: str) -> bool:
    return a == b or b in _base_leaf_names(idx, a) \
        or a in _base_leaf_names(idx, b)


def _field_lock_matches(idx: "_cg.ProjectIndex", decl: str,
                        held: frozenset) -> bool:
    """The declared lock is provably held: exact identity match, or the
    same attribute on a related class (a base-class method acquiring
    ``self._lock`` satisfies a subclass's declaration and vice versa —
    ``_lock_identity`` names locks after the *defining* class)."""
    if decl in held:
        return True
    dhead, _, dleaf = decl.rpartition(".")
    if not dhead or "." in dhead:
        return False        # module-global lock: identity match only
    for h in held:
        hhead, _, hleaf = h.rpartition(".")
        if hleaf == dleaf and hhead and "." not in hhead and \
                _classes_related(idx, dhead, hhead):
            return True
    return False


def _guard_lock_display(key: str, lock: str) -> str:
    """The lock as a developer would write it in the declaration —
    ``Cls.attr`` back to ``self.attr`` when the class matches the
    field's, a module-qualified global back to its bare name — so R25
    messages string-match lockwatch level-2 runtime reports."""
    head, _, leaf = lock.rpartition(".")
    fld = _cg.field_display(key)
    kcls = fld.rsplit(".", 1)[0] if ":" in key and "." in fld else ""
    if head and head == kcls:
        return "self." + leaf
    if "." in head:
        return leaf
    return lock


@project_rule("R25", "guarded-by")
def check_guarded_by(ctxs: List[FileContext], engine) -> Iterator[Finding]:
    """``# raylint: guarded-by(<lock>)`` enforcement, both directions.
    (a) Every access to a declared field must hold the declared lock —
    checked per thread context with the interprocedural must-hold
    lockset, so a caller-held lock satisfies the contract.  (b) A field
    the analysis proves multi-thread (>=2 contexts, at least one write)
    that is *consistently* locked must carry a declaration — the
    implicit convention becomes a machine-checked contract, and
    ``RAY_TPU_LOCKWATCH=2`` samples the same declarations at runtime,
    printing violations in this rule's format so static and live
    findings correlate by string.  Inconsistently-locked fields are
    R23's jurisdiction, not a missing declaration."""
    from ray_tpu_torch.devtools import lockwatch as _lw
    idx = engine.index(ctxs)
    plan = idx.field_plan()
    ctx_by_rel = {c.relpath: c for c in ctxs}
    # (a) declared fields: the named lock must be held at every site
    # (accesses keyed under a subclass resolve to the base declaration)
    for key in sorted(plan.accesses):
        decl = _guard_decl_for(idx, plan, key)
        if decl is None:
            continue
        lock, drel, dline = decl
        disp = _guard_lock_display(key, lock)
        for a in plan.accesses.get(key, ()):
            bad = [cn for cn in sorted(a.ctxs)
                   if not _field_lock_matches(idx, lock, a.ctxs[cn])]
            if not bad:
                continue
            fctx = ctx_by_rel.get(a.rel)
            if fctx is not None and \
                    fctx.allowed(a.line, "R25", "guarded-by"):
                continue
            yield Finding(
                "R25", "guarded-by", a.rel, a.line,
                _lw.format_guard(_cg.field_display(key), disp)
                + f" (declared at {drel}:{dline}; context "
                f"{_ctx_label(plan, bad[0])}, locks "
                f"{_lockset_str(a.ctxs[bad[0]])}) — acquire the declared "
                "lock, fix the declaration, or justify with '# raylint: "
                "allow(guarded-by) <why>'")
    # (b) proved-shared, consistently-locked fields need a declaration
    for key in sorted(plan.accesses):
        if key in plan.atomic_keys or key in plan.flag_keys \
                or _guard_decl_for(idx, plan, key) is not None:
            continue
        sites = plan.accesses[key]
        names: Set[str] = set()
        for a in sites:
            names.update(a.ctxs)
        if len(names) < 2:
            continue
        writes = sorted((a for a in sites if a.mode in ("write", "mutate")),
                        key=lambda a: (a.rel, a.line))
        if not writes:
            continue
        common: Optional[Set[str]] = None
        for a in sites:
            for held in a.ctxs.values():
                common = set(held) if common is None else (common & held)
        if not common:
            continue        # unlocked somewhere: R23 reports the race
        w = writes[0]
        fctx = ctx_by_rel.get(w.rel)
        if fctx is not None and fctx.allowed(w.line, "R25", "guarded-by"):
            continue
        disp = _guard_lock_display(key, sorted(common)[0])
        yield Finding(
            "R25", "guarded-by", w.rel, w.line,
            f"shared field {_cg.field_display(key)} is reached from "
            f"{len(names)} thread contexts "
            f"({', '.join(_ctx_label(plan, n) for n in sorted(names))}) "
            f"and is consistently locked under {disp}, but carries no "
            f"declaration — annotate the field's assignment with "
            f"'# raylint: guarded-by({disp})' so the convention is "
            "machine-checked here and sampled live under "
            "RAY_TPU_LOCKWATCH=2")


# --------------------------------------------------------------------------
# R27-R29: static SPMD sharding analysis over the shardprop model
#
# All three rules share one ShardModel per run (engine.shard_model); the
# per-file facts ride the incremental cache keyed by content hash, like
# the stitch and field facts.  The propagation lattice is constant-or-top:
# dynamic specs, open mesh/rules universes and starred parts degrade to
# silence — under-report, never invent.

_R27_AXIS_KIND = {
    "spec": "spec_to_placements() spec",
    "rules-table": "ShardingRules table value",
    "override": "with_overrides() value",
}


@project_rule("R27", "mesh-spec")
def check_mesh_spec(ctxs: List[FileContext],
                    engine: "LintEngine") -> Iterator[Finding]:
    """Mesh/spec consistency over the abstract sharding model: a spec
    tuple handed to ``spec_to_placements`` (or a rules-table /
    with_overrides value) naming a mesh axis that no AXIS_ORDER or
    ``DeviceMesh``/``init_device_mesh(mesh_dim_names=...)`` declares, one
    mesh axis bound to two dims of a single spec, ``local_map``
    in_placements arity differing from the mapped callee's parameter
    count, and logical-axis names absent from every reachable
    ShardingRules table.  A one-character axis typo is exactly what
    ShardingRules.spec() would otherwise silently replicate (its strict=
    mode is the runtime half of this check); unresolvable specs and open
    universes degrade to silence.  Justify exceptions with
    '# raylint: allow(mesh-spec) <why>'."""
    model = engine.shard_model(ctxs)
    ctx_by_rel = {c.relpath: c for c in ctxs}
    mesh_known = model.mesh_closed()
    rules_known = model.rules_closed()
    for rel in sorted(model.facts):
        fctx = ctx_by_rel.get(rel)
        facts = model.facts[rel]

        def allowed(line: int) -> bool:
            return fctx is not None and fctx.allowed(line, "R27",
                                                     "mesh-spec")

        if mesh_known:
            for line, ax, kind in facts["axis_sites"]:
                if ax in model.mesh_axes or allowed(line):
                    continue
                yield Finding(
                    "R27", "mesh-spec", rel, line,
                    f"{_R27_AXIS_KIND.get(kind, kind)} names mesh axis "
                    f"'{ax}', but no AXIS_ORDER or DeviceMesh(...) in the "
                    f"tree declares it (known axes: "
                    f"{', '.join(sorted(model.mesh_axes))}) — "
                    "spec_to_placements raises at run time or the "
                    "dimension silently replicates")
        for line, ax in facts["dup_sites"]:
            if allowed(line):
                continue
            yield Finding(
                "R27", "mesh-spec", rel, line,
                f"mesh axis '{ax}' is bound to two dimensions of a single "
                "spec — one mesh dim can shard only one tensor dim, so "
                "the placements silently keep the last; use a tuple "
                "(('a', 'b')) to co-shard one dimension instead")
        for line, got, want, callee in facts["arity_sites"]:
            if allowed(line):
                continue
            yield Finding(
                "R27", "mesh-spec", rel, line,
                f"local_map in_placements carries {got} placement(s) but "
                f"the mapped callable '{callee}' takes {want} positional "
                "argument(s) — the mismatch only surfaces at call time")
        if rules_known:
            for line, name, src in facts["logical_sites"]:
                if name in model.logical_names or allowed(line):
                    continue
                yield Finding(
                    "R27", "mesh-spec", rel, line,
                    f"logical axis '{name}' is in no reachable "
                    "ShardingRules table (DEFAULT_RULES + with_overrides) "
                    "— ShardingRules.spec() silently replicates unknown "
                    "names, so this dimension would never be sharded")


@project_rule("R28", "implicit-reshard")
def check_implicit_reshard(ctxs: List[FileContext],
                           engine: "LintEngine") -> Iterator[Finding]:
    """Implicit reshard across a local_map boundary: a DTensor placed
    with one layout (``distribute_tensor`` / ``DTensor.from_local`` /
    ``redistribute`` with a resolved spec or placement list) and then
    passed to a ``local_map(..., redistribute_inputs=True)`` callable
    whose in_placements pin a different one — DTensor inserts a silent
    redistribution collective on the hot path.  Both sides must be
    statically provable (same scope chain, fully-constant placements of
    one form) for the rule to fire.  The JAX rule's second arm, a wasted
    buffer donation, has no PyTorch counterpart (there is no donation).
    Justify deliberate reshards with
    '# raylint: allow(implicit-reshard) <why>'."""
    model = engine.shard_model(ctxs)
    ctx_by_rel = {c.relpath: c for c in ctxs}
    for rel in sorted(model.facts):
        fctx = ctx_by_rel.get(rel)
        for line, pos, got, want, callee in \
                model.facts[rel]["reshard_sites"]:
            if fctx is not None and fctx.allowed(line, "R28",
                                                 "implicit-reshard"):
                continue
            yield Finding(
                "R28", "implicit-reshard", rel, line,
                f"argument {pos} of '{callee}' was placed as {got} but its "
                f"in_placements expect {want}: DTensor inserts a silent "
                "redistribution collective at this boundary on every call "
                "— place the tensor with the consumer's layout (or "
                "annotate why not)")


@project_rule("R29", "comms-manifest")
def check_comms_manifest(ctxs: List[FileContext],
                         engine: "LintEngine") -> Iterator[Finding]:
    """Static collective-cost manifest: every explicit
    ray_tpu_torch.collective op (keyed by group name) and every mesh
    collective with a resolved mesh axis — ``parallel.spmd``'s
    psum/ppermute/all_to_all/all_gather over an axis, a
    ``torch.distributed`` op whose ``group=`` is ``mesh.group(<axis>)``
    (keyed axis:<name>) — is compiled into a plan with its busbw
    wire-factor formula, written via --comms-manifest and cross-checked
    at runtime by ray_tpu_torch.doctor --comms-baseline ('__manifest__'
    key), which reports ledgered ops absent from the plan as drift.  The
    rule itself flags collectives over a mesh axis that no mesh in the
    tree declares: such an op can never appear in the plan, so it would
    always report as unplanned drift.  Justify with
    '# raylint: allow(comms-manifest) <why>'."""
    model = engine.shard_model(ctxs)
    engine.comms_manifest = _sp.build_manifest(model)
    if not model.mesh_closed():
        return
    ctx_by_rel = {c.relpath: c for c in ctxs}
    for rel in sorted(model.facts):
        fctx = ctx_by_rel.get(rel)
        for line, op, axis in model.facts[rel]["mesh_op_sites"]:
            if axis == _sp.UNKNOWN or axis in model.mesh_axes:
                continue
            if fctx is not None and fctx.allowed(line, "R29",
                                                 "comms-manifest"):
                continue
            yield Finding(
                "R29", "comms-manifest", rel, line,
                f"collective '{op}' runs over mesh axis '{axis}', which "
                f"no AXIS_ORDER or DeviceMesh(...) in the tree declares "
                f"(known axes: {', '.join(sorted(model.mesh_axes))}) — "
                "the op cannot be planned in comms_manifest.json and "
                "would always surface as unplanned drift at runtime")


# --------------------------------------------------------------------------
# engine

class LintEngine:
    def __init__(self, roots: Iterable[str], baseline_path: Optional[str] = None,
                 only_rules: Optional[Set[str]] = None,
                 proto_pairs: Optional[List[Tuple[str, str, str]]] = None,
                 allow_in: Optional[List[Tuple[str, Set[str]]]] = None,
                 changed_only: Optional[Set[str]] = None,
                 cache: bool = False):
        self.roots = [os.path.abspath(r) for r in roots]
        self.baseline = self._load_baseline(baseline_path)
        self.only_rules = only_rules
        # explicit (proto_path, pb2_path, relpath) triples override R6's
        # autodiscovery — the drift tests point this at mutated fixtures
        self.proto_pairs = proto_pairs
        # scoped allow profile: (path prefix, {rule ids/tags}) pairs —
        # findings under the prefix for those rules are suppressed (the
        # gate relaxes a few rules for tests/ without allowlisting files)
        self.allow_in = allow_in or []
        # incremental mode: the whole tree is still parsed (project rules
        # need global context) but only findings in these repo-relative
        # paths are reported
        self.changed_only = changed_only
        # incremental analysis cache: valid only for full-rule runs (a
        # partial --rules run would poison the stored finding sets)
        self.cache_enabled = cache and only_rules is None
        # (file hits, files total, project-level hit) after run()
        self.cache_stats: Optional[Tuple[int, int, bool]] = None
        # (stitch-fact replay hits, files stitched) after an index build —
        # None when no project rule forced the graph
        self.stitch_stats: Optional[Tuple[int, int]] = None
        # (field-fact replay hits, files scanned) after a field-plan
        # build — None when no field rule (R23-R25) forced it
        self.field_stats: Optional[Tuple[int, int]] = None
        # wall time per project rule id (plus "graph" for the index build)
        self.rule_times: Dict[str, float] = {}
        self.errors: List[str] = []
        self._index: Optional[_cg.ProjectIndex] = None
        # hash-validated per-file stitch facts replayed from the cache
        self._stitch_cache: Dict[str, dict] = {}
        # hash-validated per-file field-safety facts (R23-R25) replayed
        # from the cache
        self._field_cache: Dict[str, dict] = {}
        # hash-validated per-file SPMD shard facts (R27-R29) replayed
        # from the cache
        self._shard_cache: Dict[str, dict] = {}
        # (shard-fact replay hits, files scanned) after a shard-model
        # build — None when no SPMD rule (R27-R29) forced it
        self.shard_stats: Optional[Tuple[int, int]] = None
        self._shard_model: Optional[_sp.ShardModel] = None
        # static collective plan (R29) — built by the R29 rule or
        # replayed from the project cache; --comms-manifest writes it
        self.comms_manifest: Optional[dict] = None

    def index(self, ctxs: List[FileContext]) -> _cg.ProjectIndex:
        """Whole-program symbol table / call graph, built once per run and
        shared by every interprocedural rule (R10-R12, R19-R20, R23-R25)."""
        if self._index is None:
            self._index = _cg.ProjectIndex(
                ctxs, stitch_facts=self._stitch_cache,
                field_facts=self._field_cache)
            self.stitch_stats = (self._index.stitch_hits,
                                 len(self._index.stitch_facts))
        return self._index

    def shard_model(self, ctxs: List[FileContext]) -> _sp.ShardModel:
        """Whole-tree SPMD sharding model, built once per run and shared
        by R27-R29, with hash-validated per-file fact replay exactly like
        the stitch/field layers."""
        if self._shard_model is None:
            self._shard_model = _sp.ShardModel(
                ctxs, cached=self._shard_cache)
            self.shard_stats = (self._shard_model.hits,
                                len(self._shard_model.facts))
        return self._shard_model

    @staticmethod
    def _load_baseline(path: Optional[str]) -> Set[Tuple[str, str]]:
        entries: Set[Tuple[str, str]] = set()
        if not path or not os.path.exists(path):
            return entries
        with open(path, encoding="utf-8") as f:
            for raw in f:
                line = raw.split("#", 1)[0].strip()
                if not line:
                    continue
                parts = line.split(None, 1)
                if len(parts) == 2:
                    entries.add((parts[0], parts[1].strip()))
        return entries

    def _want(self, rule_id: str, tag: str) -> bool:
        return not self.only_rules or \
            bool({rule_id, tag} & self.only_rules)

    def _iter_files(self) -> Iterator[Tuple[str, str]]:
        for root in self.roots:
            if os.path.isfile(root):
                yield root, os.path.basename(root)
                continue
            base = os.path.dirname(root.rstrip(os.sep))
            for dirpath, dirnames, filenames in os.walk(root):
                # devtools/fixtures holds deliberately-findings-bearing
                # corpus files for --self-check; only an explicit root
                # pointing inside it lints them
                dirnames[:] = sorted(d for d in dirnames
                                     if d not in ("__pycache__", ".git",
                                                  "fixtures"))
                in_tests = "tests" in os.path.relpath(
                    dirpath, base).split(os.sep)
                for fname in sorted(filenames):
                    # tests/ holds two packages' suites: only this
                    # package's test files are linted with it
                    if fname.endswith(".py") and (
                            not in_tests or fname.startswith(_TEST_PREFIX)):
                        full = os.path.join(dirpath, fname)
                        yield full, os.path.relpath(full, base)

    # -- incremental analysis cache ----------------------------------------
    #
    # Derived artifacts (per-file file-rule findings; whole-tree project
    # findings) are keyed on content hashes, never on mtimes.  Re-parsing
    # is CHEAPER than unpickling trees on this corpus (measured: ast.parse
    # 0.66s vs pickle.load 1.0s for 181 files), so the cache deliberately
    # stores findings, not parse trees: a warm run is hash + emit.

    _salt: Optional[str] = None

    @classmethod
    def _engine_salt(cls) -> str:
        """Content hash of the analysis code itself: any edit to the
        linter, call-graph, or dataflow layers invalidates every entry."""
        if cls._salt is None:
            from ray_tpu_torch.devtools import lockwatch as _lw
            h = hashlib.sha256(sys.version.encode())
            for mod_file in (__file__, _cg.__file__, _df.__file__,
                             _sp.__file__, _lw.__file__):
                try:
                    with open(mod_file, "rb") as f:
                        h.update(f.read())
                except OSError:
                    h.update(mod_file.encode())
            cls._salt = h.hexdigest()
        return cls._salt

    @staticmethod
    def _cache_path() -> str:
        env = os.environ.get("RAYLINT_CACHE")
        if env:
            return env
        uid = getattr(os, "getuid", lambda: 0)()
        return os.path.join(tempfile.gettempdir(),
                            f"raylint-cache-{uid}.json")

    def _cache_load(self) -> dict:
        try:
            with open(self._cache_path(), encoding="utf-8") as f:
                data = json.load(f)
        except (OSError, ValueError):
            return {}
        return data if data.get("salt") == self._engine_salt() else {}

    def _cache_store(self, data: dict) -> None:
        path = self._cache_path()
        try:
            fd, tmp = tempfile.mkstemp(
                dir=os.path.dirname(path) or ".", prefix=".raylint-cache-")
        except OSError:
            return
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(data, f)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def run(self) -> List[Finding]:
        sources: List[Tuple[str, str, str]] = []
        for path, rel in self._iter_files():
            try:
                with open(path, encoding="utf-8") as f:
                    sources.append((path, rel, f.read()))
            except (OSError, UnicodeDecodeError) as e:
                self.errors.append(f"{rel}: unreadable: {e}")
        findings = self._execute(sources)
        findings = [f for f in findings
                    if (f.rule, f.path) not in self.baseline]
        if self.allow_in:
            findings = [f for f in findings
                        if not any(
                            f.path.replace("\\", "/").startswith(prefix) and
                            ({f.rule, f.tag, "all"} & rules)
                            for prefix, rules in self.allow_in)]
        if self.changed_only is not None:
            changed = {p.replace("\\", "/") for p in self.changed_only}
            findings = [f for f in findings
                        if f.path.replace("\\", "/") in changed]
        # nested loops can both see one sleep/handler — report each site once
        findings = sorted(set(findings),
                          key=lambda f: (f.path, f.line, f.rule))
        return findings

    def _execute(self, sources: List[Tuple[str, str, str]]) -> List[Finding]:
        """Parse + run rules, consulting the incremental cache when on.
        Returns raw (pre-baseline, pre-allow-in) findings."""
        cache = self._cache_load() if self.cache_enabled else None
        hashes = {rel: hashlib.sha256(src.encode()).hexdigest()
                  for _p, rel, src in sources}
        tree_key = None
        if cache is not None:
            tree_key = hashlib.sha256(
                json.dumps(sorted(hashes.items())).encode()).hexdigest()
            proj = cache.get("project") or {}
            if proj.get("tree_key") == tree_key:
                # whole-tree hit: nothing changed since the stored run, so
                # the project-rule findings (and everything else) replay
                # without a single ast.parse
                self.cache_stats = (len(sources), len(sources), True)
                self.errors.extend(proj.get("errors") or [])
                self.comms_manifest = proj.get("manifest")
                return [Finding(**d) for d in proj.get("findings") or []]
        ctxs: List[FileContext] = []
        file_findings: List[Finding] = []
        per_file: Dict[str, List[dict]] = {}
        cached_files = (cache.get("files") if cache is not None else {}) or {}
        hits = 0
        for path, rel, src in sources:
            try:
                ctx = FileContext(path, rel, src)
            except SyntaxError as e:
                self.errors.append(f"{rel}: unparseable: {e}")
                continue
            ctxs.append(ctx)
            ent = cached_files.get(rel)
            if cache is not None and ent and ent.get("hash") == hashes[rel]:
                hits += 1
                per_file[rel] = ent.get("findings") or []
                file_findings.extend(Finding(**d) for d in per_file[rel])
                continue
            mine: List[Finding] = []
            for rule_id, tag, fn in RULES:
                if self._want(rule_id, tag):
                    mine.extend(fn(ctx))
            file_findings.extend(mine)
            per_file[rel] = [f.to_json() for f in mine]
        # replay cross-process stitch facts for unchanged files: the graph
        # is still rebuilt (ast node identity can't be cached), but the
        # per-file send/dispatcher scans — the expensive half — are not
        cached_stitch = (cache.get("stitch") if cache is not None else
                         None) or {}
        self._stitch_cache = {
            rel: ent.get("facts") or {"sends": [], "dispatchers": []}
            for rel, ent in cached_stitch.items()
            if rel in hashes and ent.get("hash") == hashes[rel]}
        # same replay for the field-safety facts (R23-R25): per-file
        # access/split/guarded records are pure functions of one file's
        # source, so a matching content hash makes them valid verbatim
        cached_fields = (cache.get("fields") if cache is not None else
                         None) or {}
        self._field_cache = {
            rel: ent["facts"]
            for rel, ent in cached_fields.items()
            if rel in hashes and ent.get("hash") == hashes[rel]
            and ent.get("facts") is not None}
        # same replay for the SPMD shard facts (R27-R29): per-file spec /
        # mesh / collective-site records are pure functions of one file's
        # source, so a matching content hash makes them valid verbatim
        cached_shard = (cache.get("shard") if cache is not None else
                        None) or {}
        self._shard_cache = {
            rel: ent["facts"]
            for rel, ent in cached_shard.items()
            if rel in hashes and ent.get("hash") == hashes[rel]
            and ent.get("facts") is not None}
        proj_findings: List[Finding] = []
        if self.only_rules is None:
            t0 = time.perf_counter()
            self.index(ctxs)
            self.rule_times["graph"] = time.perf_counter() - t0
        for rule_id, tag, fn in PROJECT_RULES:
            if self._want(rule_id, tag):
                t0 = time.perf_counter()
                proj_findings.extend(fn(ctxs, self))
                self.rule_times[rule_id] = time.perf_counter() - t0
        if self._index is not None and self._index.field_facts:
            self.field_stats = (self._index.field_hits,
                                len(self._index.field_facts))
        if cache is not None:
            self.cache_stats = (hits, len(sources), False)
            # merge, don't replace: entries for files outside this run's
            # roots (another checkout, another root set) stay valid —
            # their content hashes still guard them
            merged = dict(cached_files)
            merged.update({rel: {"hash": hashes[rel],
                                 "findings": per_file[rel]}
                           for rel in per_file})
            stitch = dict(cached_stitch)
            if self._index is not None:
                stitch.update({rel: {"hash": hashes[rel], "facts": facts}
                               for rel, facts in
                               self._index.stitch_facts.items()
                               if rel in hashes})
            fields = dict(cached_fields)
            if self._index is not None:
                fields.update({rel: {"hash": hashes[rel], "facts": facts}
                               for rel, facts in
                               self._index.field_facts.items()
                               if rel in hashes})
            shard = dict(cached_shard)
            if self._shard_model is not None:
                shard.update({rel: {"hash": hashes[rel], "facts": facts}
                              for rel, facts in
                              self._shard_model.facts.items()
                              if rel in hashes})
            self._cache_store({
                "salt": self._engine_salt(),
                "files": merged,
                "stitch": stitch,
                "fields": fields,
                "shard": shard,
                "project": {
                    "tree_key": tree_key,
                    "findings": [f.to_json()
                                 for f in file_findings + proj_findings],
                    "errors": list(self.errors),
                    "manifest": self.comms_manifest},
            })
        return file_findings + proj_findings


def rule_listing() -> List[dict]:
    """Machine-readable registry listing (``--rules`` with no value).

    ``run_static_analysis.sh`` and the docs regeneration check consume
    this, so the script header and the ARCHITECTURE.md rule table can
    never drift from the rules actually registered."""
    out = []
    for kind, reg in (("file", RULES), ("project", PROJECT_RULES)):
        for rule_id, tag, fn in reg:
            doc = " ".join((fn.__doc__ or "").strip().split())
            out.append({"id": rule_id, "tag": tag, "kind": kind,
                        "summary": doc.split(". ")[0][:240],
                        "doc": doc})
    out.sort(key=lambda r: int(r["id"][1:]))
    return out


def sarif_log(findings: List[Finding]) -> dict:
    """Findings as a SARIF 2.1.0 log object (one run, one driver).  The
    rule metadata comes straight from :func:`rule_listing`, so the SARIF
    ``rules`` array can never drift from the registry."""
    rules = [{
        "id": r["id"],
        "name": r["tag"],
        "shortDescription": {"text": r["summary"]},
        "fullDescription": {"text": r["doc"]},
        # rule table anchor in the repo docs — consumers resolve it
        # against the checkout the log was produced from
        "helpUri": f"ARCHITECTURE.md#{r['id'].lower()}-{r['tag']}",
    } for r in rule_listing()]
    index = {r["id"]: i for i, r in enumerate(rules)}
    results = [{
        "ruleId": f.rule,
        "ruleIndex": index.get(f.rule, -1),
        "level": "warning",
        "message": {"text": f.message},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {
                    "uri": f.path.replace("\\", "/"),
                    "uriBaseId": "SRCROOT"},
                "region": {"startLine": f.line},
            },
        }],
    } for f in findings]
    return {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "raylint",
                "rules": rules,
            }},
            "results": results,
        }],
    }


def _changed_files(ref: str) -> Optional[Set[str]]:
    """Repo-relative ``*.py`` paths changed vs *ref* plus untracked files,
    or None when git is unavailable (caller falls back to a full lint)."""
    import subprocess
    files: Set[str] = set()
    for cmd in (["git", "diff", "--name-only", "--diff-filter=d", ref],
                ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if proc.returncode != 0:
            return None
        files |= {line.strip() for line in proc.stdout.splitlines()
                  if line.strip().endswith(".py")}
    return files


def _run_self_check() -> int:
    """Round-trip the shipped fixture corpus against expected.json: every
    expected finding must fire at its exact line, and nothing else may."""
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
    expected_path = os.path.join(base, "expected.json")
    with open(expected_path, encoding="utf-8") as f:
        expected = json.load(f)
    engine = LintEngine([base])
    got = {(f.rule, f.path, f.line) for f in engine.run()}
    want = {(e["rule"], e["path"], e["line"]) for e in expected}
    for rule_id, path, line in sorted(want - got):
        print(f"self-check: MISSING expected finding "
              f"{rule_id} at {path}:{line}")
    for rule_id, path, line in sorted(got - want):
        print(f"self-check: UNEXPECTED finding {rule_id} at {path}:{line}")
    for err in engine.errors:
        print(f"self-check: warning: {err}")
    if got == want:
        print(f"self-check: OK ({len(want)} fixture findings round-trip)")
        return 0
    print("self-check: FAIL")
    return 1


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        prog=f"python -m {_PKG}.devtools.lint",
        description=f"framework-aware static analysis for {_PKG}")
    parser.add_argument("roots", nargs="*", default=[_PKG],
                        help="files or directories to lint")
    parser.add_argument("--json", action="store_true",
                        help="emit findings as a JSON array")
    parser.add_argument("--baseline", default=None,
                        help="allowlist file of 'RULE path' lines")
    parser.add_argument("--rules", nargs="?", const="<list>", default=None,
                        metavar="IDS",
                        help="comma-separated rule ids/tags to run "
                             "(default: all); with no value, print the "
                             "machine-readable rule listing as JSON")
    parser.add_argument("--changed", nargs="?", const="HEAD", default=None,
                        metavar="REF",
                        help="incremental mode: parse the whole tree "
                             "(project rules need it) but only report "
                             "findings in files changed vs REF "
                             "(git diff + untracked; default HEAD)")
    parser.add_argument("--allow-in", action="append", default=[],
                        metavar="PREFIX:RULES",
                        help="scoped allow profile, e.g. "
                             "'tests/:R12,bare-retry' — suppress those "
                             "rules under the path prefix (repeatable)")
    parser.add_argument("--self-check", action="store_true",
                        help="lint the shipped fixture corpus and verify "
                             "it round-trips expected.json exactly")
    parser.add_argument("--no-cache", action="store_true",
                        help="disable the content-hash incremental cache "
                             "(default location: raylint-cache-<uid>.json "
                             "in the system temp dir, override with "
                             "$RAYLINT_CACHE)")
    parser.add_argument("--sarif", default=None, metavar="OUT.json",
                        help="additionally write findings as a SARIF 2.1.0 "
                             "log to OUT.json (machine-consumable for "
                             "code-scanning UIs)")
    parser.add_argument("--comms-manifest", default=None, metavar="OUT.json",
                        help="additionally write the R29 static "
                             "collective-cost manifest (planned ops per "
                             "group / mesh axis with busbw wire factors) "
                             "to OUT.json; ray_tpu_torch.doctor --comms-baseline "
                             "cross-checks the runtime ledger against it "
                             "via the '__manifest__' baseline key")
    parser.add_argument("--write-baseline", default=None, metavar="FILE",
                        help="write current findings as a baseline and exit 0")
    args = parser.parse_args(argv)

    if args.self_check:
        return _run_self_check()
    if args.rules == "<list>":
        print(json.dumps(rule_listing(), indent=2))
        return 0

    only = {r.strip() for r in args.rules.split(",")} if args.rules else None
    allow_in = []
    for spec in args.allow_in:
        prefix, _, rules_csv = spec.partition(":")
        if not prefix or not rules_csv:
            parser.error(f"--allow-in wants PREFIX:RULES, got {spec!r}")
        allow_in.append((prefix, {r.strip() for r in rules_csv.split(",")}))
    changed_only = None
    if args.changed is not None:
        changed_only = _changed_files(args.changed)
        if changed_only is not None and not changed_only:
            # nothing changed: cheap exit, same contract as a clean lint
            print("raylint: 0 finding(s) (no changed *.py files)"
                  if not args.json else "[]")
            return 0
    engine = LintEngine(args.roots or [_PKG], args.baseline, only,
                        allow_in=allow_in, changed_only=changed_only,
                        cache=not args.no_cache)
    findings = engine.run()
    if engine.cache_stats is not None:
        hits, total, warm = engine.cache_stats
        if warm:
            stitch = "stitch replayed"
        elif engine.stitch_stats is not None:
            stitch = "stitch {}/{}".format(*engine.stitch_stats)
        else:
            stitch = "stitch skipped"
        if warm:
            fields = "fields replayed"
        elif engine.field_stats is not None:
            fields = "fields {}/{}".format(*engine.field_stats)
        else:
            fields = "fields skipped"
        if warm:
            shard = "shard replayed"
        elif engine.shard_stats is not None:
            shard = "shard {}/{}".format(*engine.shard_stats)
        else:
            shard = "shard skipped"
        print(f"raylint-cache: {hits}/{total} file hits, "
              f"project {'hit' if warm else 'miss'}, {stitch}, {fields}, "
              f"{shard}",
              file=sys.stderr)
    if engine.rule_times:
        total_t = sum(engine.rule_times.values())
        parts = " ".join(f"{k} {v:.2f}s" for k, v in
                         sorted(engine.rule_times.items(),
                                key=lambda kv: -kv[1]))
        print(f"raylint-times: total {total_t:.2f}s {parts}",
              file=sys.stderr)
        if total_t > 1.0:
            for k, v in sorted(engine.rule_times.items()):
                if k != "graph" and v > 0.3 * total_t:
                    print(f"raylint-times: WARNING {k} took "
                          f"{v:.2f}s ({v / total_t:.0%} of project-rule "
                          "time)", file=sys.stderr)

    if args.write_baseline:
        with open(args.write_baseline, "w", encoding="utf-8") as f:
            f.write("# raylint baseline — tolerated pre-existing findings\n")
            for rule_id, path in sorted({(x.rule, x.path) for x in findings}):
                f.write(f"{rule_id} {path}\n")
        print(f"wrote {args.write_baseline} "
              f"({len(findings)} findings baselined)")
        return 0

    if args.sarif:
        with open(args.sarif, "w", encoding="utf-8") as f:
            json.dump(sarif_log(findings), f, indent=2)
        print(f"raylint: sarif log written to {args.sarif}",
              file=sys.stderr)

    if args.comms_manifest:
        manifest = engine.comms_manifest or {
            "version": 1, "tool": "raylint/R29", "mesh_axes": [],
            "unresolved_sites": 0, "groups": {}}
        with open(args.comms_manifest, "w", encoding="utf-8") as f:
            json.dump(manifest, f, indent=2)
        n_groups = len(manifest.get("groups") or {})
        n_ops = sum(len(ops) for ops in (manifest.get("groups")
                                         or {}).values())
        print(f"raylint: comms manifest written to {args.comms_manifest} "
              f"({n_groups} group(s), {n_ops} planned op kind(s))",
              file=sys.stderr)

    if args.json:
        print(json.dumps([f.to_json() for f in findings], indent=2))
    else:
        for f in findings:
            print(f.format())
        counts: Dict[str, int] = {}
        for f in findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        summary = ", ".join(f"{k}: {v}" for k, v in sorted(counts.items()))
        print(f"raylint: {len(findings)} finding(s)"
              + (f" ({summary})" if summary else ""))
        for err in engine.errors:
            print(f"raylint: warning: {err}")
    return 1 if findings else 0
