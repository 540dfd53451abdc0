"""Flow- and path-sensitive dataflow facts over the callgraph ProjectIndex.

This module is the analysis layer under the R16-R18 rule families in
:mod:`ray_tpu_torch.devtools.linter`:

- **resource lifecycle** (R16): a path-sensitive abstract interpreter
  walks each function body tracking *acquire/release facts* for OS-backed
  resources (sockets, file handles, mmaps, non-daemon threads, executor
  pools).  Each explicit path to a function exit — fall-through,
  ``return``, ``raise``, or an exception edge modeled through
  ``try``/``except``/``finally`` — must end with every tracked resource
  released or its ownership transferred.
- **deadline propagation** (R17): per-function *naked-blocking facts*
  (``.wait()`` / ``.join()`` / ``.result()`` / lock ``.acquire()`` with no
  timeout) are closed over the interprocedural call graph and intersected
  with *deadline-scoped entry points* (functions carrying a
  ``deadline``/``timeout``/``budget`` parameter or arming a
  ``BackoffPolicy`` budget).
- **protocol conformance** (R18): *send facts* (``pb.<METHOD>`` handed to
  an RPC send primitive) and *handle facts* (``.method`` compared against
  ``pb.<METHOD>``, plus ``case raytpu::<METHOD>`` dispatch in the native
  state service) are cross-checked, reply discipline is verified along
  every handler path, and node-lifecycle state writes are checked against
  the declared ``NODE_LIFECYCLE`` transition table.

The fact lattice per tracked resource is the four-point powerset of
``{released, escaped}``; a resource is *live* while neither bit is set,
and only live-at-exit facts become findings.  The stance matches the
callgraph layer's under-approximation contract: anything the walker
cannot prove it understands (dynamic calls, ``yield``-suspended frames,
a name captured by a nested def, a value stored into a container or
handed to an unresolved callee) degrades to "ownership left this
function" — which can only *suppress* findings, never invent one.
Implicit mid-function exceptions are not modeled either, with two
deliberate exceptions: inside a ``try`` body an exception may strike
after any statement prefix (that is what the handler edges are for), and
inside ``__init__`` any call may abort construction (a constructor that
raises strands every resource its half-built instance owns).

Ownership transfer into pools/rings/registries is recognized
structurally (stores, container adds, resolved callees that keep their
argument) and can be asserted explicitly where the sink is dynamic::

    sock = socket.create_connection(addr)  # raylint: transfer(socket) conn thread owns it
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Resource", "ExitState", "FunctionDataflow", "resource_leaks",
    "naked_blocking", "deadline_params", "arms_backoff_budget",
    "protocol_sends", "protocol_handlers", "native_protocol_facts",
    "proto_method_names", "reply_candidates", "lifecycle_writes",
    "NODE_LIFECYCLE", "module_global_names", "guarded_decls",
    "atomic_attr_keys", "ATOMIC_TYPE_LEAVES",
]

_TRANSFER_RE = re.compile(r"#\s*raylint:\s*transfer\(([A-Za-z0-9_,\- ]+)\)")


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _resolved_dotted(node: ast.AST, ctx) -> Optional[str]:
    """Dotted name with the head segment resolved through the file's
    imports (``import socket as _socket`` makes ``_socket.socket`` read
    as ``socket.socket``; ``from concurrent.futures import
    ThreadPoolExecutor`` resolves the bare name to its origin)."""
    raw = _dotted(node)
    if not raw:
        return None
    head, _, rest = raw.partition(".")
    origin = ctx.import_origin.get(head)
    if origin:
        return origin + ("." + rest if rest else "")
    return raw


# --------------------------------------------------------------------------
# resource-lifecycle facts (R16)

# resolved constructor dotted name -> resource kind
ACQUIRE_TABLE: Dict[str, str] = {
    "socket.socket": "socket",
    "socket.create_connection": "socket",
    "socket.socketpair": "socket",
    "open": "file",
    "io.open": "file",
    "os.fdopen": "file",
    "gzip.open": "file",
    "mmap.mmap": "mmap",
    "threading.Thread": "thread",
    "concurrent.futures.ThreadPoolExecutor": "executor",
    "concurrent.futures.ProcessPoolExecutor": "executor",
    "concurrent.futures.thread.ThreadPoolExecutor": "executor",
}

# method call on the tracked name that ends its lifetime
_RELEASE_ATTRS = {"close", "shutdown", "terminate", "kill", "detach",
                  "join", "unlink"}

# calls on the tracked name that are plain uses (neither release nor
# escape); everything else on the receiver position is also a use —
# only argument positions can transfer ownership
_MAX_PATHS = 64


@dataclass
class Resource:
    """One acquire fact; ``released``/``escaped`` are the lattice bits."""
    kind: str
    var: str
    line: int
    released: bool = False
    escaped: bool = False

    def live(self) -> bool:
        return not (self.released or self.escaped)


@dataclass
class ExitState:
    kind: str                     # "return" | "fall" | "raise" | "ctor-raise"
    line: int                     # line of the exiting statement (or def)
    facts: List[Resource]
    trail: List[Tuple[int, str]]  # (line, note) branch decisions taken
    replies: int = 0              # ctx.reply/reply_error calls on this path


class _Path:
    __slots__ = ("bind", "facts", "trail", "replies")

    def __init__(self, bind=None, facts=None, trail=None, replies=0):
        self.bind: Dict[str, Resource] = bind or {}
        self.facts: List[Resource] = facts or []
        self.trail: List[Tuple[int, str]] = trail or []
        self.replies = replies

    def fork(self, note: Optional[Tuple[int, str]] = None) -> "_Path":
        remap = {id(f): Resource(f.kind, f.var, f.line, f.released,
                                 f.escaped) for f in self.facts}
        p = _Path({n: remap[id(f)] for n, f in self.bind.items()},
                  [remap[id(f)] for f in self.facts],
                  list(self.trail), self.replies)
        if note:
            p.trail.append(note)
        return p

    def signature(self) -> Tuple:
        return (tuple(sorted((f.kind, f.line, f.released, f.escaped)
                             for f in self.facts)),
                tuple(sorted((n, f.line) for n, f in self.bind.items())),
                self.replies)


class FunctionDataflow:
    """Path-sensitive walk of one function body.

    ``run()`` returns every reachable :class:`ExitState`.  The walk is
    bounded: loop bodies execute zero or one time, the live path set is
    capped at ``_MAX_PATHS`` (deterministically keeping the first states,
    so dropped paths under-report), and unrecognized constructs degrade
    to "escape everything they mention".
    """

    def __init__(self, fn_node: ast.AST, ctx, *, index=None, fninfo=None,
                 ctor_mode: bool = False, reply_recv: Optional[str] = None):
        self.fn = fn_node
        self.ctx = ctx
        self.index = index
        self.fninfo = fninfo
        self.ctor_mode = ctor_mode
        self.reply_recv = reply_recv
        self.reply_recv_escaped = False
        self.exits: List[ExitState] = []
        self.is_generator = any(
            isinstance(n, (ast.Yield, ast.YieldFrom))
            for n in self._walk_pruned(fn_node))
        self._try_depth = 0
        self._in_cleanup = 0
        self._transfers = self._transfer_lines(ctx)

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _walk_pruned(root: ast.AST) -> Iterator[ast.AST]:
        stack = list(ast.iter_child_nodes(root))
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            stack.extend(ast.iter_child_nodes(node))

    @staticmethod
    def _transfer_lines(ctx) -> Dict[int, Set[str]]:
        cached = getattr(ctx, "_raylint_transfer_lines", None)
        if cached is not None:
            return cached
        out: Dict[int, Set[str]] = {}
        for lineno, text in enumerate(ctx.source.splitlines(), start=1):
            m = _TRANSFER_RE.search(text)
            if m:
                out[lineno] = {t.strip() for t in m.group(1).split(",")}
        ctx._raylint_transfer_lines = out
        return out

    def _transferred(self, line: int, kind: str) -> bool:
        for cand in (line, line - 1):
            tags = self._transfers.get(cand)
            if tags and ({kind, "all"} & tags):
                return True
        return False

    def _acquire_kind(self, call: ast.Call) -> Optional[str]:
        name = _resolved_dotted(call.func, self.ctx)
        if name is None:
            return None
        kind = ACQUIRE_TABLE.get(name)
        if kind == "thread":
            for kw in call.keywords:
                if kw.arg == "daemon" and \
                        isinstance(kw.value, ast.Constant) and \
                        kw.value.value is True:
                    return None  # daemon threads are fire-and-forget
        if kind is None and isinstance(call.func, ast.Attribute) and \
                call.func.attr == "accept" and not call.args:
            return "socket"      # conn, addr = lsock.accept()
        return kind

    def _callee_keeps_arg(self, call: ast.Call, name: str) -> bool:
        """True unless the resolved project callee only *borrows* the
        parameter the tracked name is bound to (no store/return/forward,
        no release).  Unresolvable callees keep their arguments — the
        under-approximation direction."""
        if self.index is None or self.fninfo is None:
            return True
        site = self.fninfo.site_by_node.get(id(call))
        if site is None or site.target not in self.index.functions:
            return True
        target = self.index.functions[site.target]
        params = _param_names(target.node)
        # map the argument position/keyword onto the callee parameter
        bound: Optional[str] = None
        offset = 1 if target.cls and params and params[0] in (
            "self", "cls") else 0
        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Name) and arg.id == name:
                if i + offset < len(params):
                    bound = params[i + offset]
                break
        for kw in call.keywords:
            if isinstance(kw.value, ast.Name) and kw.value.id == name:
                bound = kw.arg
                break
        if bound is None:
            return True           # *args / nested position: assume kept
        verdict = _param_summary(target).get(bound, "owns")
        return verdict != "borrows"

    # -- expression scanning ----------------------------------------------

    def _scan_expr(self, node: Optional[ast.AST], path: _Path,
                   escape: bool = False) -> None:
        """Process one expression: count replies, apply releases, and
        escape any tracked name in an ownership-transferring position.
        ``escape=True`` force-escapes every tracked name mentioned
        (return/raise/yield values)."""
        if node is None:
            return
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                # capture by a nested scope: ownership leaves this walk
                for inner in ast.walk(sub):
                    if isinstance(inner, ast.Name) and \
                            inner.id in path.bind:
                        path.bind[inner.id].escaped = True
                    if isinstance(inner, ast.Name) and \
                            inner.id == self.reply_recv:
                        self.reply_recv_escaped = True
                continue
            if isinstance(sub, ast.Call):
                self._scan_call(sub, path)
            elif isinstance(sub, (ast.Tuple, ast.List, ast.Set, ast.Dict,
                                  ast.Starred, ast.Await, ast.Yield,
                                  ast.YieldFrom)):
                for name in ast.walk(sub):
                    if isinstance(name, ast.Name) and name.id in path.bind:
                        path.bind[name.id].escaped = True
        if escape:
            for name in ast.walk(node):
                if isinstance(name, ast.Name) and name.id in path.bind:
                    path.bind[name.id].escaped = True

    def _scan_call(self, call: ast.Call, path: _Path) -> None:
        func = call.func
        if isinstance(func, ast.Attribute):
            recv = _dotted(func.value)
            if recv is not None and recv in path.bind and \
                    func.attr in _RELEASE_ATTRS:
                path.bind[recv].released = True
            if self.ctor_mode and recv is not None and \
                    func.attr in _RELEASE_ATTRS:
                fact = path.bind.get(recv)
                if fact is not None:
                    fact.released = True
            if self.reply_recv is not None and \
                    isinstance(func.value, ast.Name) and \
                    func.value.id == self.reply_recv and \
                    func.attr in ("reply", "reply_error"):
                path.replies += 1
        # contextlib.closing(v) and friends adopt the resource
        dotted = _resolved_dotted(func, self.ctx) or ""
        adopting = dotted.endswith(("closing", "ExitStack.enter_context"))
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            if isinstance(arg, ast.Name) and arg.id in path.bind:
                if adopting:
                    path.bind[arg.id].released = True
                elif self._callee_keeps_arg(call, arg.id):
                    path.bind[arg.id].escaped = True
            if self.reply_recv is not None and \
                    isinstance(arg, ast.Name) and \
                    arg.id == self.reply_recv:
                self.reply_recv_escaped = True

    # -- statement walking -------------------------------------------------

    def run(self) -> List[ExitState]:
        body = getattr(self.fn, "body", [])
        outcomes = self._exec_block(body, _Path())
        last = getattr(body[-1], "end_lineno", body[-1].lineno) if body \
            else self.fn.lineno
        for st, ex in outcomes:
            if ex is None:
                if self.ctor_mode:
                    # falling off the end of __init__ is a successful
                    # construction: self.* resources now belong to the
                    # instance the caller receives
                    for name, fact in st.bind.items():
                        if name.startswith("self."):
                            fact.escaped = True
                self._record(st, "fall", last)
            elif ex[0] in ("return", "raise", "ctor-raise"):
                self._record(st, ex[0], ex[1])
            else:                 # stray break/continue: treat as fall
                self._record(st, "fall", ex[1])
        return self.exits

    def _record(self, st: _Path, kind: str, line: int) -> None:
        self.exits.append(ExitState(kind, line, list(st.facts),
                                    list(st.trail), st.replies))

    def _dedup(self, paths: List[_Path]) -> List[_Path]:
        seen: Set[Tuple] = set()
        out: List[_Path] = []
        for p in paths:
            sig = p.signature()
            if sig not in seen:
                seen.add(sig)
                out.append(p)
            if len(out) >= _MAX_PATHS:
                break
        return out

    def _exec_block(self, stmts: Sequence[ast.stmt], state: _Path,
                    ) -> List[Tuple[_Path, Optional[Tuple[str, int]]]]:
        outcomes, _ = self._exec_block_prefixes(stmts, [state])
        return outcomes

    def _exec_block_prefixes(self, stmts: Sequence[ast.stmt],
                             pending: List[_Path]):
        """Run *stmts* over the pending path set.  Returns ``(outcomes,
        prefixes)`` where outcomes are ``(path, exit)`` pairs (exit is
        ``None`` for fall-through) and prefixes snapshots the live path
        set before each statement — the states an exception edge out of a
        ``try`` body can observe.  The state after the *last* statement
        is deliberately not a prefix: a body that ran to completion did
        not raise."""
        outcomes: List[Tuple[_Path, Optional[Tuple[str, int]]]] = []
        prefixes: List[_Path] = []
        for stmt in stmts:
            # "state before stmt" is the state an exception raised *by*
            # stmt exposes — except when stmt is a Try (its own raise
            # outcomes carry the exact post-finally state) or a pure
            # release call (a close() that raises still released the fd)
            if not isinstance(stmt, ast.Try) and \
                    not self._is_release_stmt(stmt):
                prefixes.extend(p.fork() for p in pending)
            nxt: List[_Path] = []
            for st in pending:
                if self.ctor_mode and self._try_depth == 0 and \
                        self._in_cleanup == 0 and \
                        not isinstance(stmt, (ast.Try, ast.Return,
                                              ast.Raise)) and \
                        not self._is_release_stmt(stmt) and \
                        any(isinstance(n, ast.Call)
                            for n in ast.walk(stmt)) and \
                        any(f.live() for f in st.facts):
                    # constructor exception-safety: this call aborting
                    # __init__ strands everything the instance owns
                    outcomes.append((
                        st.fork((stmt.lineno, "raises")),
                        ("ctor-raise", stmt.lineno)))
                for st2, ex in self._exec_stmt(stmt, st):
                    if ex is None:
                        nxt.append(st2)
                    else:
                        outcomes.append((st2, ex))
            pending = self._dedup(nxt)
            if not pending:
                break
        outcomes.extend((st, None) for st in pending)
        return outcomes, self._dedup(prefixes)

    @staticmethod
    def _is_release_stmt(stmt: ast.stmt) -> bool:
        """A bare ``x.close()`` / ``pool.shutdown()`` statement.  Even
        when such a call raises, the underlying handle is released, so
        the state *before* it is not a real exception edge."""
        return (isinstance(stmt, ast.Expr)
                and isinstance(stmt.value, ast.Call)
                and isinstance(stmt.value.func, ast.Attribute)
                and stmt.value.func.attr in _RELEASE_ATTRS)

    def _known_branch(self, test: ast.expr, st: _Path) -> Optional[bool]:
        """Statically decide ``if`` tests over bound resources.  A name
        bound to a live fact came from a successful acquire, so it is
        neither ``None`` nor falsy on this path.  Returns True (then
        branch only), False (else only), or None (unknown)."""
        def bound(node: ast.AST) -> bool:
            name = node.id if isinstance(node, ast.Name) else _dotted(node)
            return bool(name) and name in st.bind
        if bound(test):
            return True
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not) \
                and bound(test.operand):
            return False
        if isinstance(test, ast.Compare) and len(test.ops) == 1 and \
                bound(test.left) and \
                isinstance(test.comparators[0], ast.Constant) and \
                test.comparators[0].value is None:
            if isinstance(test.ops[0], ast.Is):
                return False
            if isinstance(test.ops[0], ast.IsNot):
                return True
        return None

    def _bind_acquire(self, target: ast.AST, call: ast.Call, kind: str,
                      st: _Path, fact: Optional[Resource] = None) -> Resource:
        if fact is None:
            fact = Resource(kind, "", call.lineno)
            if self._transferred(call.lineno, kind):
                fact.escaped = True
            st.facts.append(fact)
        if isinstance(target, ast.Name):
            fact.var = target.id
            st.bind[target.id] = fact
        elif isinstance(target, ast.Tuple) and target.elts and \
                isinstance(target.elts[0], ast.Name):
            # conn, addr = lsock.accept() / a, b = socketpair()
            fact.var = target.elts[0].id
            st.bind[target.elts[0].id] = fact
        elif self.ctor_mode and isinstance(target, ast.Attribute) and \
                isinstance(target.value, ast.Name) and \
                target.value.id == "self":
            # self.x = acquire(): owned by the half-built instance
            fact.var = _dotted(target) or "self.?"
            st.bind[fact.var] = fact
        else:
            fact.escaped = True   # stored somewhere we do not model
        return fact

    def _exec_stmt(self, stmt: ast.stmt, st: _Path,
                   ) -> List[Tuple[_Path, Optional[Tuple[str, int]]]]:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            self._scan_expr(stmt, st)   # capture check only
            return [(st, None)]
        if isinstance(stmt, ast.Return):
            self._scan_expr(stmt.value, st, escape=True)
            if self.ctor_mode:
                # returning from __init__ hands the instance (and its
                # self.* resources) back to the caller
                for name, fact in st.bind.items():
                    if name.startswith("self."):
                        fact.escaped = True
            return [(st, ("return", stmt.lineno))]
        if isinstance(stmt, ast.Raise):
            self._scan_expr(stmt.exc, st, escape=True)
            if stmt.cause is not None:
                self._scan_expr(stmt.cause, st, escape=True)
            return [(st, ("raise", stmt.lineno))]
        if isinstance(stmt, (ast.Break, ast.Continue)):
            return [(st, ("loop", stmt.lineno))]
        if isinstance(stmt, (ast.Pass, ast.Import, ast.ImportFrom,
                             ast.Global, ast.Nonlocal)):
            return [(st, None)]
        if isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    st.bind.pop(t.id, None)
            return [(st, None)]
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) else \
                [stmt.target]
            value = stmt.value
            if isinstance(value, ast.Call):
                kind = self._acquire_kind(value)
                if kind is not None:
                    # arguments of the acquire call itself may carry facts
                    self._scan_call(value, st)
                    fact = None
                    for t in targets:
                        fact = self._bind_acquire(t, value, kind, st, fact)
                    return [(st, None)]
            if isinstance(value, ast.Name) and value.id in st.bind:
                fact = st.bind[value.id]
                for t in targets:
                    if isinstance(t, ast.Name):
                        st.bind[t.id] = fact       # alias
                    else:
                        fact.escaped = True        # stored
                return [(st, None)]
            self._scan_expr(value, st)
            for t in targets:
                if not isinstance(t, ast.Name):
                    # a store target mentioning a tracked name escapes it
                    self._scan_expr(t, st, escape=True)
                elif t.id in st.bind:
                    st.bind.pop(t.id)              # rebound: drop binding
            return [(st, None)]
        if isinstance(stmt, ast.AugAssign):
            self._scan_expr(stmt.value, st)
            return [(st, None)]
        if isinstance(stmt, (ast.Expr, ast.Assert)):
            self._scan_expr(stmt.value if isinstance(stmt, ast.Expr)
                            else stmt.test, st)
            return [(st, None)]
        if isinstance(stmt, ast.If):
            self._scan_expr(stmt.test, st)
            branch = self._known_branch(stmt.test, st)
            out = []
            if branch is not False:
                then = st.fork((stmt.lineno, "then"))
                out.extend(self._exec_block(stmt.body, then))
            if branch is not True:
                other = st.fork((stmt.lineno, "else"))
                if stmt.orelse:
                    out.extend(self._exec_block(stmt.orelse, other))
                else:
                    out.append((other, None))
            return out
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            if isinstance(stmt, ast.While):
                self._scan_expr(stmt.test, st)
            else:
                self._scan_expr(stmt.iter, st)
                for name in ast.walk(stmt.target):
                    if isinstance(name, ast.Name):
                        st.bind.pop(name.id, None)
            out = []
            once = st.fork((stmt.lineno, "loop"))
            for st2, ex in self._exec_block(stmt.body, once):
                if ex is None or ex[0] == "loop":
                    out.append((st2, None))        # rejoin after the loop
                else:
                    out.append((st2, ex))
            skip = st.fork((stmt.lineno, "loop-skip"))
            if stmt.orelse:
                out.extend(self._exec_block(stmt.orelse, skip))
            else:
                out.append((skip, None))
            return out
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                ce = item.context_expr
                if isinstance(ce, ast.Call):
                    kind = self._acquire_kind(ce)
                    if kind is not None:
                        self._scan_call(ce, st)
                        # `with acquire() as v`: closed on every exit
                        fact = Resource(kind, "", ce.lineno, released=True)
                        st.facts.append(fact)
                        if isinstance(item.optional_vars, ast.Name):
                            fact.var = item.optional_vars.id
                            st.bind[item.optional_vars.id] = fact
                        continue
                    self._scan_expr(ce, st)
                elif isinstance(ce, ast.Name) and ce.id in st.bind:
                    st.bind[ce.id].released = True  # `with v:` closes v
                else:
                    self._scan_expr(ce, st)
            return self._exec_block(stmt.body, st)
        if isinstance(stmt, ast.Try):
            return self._exec_try(stmt, st)
        if isinstance(stmt, ast.Match):
            # match/case: treat every case arm as a branch
            self._scan_expr(stmt.subject, st)
            out = []
            for case in stmt.cases:
                arm = st.fork((case.pattern.lineno, "case"))
                out.extend(self._exec_block(case.body, arm))
            out.append((st.fork((stmt.lineno, "case-none")), None))
            return out
        # anything unmodeled: escape every tracked name it mentions
        self._scan_expr(stmt, st, escape=True)
        return [(st, None)]

    def _exec_try(self, stmt: ast.Try, st: _Path):
        self._try_depth += 1
        body_out, prefixes = self._exec_block_prefixes(stmt.body, [st])
        self._try_depth -= 1
        out: List[Tuple[_Path, Optional[Tuple[str, int]]]] = []
        normal = [o for o, ex in body_out if ex is None]
        raised = [(o, ex) for o, ex in body_out
                  if ex is not None and ex[0] == "raise"]
        other_exits = [(o, ex) for o, ex in body_out
                       if ex is not None and ex[0] != "raise"]
        # exception states: after any prefix of the body, or an explicit
        # raise inside it
        exc_states = self._dedup(prefixes + [o for o, _ in raised])
        if stmt.handlers:
            # handler bodies are already on the failure path: the ctor
            # abort model does not second-guess cleanup code raising
            self._in_cleanup += 1
            for handler in stmt.handlers:
                for es in exc_states:
                    hs = es.fork((handler.lineno, "except"))
                    if handler.name:
                        hs.bind.pop(handler.name, None)
                    out.extend(self._exec_block(handler.body, hs))
            self._in_cleanup -= 1
        else:
            out.extend((o.fork((stmt.lineno, "error")), ("raise", ex[1]))
                       for o, ex in raised)
            if stmt.finalbody:
                # try/finally with no handler: the finally also runs on
                # the unwind of an exception thrown mid-body
                out.extend((es.fork((stmt.lineno, "error")),
                            ("raise", stmt.lineno)) for es in exc_states)
        if stmt.orelse:
            done, _ = self._exec_block_prefixes(stmt.orelse, normal)
            out.extend(done)
        else:
            out.extend((o, None) for o in normal)
        out.extend(other_exits)
        if not stmt.finalbody:
            return out
        final: List[Tuple[_Path, Optional[Tuple[str, int]]]] = []
        self._in_cleanup += 1
        for o, ex in self._dedup_outcomes(out):
            for fo, fex in self._exec_block(stmt.finalbody, o):
                final.append((fo, fex if fex is not None else ex))
        self._in_cleanup -= 1
        return final

    def _dedup_outcomes(self, outcomes):
        seen: Set[Tuple] = set()
        out = []
        for o, ex in outcomes:
            sig = (o.signature(), ex)
            if sig not in seen:
                seen.add(sig)
                out.append((o, ex))
            if len(out) >= _MAX_PATHS:
                break
        return out


def _param_names(fn_node: ast.AST) -> List[str]:
    a = fn_node.args
    return [x.arg for x in
            list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)]


_summary_cache: Dict[int, Dict[str, str]] = {}


def _param_summary(fninfo) -> Dict[str, str]:
    """Per-parameter ownership verdict for a resolved callee:
    ``"borrows"`` (the function only reads/uses it), ``"releases"``
    (calls a release method on it), or ``"owns"`` (stores, returns,
    forwards, or captures it — ownership transfers in).  One level deep
    and deliberately conservative: anything unclear is ``"owns"``."""
    cached = _summary_cache.get(id(fninfo))
    if cached is not None:
        return cached
    verdict: Dict[str, str] = {p: "borrows" for p in _param_names(fninfo.node)}

    def mark(name: str, v: str) -> None:
        if name in verdict and verdict[name] != "owns":
            verdict[name] = v

    for node in FunctionDataflow._walk_pruned(fninfo.node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            for inner in ast.walk(node):
                if isinstance(inner, ast.Name):
                    mark(inner.id, "owns")
        elif isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute) and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.attr in _RELEASE_ATTRS:
                mark(node.func.value.id, "releases")
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Name):
                    mark(arg.id, "owns")
        elif isinstance(node, (ast.Return, ast.Raise)):
            for inner in ast.walk(node):
                if isinstance(inner, ast.Name):
                    mark(inner.id, "owns")
        elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = getattr(node, "value", None)
            targets = node.targets if isinstance(node, ast.Assign) else \
                [node.target]
            if isinstance(value, ast.Name):
                if not all(isinstance(t, ast.Name) for t in targets):
                    mark(value.id, "owns")
                else:
                    for t in targets:
                        mark(value.id, "owns")  # aliased: lose track
            for t in targets:
                if not isinstance(t, ast.Name):
                    for inner in ast.walk(t):
                        if isinstance(inner, ast.Name):
                            mark(inner.id, "owns")
        elif isinstance(node, (ast.Tuple, ast.List, ast.Set, ast.Dict,
                               ast.Yield, ast.YieldFrom)):
            for inner in ast.walk(node):
                if isinstance(inner, ast.Name):
                    mark(inner.id, "owns")
    _summary_cache[id(fninfo)] = verdict
    return verdict


def resource_leaks(fninfo, index) -> List[Tuple[Resource, ExitState]]:
    """Leak candidates for one function: for each acquire fact, the first
    exit state that reaches a function exit with the fact still live.
    Generators and async functions are skipped (their frames suspend with
    resources legitimately live)."""
    node = fninfo.node
    if isinstance(node, ast.AsyncFunctionDef):
        return []
    flow = FunctionDataflow(node, fninfo.ctx, index=index, fninfo=fninfo,
                            ctor_mode=(fninfo.name == "__init__"))
    if flow.is_generator:
        return []
    leaks: List[Tuple[Resource, ExitState]] = []
    seen: Set[Tuple[str, int]] = set()
    for exit_state in flow.run():
        for fact in exit_state.facts:
            if fact.live() and (fact.kind, fact.line) not in seen:
                seen.add((fact.kind, fact.line))
                leaks.append((fact, exit_state))
    return leaks


# --------------------------------------------------------------------------
# deadline-propagation facts (R17)

_DEADLINEISH = re.compile(r"deadline|budget|timeout", re.IGNORECASE)
_QUEUEISH = re.compile(r"(^|[._])(q|queue|inbox)", re.IGNORECASE)
_LOCKISH = re.compile(r"(^|[._])(lock|mutex|cv|cond|sem)", re.IGNORECASE)


def deadline_params(fn_node: ast.AST) -> List[str]:
    """Parameters that carry a time budget the function must honor."""
    return [p for p in _param_names(fn_node)
            if _DEADLINEISH.search(p) and p not in ("self", "cls")]


def arms_backoff_budget(fn_node: ast.AST) -> Optional[int]:
    """Line of a ``BackoffPolicy(deadline_s=...)`` construction with a
    non-zero budget, else None — arming a retry deadline makes the
    function a deadline scope even without a deadline parameter."""
    for node in FunctionDataflow._walk_pruned(fn_node):
        if isinstance(node, ast.Call):
            name = _dotted(node.func) or ""
            if name.split(".")[-1] == "BackoffPolicy":
                for kw in node.keywords:
                    if kw.arg == "deadline_s" and not (
                            isinstance(kw.value, ast.Constant) and
                            kw.value.value in (0, None)):
                        return node.lineno
    return None


def _has_kwarg(call: ast.Call, *names: str) -> bool:
    return any(kw.arg in names for kw in call.keywords)


def naked_blocking(fn_node: ast.AST, ctx) -> List[Tuple[int, str]]:
    """(line, description) of unbounded blocking primitives written
    directly in this function: ``.wait()`` / zero-arg ``.join()`` /
    ``.result()`` without a timeout, zero-arg lock ``.acquire()``,
    zero-arg queue ``.get()``, and ``concurrent.futures.wait`` without a
    ``timeout=``.  ``time.sleep`` is bounded by construction and stays
    out of this set (R7/R10 cover its pathologies)."""
    out: List[Tuple[int, str]] = []
    for node in FunctionDataflow._walk_pruned(fn_node):
        if not isinstance(node, ast.Call) or \
                not isinstance(node.func, ast.Attribute):
            continue
        attr = node.func.attr
        recv = _dotted(node.func.value) or ""
        resolved = _resolved_dotted(node.func, ctx) or ""
        if attr == "wait":
            if resolved in ("concurrent.futures.wait", "futures.wait"):
                if not _has_kwarg(node, "timeout"):
                    out.append((node.lineno,
                                "concurrent.futures.wait() without timeout"))
            elif not node.args and not _has_kwarg(node, "timeout"):
                out.append((node.lineno, f"{recv}.wait() without timeout"))
        elif attr == "join" and not node.args and not node.keywords:
            out.append((node.lineno, f"{recv}.join() without timeout"))
        elif attr == "result" and not node.args and \
                not _has_kwarg(node, "timeout"):
            out.append((node.lineno, f"{recv}.result() without timeout"))
        elif attr == "acquire" and not node.args and not node.keywords \
                and _LOCKISH.search(recv):
            out.append((node.lineno, f"{recv}.acquire() without timeout"))
        elif attr == "get" and not node.args and not node.keywords and \
                _QUEUEISH.search(recv):
            out.append((node.lineno, f"{recv}.get() without timeout"))
    return out


# --------------------------------------------------------------------------
# protocol-conformance facts (R18)

# attribute names that hand a pb.<METHOD> to the wire
# helper primitives that forward a protocol constant onto the wire keep
# to a naming convention ("..._call", "send_...", "..._push"): a repo-local
# contract the scanner leans on instead of resolving dynamic dispatch
_SENDISH_RE = re.compile(r"(^|_)(call|send|push|enqueue)(_|$|\b)")

SEND_ATTRS = {"call", "call_async", "call_burst", "send_oneway", "_call",
              "push", "child", "enqueue"}


def _pb_method(node: ast.AST, ctx) -> Optional[str]:
    """``pb.PUSH_TASK``-style protocol constant, resolved through import
    aliases; None for anything else."""
    if not isinstance(node, ast.Attribute) or not node.attr.isupper():
        return None
    prefix = _dotted(node.value)
    if prefix is None:
        return None
    head = prefix.split(".")[0]
    origin = ctx.import_origin.get(head, prefix)
    if prefix == "pb" or prefix.endswith(".pb") or \
            origin.endswith((".pb", "_pb2")) or \
            "protocol" in origin:
        return node.attr
    return None


def protocol_sends(ctxs) -> List[Tuple[str, object, int]]:
    """(method, ctx, line) for every protocol constant handed to a send
    primitive (``client.call(pb.M, ...)``, ``ctx.push(pb.M, ...)``,
    batcher ``enqueue``, ...) or baked into an ``Envelope(method=pb.M)``
    construction."""
    out: List[Tuple[str, object, int]] = []
    for ctx in ctxs:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func) or ""
            leaf = dotted.split(".")[-1]
            is_send = (isinstance(node.func, ast.Attribute)
                       and node.func.attr in SEND_ATTRS) or \
                bool(_SENDISH_RE.search(leaf))
            is_envelope = leaf == "Envelope"
            # a pb constant bound to a kwarg literally named ``method`` is
            # a send regardless of the helper's name: the helper forwards
            # it into an Envelope (``_push_task_remote(..., method=pb.X)``)
            has_method_kw = any(kw.arg == "method" for kw in node.keywords)
            if not (is_send or is_envelope or has_method_kw):
                continue
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                for sub in ast.walk(arg):
                    m = _pb_method(sub, ctx)
                    if m is not None:
                        out.append((m, ctx, sub.lineno))
    return out


def protocol_handlers(ctxs) -> List[Tuple[str, object, int]]:
    """(method, ctx, line) for every dispatch-side comparison of a
    ``.method`` field against a protocol constant (``if method ==
    pb.PING``, ``env.method != pb.AUTH``, ``method in (pb.A, pb.B)``),
    and for every key of a dispatch table: a dict literal whose keys are
    all protocol constants and whose values are handlers
    (``{pb.PING: self._ping, ...}``, the Python state service's form)."""
    out: List[Tuple[str, object, int]] = []
    for ctx in ctxs:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Dict):
                out.extend(_dispatch_table_arms(node, ctx))
                continue
            if not isinstance(node, ast.Compare):
                continue
            sides = [node.left] + list(node.comparators)
            names = [(_dotted(s) or "") for s in sides]
            if not any("method" in n.lower() for n in names):
                continue
            for side in sides:
                for sub in ast.walk(side):
                    m = _pb_method(sub, ctx)
                    if m is not None:
                        out.append((m, ctx, sub.lineno))
    return out


def _dispatch_table_arms(node: ast.Dict, ctx) -> List[Tuple[str, object,
                                                               int]]:
    """The arms of a ``{pb.M: handler, ...}`` dispatch table; nothing
    unless every key is a protocol constant and every value a callable
    reference (a name, an attribute or a lambda)."""
    arms: List[Tuple[str, object, int]] = []
    for k, v in zip(node.keys, node.values):
        m = _pb_method(k, ctx) if k is not None else None
        if m is None or not isinstance(v, (ast.Name, ast.Attribute,
                                           ast.Lambda)):
            return []
        arms.append((m, ctx, k.lineno))
    return arms


_NATIVE_CASE_RE = re.compile(r"case\s+raytpu::([A-Z][A-Z0-9_]*)\s*:")
_NATIVE_CMP_RE = re.compile(r"method\(\)\s*[!=]=\s*raytpu::([A-Z][A-Z0-9_]*)")
_NATIVE_SEND_RE = re.compile(r"set_method\(\s*raytpu::([A-Z][A-Z0-9_]*)")


def native_protocol_facts(native_dir: str) -> Tuple[Set[str], Set[str]]:
    """(handled, sent) method names extracted from the C++ state service
    (``case raytpu::M:`` dispatch arms, ``env.method() == raytpu::M``
    guards, ``set_method(raytpu::M)`` pushes).  Missing sources degrade
    to empty sets — the python-side cross-check then stands alone."""
    handled: Set[str] = set()
    sent: Set[str] = set()
    if not os.path.isdir(native_dir):
        return handled, sent
    for fname in sorted(os.listdir(native_dir)):
        if not fname.endswith((".cc", ".h")):
            continue
        try:
            with open(os.path.join(native_dir, fname),
                      encoding="utf-8") as f:
                text = f.read()
        except OSError:
            continue
        handled.update(_NATIVE_CASE_RE.findall(text))
        handled.update(_NATIVE_CMP_RE.findall(text))
        sent.update(_NATIVE_SEND_RE.findall(text))
    return handled, sent


_PROTO_ENUM_RE = re.compile(
    r"enum\s+Method\s*\{(.*?)\}", re.DOTALL)
_PROTO_VALUE_RE = re.compile(r"([A-Z][A-Z0-9_]*)\s*=\s*(\d+)\s*;")


def proto_method_names(proto_path: str) -> Set[str]:
    """Names of the ``Method`` enum in raytpu.proto (empty when the proto
    is not under the lint roots, e.g. in the fixture corpus)."""
    try:
        with open(proto_path, encoding="utf-8") as f:
            text = f.read()
    except OSError:
        return set()
    m = _PROTO_ENUM_RE.search(text)
    if not m:
        return set()
    return {name for name, _num in _PROTO_VALUE_RE.findall(m.group(1))}


def reply_candidates(fninfo) -> Optional[str]:
    """The RpcContext-style parameter of a handler function, when the
    function replies through it directly (``ctx.reply(...)`` /
    ``ctx.reply_error(...)``); None when the function is not a reply
    site."""
    params = _param_names(fninfo.node)
    candidates = [p for p in params if p == "ctx" or p.endswith("_ctx")]
    for node in FunctionDataflow._walk_pruned(fninfo.node):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("reply", "reply_error") and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id in candidates:
            return node.func.value.id
    return None


# --------------------------------------------------------------------------
# node-lifecycle state machine (R18, PR 8 correlation)

# The declared machine: NodeInfo.state "" (legacy ALIVE) -> DRAINING ->
# DRAINED, any live state may die.  This table is the static contract the
# extracted transitions are checked against; ARCHITECTURE.md documents it
# next to the PR 8 drain orchestrator.
NODE_LIFECYCLE = {
    "states": ("", "ALIVE", "DRAINING", "DRAINED", "DEAD"),
    "transitions": frozenset({
        ("", "DRAINING"), ("ALIVE", "DRAINING"),
        ("DRAINING", "DRAINED"),
        ("", "DEAD"), ("ALIVE", "DEAD"),
        ("DRAINING", "DEAD"), ("DRAINED", "DEAD"),
    }),
}

_LIFECYCLE_VOCAB = {"ALIVE", "DRAINING", "DRAINED", "DEAD"}


def lifecycle_writes(ctxs) -> List[Tuple[object, int, str, Set[str], str,
                                         Optional[int]]]:
    """Statically extracted node-lifecycle transitions: every
    ``<recv>.state = "<STATE>"`` write whose value is in the lifecycle
    vocabulary, as ``(ctx, line, recv, from_states, to_state,
    guard_line)``.  ``from_states`` is the set the innermost dominating
    ``<recv>.state == "X"`` guard admits, or ``{"*"}`` when the write is
    unguarded (legal iff the target state is reachable at all)."""
    out = []

    def visit(node, ctx, guards):
        if isinstance(node, ast.If):
            cond_guards = list(guards)
            g = _state_guard(node.test)
            if g is not None:
                cond_guards = cond_guards + [(g[0], g[1], node.lineno)]
            for child in node.body:
                visit(child, ctx, cond_guards)
            for child in node.orelse:
                visit(child, ctx, guards)   # else: the guard is unknown
            return
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Attribute) and t.attr == "state" and \
                        isinstance(node.value, ast.Constant) and \
                        node.value.value in _LIFECYCLE_VOCAB:
                    recv = _dotted(t.value) or "?"
                    froms, guard_line = {"*"}, None
                    for grecv, gstates, gline in reversed(guards):
                        if grecv == recv:
                            froms, guard_line = gstates, gline
                            break
                    out.append((ctx, t.lineno, recv, froms,
                                node.value.value, guard_line))
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, ctx, [])   # a def's body runs elsewhere:
            elif not isinstance(child, ast.Lambda):  # guards don't dominate
                visit(child, ctx, guards)

    def _state_guard(test):
        """(recv, {states}) for `<recv>.state == "X"` / `in (..)`."""
        if not isinstance(test, ast.Compare) or len(test.ops) != 1 or \
                not isinstance(test.ops[0], (ast.Eq, ast.In)):
            return None
        left, right = test.left, test.comparators[0]
        if not (isinstance(left, ast.Attribute) and left.attr == "state"):
            return None
        recv = _dotted(left.value)
        if recv is None:
            return None
        if isinstance(test.ops[0], ast.Eq) and \
                isinstance(right, ast.Constant) and \
                isinstance(right.value, str):
            return recv, {right.value}
        if isinstance(test.ops[0], ast.In) and \
                isinstance(right, (ast.Tuple, ast.List, ast.Set)):
            vals = {e.value for e in right.elts
                    if isinstance(e, ast.Constant) and
                    isinstance(e.value, str)}
            if vals:
                return recv, vals
        return None

    for ctx in ctxs:
        for child in ast.iter_child_nodes(ctx.tree):
            visit(child, ctx, [])
    return out


# --------------------------------------------------------------------------
# field-level thread-safety facts (R23-R25)
#
# Per-function shared-attribute access records, in-function atomicity-split
# candidates, `# raylint: guarded-by(...)` declarations, and the per-module
# tracked-global/atomic-attribute sets.  Every output here is JSON-able and
# a pure function of ONE file's source, so the linter caches it under the
# file's content hash exactly like the stitch facts; the callgraph layer
# (ProjectIndex.field_plan) joins the records with thread contexts and
# interprocedural must-hold locksets.
#
# Under-approximation stance, same polarity as the rest of this module: a
# construct the scanner does not understand contributes no access record,
# so the field rules can miss a race through dynamic attribute names or
# getattr() but never report a site that does not textually exist.

_GUARDED_RE = re.compile(r"#\s*raylint:\s*guarded-by\(([^)]+)\)")

#: method names that mutate their receiver in place — a call through a
#: shared attribute with one of these is a write for race purposes
_MUTATOR_ATTRS = frozenset({
    "append", "extend", "insert", "pop", "popitem", "remove", "discard",
    "add", "clear", "update", "setdefault", "sort", "reverse",
    "appendleft", "popleft", "rotate", "put", "put_nowait",
})

#: constructor leaf names whose instances are internally synchronized (or
#: atomic by construction, like itertools.count under the GIL); attributes
#: assigned from them are exempt from the field rules — calling their
#: methods IS the synchronization
ATOMIC_TYPE_LEAVES = frozenset({
    "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue", "deque",
    "Event", "Condition", "Semaphore", "BoundedSemaphore", "Barrier",
    "local", "Lock", "RLock", "count", "Thread", "Timer",
    "ThreadPoolExecutor", "ProcessPoolExecutor",
})

#: attributes/globals the field analysis never tracks: dunders and the
#: locks themselves (lock objects are the synchronization, not the state)
_FIELD_SKIP_RE = re.compile(
    r"(^__)|((^|[._])(lock|mutex|cv|cond|sem))", re.IGNORECASE)


def module_global_names(tree: ast.AST) -> Set[str]:
    """Module globals the field analysis tracks: names assigned at module
    top level plus every name in an ``ast.Global`` statement (container
    globals are mutated without ``global``, so top-level binding is the
    signal that matters)."""
    out: Set[str] = set()
    for stmt in tree.body:
        targets: List[ast.AST] = []
        if isinstance(stmt, ast.Assign):
            targets = list(stmt.targets)
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            targets = [stmt.target]
        for t in targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    out.add(n.id)
    for node in ast.walk(tree):
        if isinstance(node, ast.Global):
            out.update(node.names)
    return out


class _FieldScan:
    """One function's shared-attribute accesses and atomicity splits.

    Mirrors the ``held``-stack walk of ``ProjectIndex._analyze`` but also
    tracks *acquisition identity* (the ``with``-statement line), so a
    release-and-retake of the same lock between a read and its dependent
    write is visible — that gap is exactly what R24 reports.  Emits:

    - access records ``[line, key, mode, locks, wconst]`` where ``key`` is
      ``mod:Cls.attr`` for ``self.attr`` or ``mod.name`` for a module
      global, ``mode`` is ``read``/``write``/``mutate``, ``locks`` is the
      lexically-held lock-id set, and ``wconst`` is ``"flag"`` for
      True/False/None constant writes (the bool fast-path suppression);
    - split records ``[key, read_line, write_line, kind]`` for
      check-then-act and read-modify-write sequences whose read and write
      share no lock acquisition (double-checked re-reads under the write's
      acquisition suppress the candidate).
    """

    def __init__(self, fn, index, global_names: Set[str]):
        self.fn = fn
        self.index = index
        self.mod = fn.module
        self.global_names = global_names
        self.accesses: List[list] = []
        self.splits: List[list] = []
        self._held: List[Tuple[str, int]] = []     # (lock id, with line)
        self._reads: List[Tuple[str, int, frozenset]] = []  # scan order
        self._checks: List[Dict[str, Tuple[int, frozenset]]] = []
        self._bind: Dict[str, Tuple[str, int, frozenset]] = {}
        self._gdecls: Set[str] = set()
        self._locals: Set[str] = set()
        a = fn.node.args
        for p in list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs):
            self._locals.add(p.arg)
        for va in (a.vararg, a.kwarg):
            if va is not None:
                self._locals.add(va.arg)
        for node in FunctionDataflow._walk_pruned(fn.node):
            if isinstance(node, ast.Global):
                self._gdecls.update(node.names)
            elif isinstance(node, ast.Name) and \
                    isinstance(node.ctx, (ast.Store, ast.Del)):
                self._locals.add(node.id)
            elif isinstance(node, ast.ExceptHandler) and node.name:
                self._locals.add(node.name)
        self._locals -= self._gdecls

    def run(self) -> Tuple[List[list], List[list]]:
        for stmt in self.fn.node.body:
            self._scan(stmt)
        return self.accesses, self.splits

    # -- keys --------------------------------------------------------------

    def _self_key(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "self" and self.fn.cls and \
                not _FIELD_SKIP_RE.search(node.attr):
            return f"{self.mod}:{self.fn.cls}.{node.attr}"
        return None

    def _global_key(self, node: ast.Name) -> Optional[str]:
        nid = node.id
        if _FIELD_SKIP_RE.search(nid):
            return None
        if nid in self._gdecls or (nid in self.global_names
                                   and nid not in self._locals):
            return f"{self.mod}.{nid}"
        return None

    def _extern_key(self, node: ast.AST) -> Optional[str]:
        """``othermod.NAME`` write target, resolved through this module's
        import aliases (validated against the target module's tracked
        globals at plan time — only writes are recorded cross-module, so
        stdlib attribute noise never enters the fact store)."""
        if not (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)):
            return None
        if _FIELD_SKIP_RE.search(node.attr):
            return None
        mod = self.index.modules.get(self.mod)
        target = mod.imports.get(node.value.id) if mod is not None else None
        if target is None:
            return None
        return f"{target}.{node.attr}"

    # -- recording ---------------------------------------------------------

    def _rec(self, line: int, key: str, mode: str, wconst: str = "") -> None:
        locks = sorted({l for l, _ in self._held})
        self.accesses.append([line, key, mode, locks, wconst])
        if mode == "read":
            acqs = frozenset(a for _, a in self._held)
            self._reads.append((key, line, acqs))

    def _note_check_then_act(self, key: str, wline: int,
                             wacqs: frozenset) -> None:
        # nearest enclosing if/while test that read this key
        for frame in reversed(self._checks):
            info = frame.get(key)
            if info is None:
                continue
            tline, tacqs = info
            if (tacqs & wacqs) or not (tacqs | wacqs):
                return              # same acquisition spans both, or R23's job
            rechecked = any(
                k == key and line > tline and (acqs & wacqs)
                for k, line, acqs in self._reads)
            if not rechecked:       # double-checked locking stays quiet
                self.splits.append([key, tline, wline, "check-then-act"])
            return

    def _note_rmw(self, key: str, wline: int, wacqs: frozenset,
                  value_reads, value_names) -> None:
        cands = [(line, acqs) for k, line, acqs in value_reads if k == key]
        for name in value_names:
            b = self._bind.get(name)
            if b is not None and b[0] == key:
                cands.append((b[1], b[2]))
        for rline, racqs in cands:
            if (racqs & wacqs) or not (racqs | wacqs):
                continue
            self.splits.append([key, rline, wline, "read-modify-write"])
            return

    def _write_target(self, t: ast.AST, wconst: str,
                      value_reads, value_names) -> None:
        wacqs = frozenset(a for _, a in self._held)
        if isinstance(t, ast.Attribute):
            key = self._self_key(t) or self._extern_key(t)
            if key:
                self._rec(t.lineno, key, "write", wconst)
                self._note_check_then_act(key, t.lineno, wacqs)
                self._note_rmw(key, t.lineno, wacqs, value_reads,
                               value_names)
                return
            # chained target like ``self.cfg.max = v``: mutates the object
            # held in the inner shared attribute
            inner = None
            if isinstance(t.value, ast.Attribute):
                inner = self._self_key(t.value)
            elif isinstance(t.value, ast.Name):
                inner = self._global_key(t.value)
            if inner:
                self._rec(t.value.lineno, inner, "mutate")
            else:
                self._scan(t.value)
            return
        if isinstance(t, ast.Subscript):
            base = t.value
            key = None
            if isinstance(base, ast.Attribute):
                key = self._self_key(base) or self._extern_key(base)
            elif isinstance(base, ast.Name):
                key = self._global_key(base)
            if key:
                self._rec(base.lineno, key, "mutate")
                self._note_check_then_act(key, base.lineno, wacqs)
                self._note_rmw(key, base.lineno, wacqs, value_reads,
                               value_names)
                self._scan(t.slice)
            else:
                self._scan(base)
                self._scan(t.slice)
            return
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self._write_target(e, "", value_reads, value_names)
            return
        if isinstance(t, ast.Starred):
            self._write_target(t.value, "", value_reads, value_names)
            return
        if isinstance(t, ast.Name):
            if t.id in self._gdecls and not _FIELD_SKIP_RE.search(t.id):
                key = f"{self.mod}.{t.id}"
                self._rec(t.lineno, key, "write", wconst)
                self._note_check_then_act(key, t.lineno, wacqs)
                self._note_rmw(key, t.lineno, wacqs, value_reads,
                               value_names)
            return

    # -- walk --------------------------------------------------------------

    def _scan(self, node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return                  # nested defs are their own FunctionInfo
        if isinstance(node, (ast.With, ast.AsyncWith)):
            pushed = 0
            for item in node.items:
                if isinstance(item.context_expr, ast.Call):
                    self._scan(item.context_expr)
                lid = self.index._lock_identity(item.context_expr, self.fn)
                if lid:
                    self._held.append((lid, node.lineno))
                    pushed += 1
            for stmt in node.body:
                self._scan(stmt)
            del self._held[len(self._held) - pushed:]
            return
        if isinstance(node, (ast.If, ast.While)):
            n0 = len(self._reads)
            self._scan(node.test)
            frame: Dict[str, Tuple[int, frozenset]] = {}
            for k, line, acqs in self._reads[n0:]:
                frame.setdefault(k, (line, acqs))
            self._checks.append(frame)
            for stmt in node.body:
                self._scan(stmt)
            for stmt in node.orelse:
                self._scan(stmt)
            self._checks.pop()
            return
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            n0 = len(self._reads)
            if node.value is not None:
                self._scan(node.value)
            value_reads = self._reads[n0:]
            value_names = {n.id for n in ast.walk(node.value)
                           if isinstance(n, ast.Name)
                           and isinstance(n.ctx, ast.Load)} \
                if node.value is not None else set()
            wconst = ""
            if isinstance(node.value, ast.Constant) and \
                    any(node.value.value is v for v in (True, False, None)):
                wconst = "flag"
            targets = list(node.targets) if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                self._write_target(t, wconst, value_reads, value_names)
            if isinstance(node, ast.Assign) and len(targets) == 1 and \
                    isinstance(targets[0], ast.Name) and \
                    targets[0].id not in self._gdecls:
                if value_reads:
                    self._bind[targets[0].id] = value_reads[0]
                else:
                    self._bind.pop(targets[0].id, None)
            return
        if isinstance(node, ast.Delete):
            for t in node.targets:
                self._write_target(t, "", [], set())
            return
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute):
                recv = f.value
                key = None
                if isinstance(recv, ast.Attribute):
                    key = self._self_key(recv)
                elif isinstance(recv, ast.Name):
                    key = self._global_key(recv)
                if key:
                    mode = "mutate" if f.attr in _MUTATOR_ATTRS else "read"
                    self._rec(recv.lineno, key, mode)
                else:
                    self._scan(recv)
            else:
                self._scan(f)
            for arg in node.args:
                self._scan(arg)
            for kw in node.keywords:
                self._scan(kw.value)
            return
        if isinstance(node, ast.Subscript):
            base = node.value
            key = None
            if isinstance(base, ast.Attribute):
                key = self._self_key(base)
            elif isinstance(base, ast.Name):
                key = self._global_key(base)
            if key:
                self._rec(base.lineno, key, "read")
            else:
                self._scan(base)
            self._scan(node.slice)
            return
        if isinstance(node, ast.Attribute):
            key = self._self_key(node)
            if key:
                mode = "read" if isinstance(node.ctx, ast.Load) else "write"
                self._rec(node.lineno, key, mode)
                return
            self._scan(node.value)
            return
        if isinstance(node, ast.Name):
            if isinstance(node.ctx, ast.Load):
                key = self._global_key(node)
                if key:
                    self._rec(node.lineno, key, "read")
            return
        for child in ast.iter_child_nodes(node):
            self._scan(child)


def guarded_decls(ctx, module_name: str, index) -> List[list]:
    """``[key, lock_id, line]`` per ``# raylint: guarded-by(...)``
    declaration in *ctx*.  A declaration attaches to the assignment on the
    same line (or the line directly above, like ``allow``); the lock
    expression resolves exactly like ``ProjectIndex._lock_identity``:
    ``self._lock`` -> ``Cls._lock``, a bare name -> ``mod.name``, an
    import-alias attribute -> the defining module's node."""
    comments: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(ctx.source).readline):
            if tok.type == tokenize.COMMENT:
                m = _GUARDED_RE.search(tok.string)
                if m:
                    comments[tok.start[0]] = m.group(1).strip()
    except tokenize.TokenError:
        pass
    if not comments:
        return []
    mod = index.modules.get(module_name)

    def resolve_lock(text: str, clsname: Optional[str]) -> str:
        if text.startswith("self."):
            return f"{clsname or '?'}.{text[5:]}"
        if "." not in text:
            return f"{module_name}.{text}"
        parts = text.split(".")
        if mod is not None and parts[0] in mod.imports and \
                mod.imports[parts[0]] in index.modules:
            return ".".join([mod.imports[parts[0]]] + parts[1:])
        return text

    decls: List[list] = []
    # comment lines claimed by an inline declaration: the line-above
    # fallback must not re-attach them to the *next* statement
    inline_lines: Set[int] = set()

    def attach(stmt, clsname: Optional[str]) -> None:
        lock_txt = None
        for ln in range(stmt.lineno,
                        getattr(stmt, "end_lineno", stmt.lineno) + 1):
            if ln in comments:
                lock_txt = comments[ln]
                inline_lines.add(ln)
                break
        if lock_txt is None and stmt.lineno - 1 not in inline_lines:
            lock_txt = comments.get(stmt.lineno - 1)
        if lock_txt is None:
            return
        lock = resolve_lock(lock_txt, clsname)
        targets = stmt.targets if isinstance(stmt, ast.Assign) \
            else [stmt.target]
        for t in targets:
            if isinstance(t, ast.Attribute) and \
                    isinstance(t.value, ast.Name) and \
                    t.value.id == "self" and clsname:
                decls.append([f"{module_name}:{clsname}.{t.attr}", lock,
                              stmt.lineno])
            elif isinstance(t, ast.Name):
                key = f"{module_name}:{clsname}.{t.id}" if clsname \
                    else f"{module_name}.{t.id}"
                decls.append([key, lock, stmt.lineno])

    def walk(node, clsname):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                walk(child, child.name)
                continue
            if isinstance(child, (ast.Assign, ast.AnnAssign)):
                attach(child, clsname)
            walk(child, clsname)

    walk(ctx.tree, None)
    return decls


def atomic_attr_keys(ctx, module_name: str, index) -> List[str]:
    """Keys of attributes/globals assigned from an internally-synchronized
    constructor (``queue.Queue``, ``threading.Event``,
    ``itertools.count``, ...) — exempt from the field rules."""
    out: Set[str] = set()

    def walk(node, clsname):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                walk(child, child.name)
                continue
            if isinstance(child, ast.Assign) and \
                    isinstance(child.value, ast.Call):
                dn = _resolved_dotted(child.value.func, ctx) or ""
                if dn.rsplit(".", 1)[-1] in ATOMIC_TYPE_LEAVES:
                    for t in child.targets:
                        if isinstance(t, ast.Attribute) and \
                                isinstance(t.value, ast.Name) and \
                                t.value.id == "self" and clsname:
                            out.add(f"{module_name}:{clsname}.{t.attr}")
                        elif isinstance(t, ast.Name) and clsname is None:
                            out.add(f"{module_name}.{t.id}")
            walk(child, clsname)

    walk(ctx.tree, None)
    return sorted(out)
