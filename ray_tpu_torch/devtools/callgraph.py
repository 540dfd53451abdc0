"""Whole-program symbol table, call graph, and interprocedural summaries.

The per-file rules in :mod:`ray_tpu_torch.devtools.linter` see one parse tree at
a time; the invariants that actually deadlock TPU clusters live *between*
functions: a blocking primitive three calls below an ``async def``, a lock
taken in one method and another lock taken in a callee two files away, a
collective dominated by a rank branch whose body lives in a helper.  This
module builds the shared substrate those interprocedural rules (R10-R13)
run on:

1. **Symbol table** — every module under the lint roots, its top-level
   functions, classes (with base-class links), and import aliases
   (``import a.b as c`` and ``from m import f as g``, including relative
   imports resolved against the package).
2. **Call graph** — one :class:`CallSite` per call expression, resolved
   module-level: plain names through import chains and re-exports,
   ``self.method`` through the class and its project-resolvable bases
   (MRO walk), ``cls.method``, ``super().method``, ``self.attr.method``
   through light attribute-type inference (``self.attr = ClassName(...)``
   anywhere in the class), and local-variable types
   (``v = ClassName(...); v.method()``).  Thread/async entry points are
   classified as their own edge kinds so dataflow can distinguish "runs
   here, now" from "runs on another thread" from "runs on the event loop
   later".
3. **Per-function summaries** — direct blocking primitives, lock
   acquisitions (``with``-statements over lockish expressions, with the
   lexically-held set at each acquisition *and* at each outgoing call),
   and collective/barrier calls.  Rules compose these into transitive
   closures (see the fixpoint helpers at the bottom).

Soundness stance: the resolver is deliberately *under*-approximate.  A
call it cannot resolve degrades to ``target=None`` ("unknown") and simply
contributes no edges — rules built on the graph can therefore miss
findings through dynamic dispatch, but never invent a path that does not
exist.  That is the right polarity for a lint gate that fails CI.

Edge kinds:

===========  ==========================================================
kind         meaning
===========  ==========================================================
``call``     ordinary synchronous call — callee runs on this thread,
             now, with the caller's locks held (also ``await f()``)
``loop``     ``asyncio.create_task``/``ensure_future`` — the coroutine
             runs on *this* event loop, later: event-loop blocking
             propagates, lock-held sets do not
``spawn``    ``threading.Thread(target=...)``, ``executor.submit``,
             ``loop.run_in_executor``, ``call_soon_threadsafe`` — runs
             on another thread: neither blocking nor held locks
             propagate across it
``rpc``      a protocol send site (``client.call(pb.M, ...)``) stitched
             to the dispatch arm that handles ``M`` on the peer — the
             callee runs in ANOTHER PROCESS: locks do not propagate
             (each process has its own instances), but a synchronous
             send blocks this thread until the remote handler replies
===========  ==========================================================

**Cross-process stitching** (:meth:`ProjectIndex._stitch_rpc`): the R18
send/handler extraction already names, for every ``pb.<METHOD>``, the
send sites and the ``elif method == pb.<METHOD>:`` dispatch arms.  The
stitch pass synthesizes one FunctionInfo per dispatch arm (qname
``mod:Class._handle_rpc[METHOD]``, body = the arm's statements, analyzed
like any function so ``self._helper`` calls resolve) and adds an
``rpc``-kind CallSite from every send site to every arm handling that
method.  ``transitive_paths`` can then witness paths that cross daemon
boundaries.  The same under-approximation stance applies: a dispatcher
is only recognized when the dispatched expression provably comes from an
RpcContext-style parameter (``ctx.method`` or a local assigned from it),
and an unmatched method contributes no edges.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

__all__ = ["ProjectIndex", "FunctionInfo", "ClassInfo", "ModuleInfo",
           "CallSite", "module_name_for", "FieldAccess", "FieldPlan",
           "field_display"]

#: The package this analyzer belongs to, and so the package of the tree it
#: lints: every package-qualified name the rules match (barrier qnames,
#: the runtime's ``get``, config and observability modules) is built on it
#: rather than spelled out.
PKG = __name__.split(".", 1)[0]

_LOCKISH = re.compile(r"(^|[._])(lock|mutex|cv|cond|sem)", re.IGNORECASE)

#: Final attributes / names treated as collective or barrier operations
#: (R12).  Matched against the last segment of the called dotted name.
COLLECTIVE_NAMES = frozenset({
    "allreduce", "all_reduce", "allgather", "all_gather", "reducescatter",
    "reduce_scatter", "broadcast", "barrier", "all_to_all", "psum",
    "pmean", "pmax", "pmin", "ppermute",
})

#: Fully-resolved callables that act as cross-rank rendezvous even though
#: their names don't look like collectives: every rank must reach them the
#: same number of times (rank 0 gathers the other ranks' shard indexes in
#: the checkpoint commit barrier; ``session.report`` feeds it).
BARRIER_QNAMES = frozenset(PKG + q for q in (
    ".checkpoint.engine:CheckpointEngine.save",
    ".train.session:report",
    ".train.session:_TrainSession.report",
))


def module_name_for(relpath: str) -> str:
    """Dotted module name for a lint-root-relative path.

    ``ray_tpu_torch/_private/rpc.py`` -> ``ray_tpu_torch._private.rpc``;
    ``ray_tpu_torch/__init__.py`` -> ``ray_tpu_torch``; ``bench.py`` -> ``bench``.
    """
    rel = relpath.replace(os.sep, "/").replace("\\", "/")
    if rel.endswith(".py"):
        rel = rel[:-3]
    if rel.endswith("/__init__"):
        rel = rel[: -len("/__init__")]
    return rel.replace("/", ".")


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclass
class CallSite:
    line: int
    raw: str                      # dotted text as written ("self.flush")
    target: Optional[str]         # resolved function qname, or None
    kind: str = "call"            # call | loop | spawn | rpc
    locks_held: Tuple[str, ...] = ()


@dataclass
class FunctionInfo:
    qname: str                    # "mod:func" or "mod:Class.method"
    module: str
    cls: Optional[str]
    name: str
    node: ast.AST
    ctx: object                   # linter.FileContext
    is_async: bool = False
    # "rpc-arm" for per-dispatch-arm functions synthesized by the stitch
    # pass; rules that enumerate ALL functions for direct facts skip these
    # (their statements belong to the real dispatcher too)
    synthetic: Optional[str] = None
    call_sites: List[CallSite] = field(default_factory=list)
    # call AST node id -> CallSite, for rules that re-walk statements
    site_by_node: Dict[int, CallSite] = field(default_factory=dict)
    # (line, description) of directly-invoked blocking primitives
    blocking: List[Tuple[int, str]] = field(default_factory=list)
    # (lock_id, line, locks already held lexically)
    acquires: List[Tuple[str, int, Tuple[str, ...]]] = field(
        default_factory=list)
    # (line, collective name) invoked directly
    collectives: List[Tuple[int, str]] = field(default_factory=list)


@dataclass
class ClassInfo:
    qname: str                    # "mod:Class"
    module: str
    name: str
    bases: List[str] = field(default_factory=list)       # dotted, as written
    methods: Dict[str, FunctionInfo] = field(default_factory=dict)
    attr_types: Dict[str, str] = field(default_factory=dict)  # attr -> cls qname


@dataclass
class FieldAccess:
    """One shared-attribute access site, expanded with the thread
    contexts that can reach it.  ``ctxs[name]`` is the *effective*
    lockset there: locks held lexically at the site, unioned with the
    locks every path from that context's root must hold on entry to the
    enclosing function (intersection over call paths — a must-analysis,
    so a lock only counts when it is provably held)."""
    key: str                       # "mod:Cls.attr" | "mod.name"
    rel: str                       # file, lint-root relative
    line: int
    mode: str                      # read | write | mutate
    fnq: str                       # enclosing function qname
    locks: Tuple[str, ...]         # lexically held at the site
    wconst: str                    # "flag" for True/False/None writes
    ctxs: Dict[str, frozenset] = field(default_factory=dict)


@dataclass
class FieldPlan:
    """Joined whole-program field-safety facts for R23-R25."""
    roots: Dict[str, Tuple[str, int, str]]        # ctx -> (rel, line, how)
    contexts: Dict[str, Dict[str, frozenset]]     # fnq -> ctx -> must-held
    accesses: Dict[str, List[FieldAccess]]        # key -> live sites
    guarded: Dict[str, Tuple[str, str, int]]      # key -> (lock, rel, line)
    splits: List[Tuple[str, str, int, int, str]]  # (fnq,key,rline,wline,kind)
    init_only: Set[str]                           # construction-only fns
    atomic_keys: Set[str]
    flag_keys: Set[str]                           # bool fast-path fields
    spawns_in: Dict[str, List[Tuple[str, int]]]   # fnq -> [(root, line)]


def field_display(key: str) -> str:
    """Human/runtime-correlatable name for a field key: strip the module
    qualifier from ``mod:Cls.attr`` so static R25 findings and lockwatch
    level-2 reports (which only know ``Cls.attr``) compare equal."""
    return key.split(":", 1)[1] if ":" in key else key


@dataclass
class ModuleInfo:
    name: str
    ctx: object
    is_package: bool = False
    imports: Dict[str, str] = field(default_factory=dict)    # local -> dotted
    functions: Dict[str, FunctionInfo] = field(default_factory=dict)
    classes: Dict[str, ClassInfo] = field(default_factory=dict)


class ProjectIndex:
    """Symbol table + resolved call graph over a set of FileContexts."""

    def __init__(self, ctxs: Iterable[object],
                 stitch_facts: Optional[Dict[str, dict]] = None,
                 field_facts: Optional[Dict[str, dict]] = None):
        self.modules: Dict[str, ModuleInfo] = {}
        self.functions: Dict[str, FunctionInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}
        self.ctx_of: Dict[str, object] = {}      # relpath -> FileContext
        for ctx in ctxs:
            self._add_module(ctx)
        for mod in self.modules.values():
            self._collect_imports(mod)
        for cls in self.classes.values():
            self._infer_attr_types(cls)
        for fn in self.functions.values():
            self._analyze(fn)
        # cross-process edges: method -> arm qnames, plus one record per
        # send site (qname, line, method, sync, locks_held, arm targets).
        # ``stitch_facts`` replays per-file send/dispatcher discovery from
        # the incremental cache (entries are hash-validated by the caller).
        self.rpc_arms: Dict[str, List[str]] = {}
        self.rpc_sites: List[Tuple[str, int, str, bool,
                                   Tuple[str, ...], Tuple[str, ...]]] = []
        self.stitch_facts: Dict[str, dict] = {}
        self.stitch_hits = 0
        self._stitch_rpc(stitch_facts or {})
        # per-file field facts (R23-R25), built lazily by field_plan():
        # ``field_facts`` replays hash-validated entries from the cache
        self.field_facts: Dict[str, dict] = {}
        self.field_hits = 0
        self._field_cache: Dict[str, dict] = field_facts or {}
        self._plan: Optional[FieldPlan] = None

    # -- construction ------------------------------------------------------

    def _add_module(self, ctx) -> None:
        mod = ModuleInfo(module_name_for(ctx.relpath), ctx,
                         is_package=ctx.relpath.replace("\\", "/")
                         .endswith("__init__.py"))
        self.modules[mod.name] = mod
        self.ctx_of[ctx.relpath] = ctx

        def add_fn(node, cls: Optional[ClassInfo]):
            owner = f"{cls.name}." if cls else ""
            info = FunctionInfo(
                qname=f"{mod.name}:{owner}{node.name}", module=mod.name,
                cls=cls.name if cls else None, name=node.name, node=node,
                ctx=ctx, is_async=isinstance(node, ast.AsyncFunctionDef))
            # first definition wins (overloads/redefinitions are rare and
            # resolving to the first keeps the graph deterministic)
            self.functions.setdefault(info.qname, info)
            if cls is not None:
                cls.methods.setdefault(node.name, info)
            else:
                mod.functions.setdefault(node.name, info)
            return info

        def walk(node, cls: Optional[ClassInfo]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    cinfo = ClassInfo(qname=f"{mod.name}:{child.name}",
                                      module=mod.name, name=child.name,
                                      bases=[b for b in
                                             (_dotted(x) for x in child.bases)
                                             if b])
                    self.classes.setdefault(cinfo.qname, cinfo)
                    mod.classes.setdefault(child.name, cinfo)
                    walk(child, cinfo)
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    add_fn(child, cls)
                    # nested defs are indexed under the same class scope so
                    # self.x inside them still resolves; their call sites
                    # stay separate from the parent's (pruned walk)
                    walk(child, cls)
                else:
                    walk(child, cls)

        walk(ctx.tree, None)

    def _collect_imports(self, mod: ModuleInfo) -> None:
        package = mod.name if mod.is_package else (
            mod.name.rsplit(".", 1)[0] if "." in mod.name else "")
        for node in ast.walk(mod.ctx.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.asname:
                        mod.imports[alias.asname] = alias.name
                    else:
                        # "import a.b.c" binds "a"
                        mod.imports[alias.name.split(".")[0]] = \
                            alias.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    anchor = package
                    for _ in range(node.level - 1):
                        anchor = anchor.rsplit(".", 1)[0] if "." in anchor \
                            else ""
                    base = f"{anchor}.{base}".strip(".") if base else anchor
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    mod.imports[alias.asname or alias.name] = \
                        f"{base}.{alias.name}" if base else alias.name

    # -- resolution --------------------------------------------------------

    def _resolve_qualified(self, dotted: str,
                           depth: int = 0) -> Optional[str]:
        """Resolve an absolute dotted path to a symbol key.

        Returns a function qname (``mod:f`` / ``mod:C.m``), a class qname
        (``mod:C``), a module name, or None.  Follows re-exports through
        ``__init__`` modules with a depth guard.
        """
        if depth > 8:
            return None
        parts = dotted.split(".")
        for cut in range(len(parts), 0, -1):
            mod = self.modules.get(".".join(parts[:cut]))
            if mod is None:
                continue
            rest = parts[cut:]
            if not rest:
                return mod.name
            head, tail = rest[0], rest[1:]
            if head in mod.functions and not tail:
                return mod.functions[head].qname
            if head in mod.classes:
                cls = mod.classes[head]
                if not tail:
                    return cls.qname
                if len(tail) == 1:
                    m = self.lookup_method(cls, tail[0])
                    return m.qname if m else None
                return None
            if head in mod.imports:
                return self._resolve_qualified(
                    ".".join([mod.imports[head]] + tail), depth + 1)
            return None
        return None

    def resolve_name(self, mod: ModuleInfo, dotted: str) -> Optional[str]:
        """Resolve a dotted expression written in *mod*'s scope."""
        parts = dotted.split(".")
        head, tail = parts[0], parts[1:]
        if head in mod.functions and not tail:
            return mod.functions[head].qname
        if head in mod.classes:
            cls = mod.classes[head]
            if not tail:
                return cls.qname
            if len(tail) == 1:
                m = self.lookup_method(cls, tail[0])
                return m.qname if m else None
            return None
        if head in mod.imports:
            return self._resolve_qualified(
                ".".join([mod.imports[head]] + tail))
        return None

    def lookup_method(self, cls: ClassInfo, name: str,
                      _seen: Tuple[str, ...] = ()) -> Optional[FunctionInfo]:
        """Method lookup through the class and project-resolvable bases."""
        if cls.qname in _seen:
            return None
        if name in cls.methods:
            return cls.methods[name]
        mod = self.modules.get(cls.module)
        for base in cls.bases:
            key = self.resolve_name(mod, base) if mod else None
            binfo = self.classes.get(key) if key else None
            if binfo is not None:
                found = self.lookup_method(binfo, name,
                                           _seen + (cls.qname,))
                if found:
                    return found
        return None

    def _class_of(self, fn: FunctionInfo) -> Optional[ClassInfo]:
        return self.classes.get(f"{fn.module}:{fn.cls}") if fn.cls else None

    def _infer_attr_types(self, cls: ClassInfo) -> None:
        """``self.attr = ClassName(...)`` anywhere in the class types attr."""
        mod = self.modules.get(cls.module)
        for m in cls.methods.values():
            for node in ast.walk(m.node):
                if not (isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Call)):
                    continue
                ctor = _dotted(node.value.func)
                key = self.resolve_name(mod, ctor) if (ctor and mod) else None
                if key not in self.classes:
                    continue
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        cls.attr_types.setdefault(t.attr, key)

    # -- per-function analysis --------------------------------------------

    def _lock_identity(self, expr: ast.AST,
                       fn: FunctionInfo) -> Optional[str]:
        text = _dotted(expr)
        if not text or not _LOCKISH.search(text):
            return None
        if text.startswith("self."):
            # class-qualified, like R2 and lockwatch's per-site identity
            return f"{fn.cls or '?'}.{text[5:]}"
        if "." not in text:
            # bare module-global lock: qualify by module so same-named
            # globals in different files never merge into one node
            return f"{fn.module}.{text}"
        # module-alias attribute (``with b.LOCK: ...`` after ``from proj
        # import b``): rewrite to the defining module's node so it merges
        # with that module's own bare-name acquisitions
        parts = text.split(".")
        mod = self.modules.get(fn.module)
        if mod is not None and parts[0] in mod.imports:
            target = mod.imports[parts[0]]
            if target in self.modules:
                return ".".join([target] + parts[1:])
        return text

    def _resolve_call(self, fn: FunctionInfo, dn: Optional[str],
                      local_types: Dict[str, str]) -> Optional[str]:
        if not dn:
            return None
        mod = self.modules.get(fn.module)
        cls = self._class_of(fn)
        parts = dn.split(".")
        if parts[0] in ("self", "cls") and cls is not None:
            if len(parts) == 2:
                m = self.lookup_method(cls, parts[1])
                return m.qname if m else None
            if len(parts) == 3:
                tkey = cls.attr_types.get(parts[1])
                tcls = self.classes.get(tkey) if tkey else None
                if tcls is not None:
                    m = self.lookup_method(tcls, parts[2])
                    return m.qname if m else None
            return None
        if parts[0] in local_types and len(parts) == 2:
            tcls = self.classes.get(local_types[parts[0]])
            if tcls is not None:
                m = self.lookup_method(tcls, parts[1])
                return m.qname if m else None
            return None
        key = self.resolve_name(mod, dn) if mod else None
        if key in self.classes:
            # constructing a class: the synchronous work is __init__
            init = self.lookup_method(self.classes[key], "__init__")
            return init.qname if init else None
        if key in self.functions:
            return key
        return None

    def _blocking_reason(self, node: ast.Call, fn: FunctionInfo,
                         dn: Optional[str]) -> Optional[str]:
        ctx = fn.ctx
        if dn == "time.sleep" or (
                dn == "sleep" and
                getattr(ctx, "from_imports", {}).get("sleep") == "time"):
            return "blocking time.sleep()"
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            kwargs = {kw.arg for kw in node.keywords}
            if attr == "result" and not node.args and "timeout" not in kwargs:
                return "blocking Future.result() without timeout"
            if attr == "acquire" and _LOCKISH.search(
                    _dotted(node.func.value) or ""):
                if not node.args and not ({"timeout", "blocking"} & kwargs):
                    return "lock .acquire() with no timeout"
            if attr == "get" and _dotted(node.func.value) == PKG:
                return f"blocking {PKG}.get()"
        elif isinstance(node.func, ast.Name) and node.func.id == "get" and \
                getattr(ctx, "from_imports", {}).get(
                    "get", "").startswith(PKG):
            return f"blocking {PKG}.get()"
        return None

    def _analyze(self, fn: FunctionInfo) -> None:
        local_types: Dict[str, str] = {}
        mod = self.modules.get(fn.module)
        cls = self._class_of(fn)
        held: List[str] = []

        def add_site(node: ast.Call, target: Optional[str], kind: str,
                     raw: str) -> None:
            site = CallSite(line=node.lineno, raw=raw, target=target,
                            kind=kind, locks_held=tuple(held))
            fn.call_sites.append(site)
            fn.site_by_node[id(node)] = site

        def spawn_target(node: ast.Call) -> Optional[ast.AST]:
            dn = _dotted(node.func)
            if dn in ("threading.Thread", "Thread"):
                for kw in node.keywords:
                    if kw.arg == "target":
                        return kw.value
                return None
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in ("submit", "call_soon_threadsafe"):
                    return node.args[0] if node.args else None
                if node.func.attr == "run_in_executor":
                    return node.args[1] if len(node.args) > 1 else None
            return None

        def handle_call(node: ast.Call) -> None:
            dn = _dotted(node.func)
            reason = self._blocking_reason(node, fn, dn)
            if reason is not None:
                fn.blocking.append((node.lineno, reason))
            last = (dn or "").rsplit(".", 1)[-1]
            target: Optional[str]
            if dn in ("asyncio.create_task", "asyncio.ensure_future",
                      "create_task", "ensure_future") and node.args and \
                    isinstance(node.args[0], ast.Call):
                inner = _dotted(node.args[0].func)
                target = self._resolve_call(fn, inner, local_types)
                add_site(node, target, "loop", inner or "<dynamic>")
                return
            st = spawn_target(node)
            if st is not None:
                sdn = _dotted(st)
                target = self._resolve_call(fn, sdn, local_types)
                add_site(node, target, "spawn", sdn or "<dynamic>")
                return
            # super().method() -> first base that defines it
            if isinstance(node.func, ast.Attribute) and \
                    isinstance(node.func.value, ast.Call) and \
                    isinstance(node.func.value.func, ast.Name) and \
                    node.func.value.func.id == "super" and cls is not None:
                m = None
                for base in cls.bases:
                    key = self.resolve_name(mod, base) if mod else None
                    binfo = self.classes.get(key) if key else None
                    if binfo:
                        m = self.lookup_method(binfo, node.func.attr)
                        if m:
                            break
                add_site(node, m.qname if m else None, "call",
                         f"super().{node.func.attr}")
                return
            target = self._resolve_call(fn, dn, local_types)
            add_site(node, target, "call", dn or "<dynamic>")
            if last in COLLECTIVE_NAMES or \
                    (target is not None and target in BARRIER_QNAMES):
                fn.collectives.append((node.lineno, last))

        def visit(node: ast.AST) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                return  # nested defs are their own FunctionInfo
            if isinstance(node, (ast.With, ast.AsyncWith)):
                pushed = 0
                for item in node.items:
                    if isinstance(item.context_expr, ast.Call):
                        visit(item.context_expr)
                    lid = self._lock_identity(item.context_expr, fn)
                    if lid:
                        fn.acquires.append((lid, node.lineno, tuple(held)))
                        held.append(lid)
                        pushed += 1
                for stmt in node.body:
                    visit(stmt)
                for _ in range(pushed):
                    held.pop()
                return
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call):
                ctor = _dotted(node.value.func)
                key = self.resolve_name(mod, ctor) if (ctor and mod) else None
                if key in self.classes:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            local_types[t.id] = key
            if isinstance(node, ast.Call):
                handle_call(node)
            for child in ast.iter_child_nodes(node):
                visit(child)

        for stmt in fn.node.body:
            visit(stmt)

    # -- cross-process stitching (rpc edges) -------------------------------

    @staticmethod
    def _param_names(fn_node: ast.AST) -> List[str]:
        a = fn_node.args
        return [p.arg for p in
                list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)]

    def _send_method(self, node: ast.Call, ctx) -> Optional[Tuple[str, bool]]:
        """``(method, sync)`` when *node* is a protocol send carrying a
        ``pb.<METHOD>`` constant (same vocabulary as R18's extraction).
        ``sync`` is True only for the blocking request/reply primitive
        (final attribute literally ``call`` — ``RpcClient.call`` blocks on
        its reply); fire-and-forget / callback sends never wait."""
        from ray_tpu_torch.devtools import dataflow as _df
        dotted = _dotted(node.func) or ""
        leaf = dotted.rsplit(".", 1)[-1]
        is_send = (isinstance(node.func, ast.Attribute)
                   and node.func.attr in _df.SEND_ATTRS) or \
            bool(_df._SENDISH_RE.search(leaf))
        has_method_kw = any(kw.arg == "method" for kw in node.keywords)
        if not (is_send or has_method_kw):
            return None
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            for sub in ast.walk(arg):
                m = _df._pb_method(sub, ctx)
                if m is not None:
                    return m, leaf == "call"
        return None

    def _dispatch_arms(self, fn: FunctionInfo
                       ) -> List[Tuple[str, ast.If]]:
        """``(method, If-node)`` per dispatch arm when *fn* is an
        RpcContext dispatcher.  Recognized only when the compared
        expression provably originates from a context-ish parameter
        (``ctx.method`` / ``env.method`` or a local assigned once from
        it) — a sender helper that merely branches on its own ``method``
        argument is NOT a dispatcher (under-approximation)."""
        from ray_tpu_torch.devtools import dataflow as _df
        ctx_params = {p for p in self._param_names(fn.node)
                      if p in ("ctx", "env") or p.endswith("_ctx")}
        if not ctx_params:
            return []

        def from_ctx(e: ast.AST) -> bool:
            return (isinstance(e, ast.Attribute) and e.attr == "method"
                    and isinstance(e.value, ast.Name)
                    and e.value.id in ctx_params)

        meth_locals: Set[str] = set()
        for node in _df.FunctionDataflow._walk_pruned(fn.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and from_ctx(node.value):
                meth_locals.add(node.targets[0].id)

        def is_method_expr(e: ast.AST) -> bool:
            return from_ctx(e) or (isinstance(e, ast.Name)
                                   and e.id in meth_locals)

        arms: List[Tuple[str, ast.If]] = []
        for node in _df.FunctionDataflow._walk_pruned(fn.node):
            if not isinstance(node, ast.If) or \
                    not isinstance(node.test, ast.Compare) or \
                    len(node.test.ops) != 1 or \
                    not is_method_expr(node.test.left):
                continue
            comp = node.test.comparators[0]
            if isinstance(node.test.ops[0], ast.Eq):
                m = _df._pb_method(comp, fn.ctx)
                if m is not None:
                    arms.append((m, node))
            elif isinstance(node.test.ops[0], ast.In) and \
                    isinstance(comp, (ast.Tuple, ast.List, ast.Set)):
                for elt in comp.elts:
                    m = _df._pb_method(elt, fn.ctx)
                    if m is not None:
                        arms.append((m, node))
        return arms

    def _file_stitch_facts(self, rel: str) -> dict:
        """JSON-able per-file stitch facts, a pure function of that one
        file's source (cacheable under its content hash): every protocol
        send site and every dispatcher function."""
        from ray_tpu_torch.devtools import dataflow as _df
        sends: List[list] = []
        dispatchers: List[str] = []
        ctx = self.ctx_of[rel]
        for q, fn in self.functions.items():
            if fn.ctx is not ctx or fn.synthetic:
                continue
            for node in _df.FunctionDataflow._walk_pruned(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                ms = self._send_method(node, ctx)
                if ms is None:
                    continue
                site = fn.site_by_node.get(id(node))
                held = list(site.locks_held) if site is not None else []
                sends.append([q, node.lineno, ms[0], ms[1], held])
            if self._dispatch_arms(fn):
                dispatchers.append(q)
        return {"sends": sends, "dispatchers": sorted(dispatchers)}

    def _synthesize_arm(self, fn: FunctionInfo, method: str,
                        if_node: ast.If) -> Optional[str]:
        name = f"{fn.name}[{method}]"
        owner = f"{fn.cls}." if fn.cls else ""
        qname = f"{fn.module}:{owner}{name}"
        if qname in self.functions:
            return None              # duplicate arm for the same method
        node = ast.FunctionDef(name=name, args=fn.node.args,
                               body=list(if_node.body), decorator_list=[],
                               returns=None, type_comment=None)
        node.lineno = if_node.lineno
        node.col_offset = if_node.col_offset
        info = FunctionInfo(qname=qname, module=fn.module, cls=fn.cls,
                            name=name, node=node, ctx=fn.ctx,
                            synthetic="rpc-arm")
        self.functions[qname] = info
        self._analyze(info)
        self.rpc_arms.setdefault(method, []).append(qname)
        lo = min((s.lineno for s in if_node.body), default=if_node.lineno)
        hi = max((getattr(s, "end_lineno", s.lineno) for s in if_node.body),
                 default=if_node.lineno)
        self._arm_spans[qname] = (fn.qname, lo, hi)
        return qname

    def _stitch_rpc(self, cached: Dict[str, dict]) -> None:
        self._arm_spans: Dict[str, Tuple[str, int, int]] = {}
        for rel in sorted(self.ctx_of):
            facts = cached.get(rel)
            if facts is not None:
                self.stitch_hits += 1
            else:
                facts = self._file_stitch_facts(rel)
            self.stitch_facts[rel] = facts
        # pass 1: synthesize every dispatch arm (senders may live in
        # files sorted before their dispatcher)
        for rel in sorted(self.stitch_facts):
            for dq in self.stitch_facts[rel]["dispatchers"]:
                fn = self.functions.get(dq)
                if fn is None or fn.synthetic:
                    continue
                for method, if_node in self._dispatch_arms(fn):
                    self._synthesize_arm(fn, method, if_node)
        # pass 2: every send site becomes an rpc edge to each arm that
        # handles its method; a send written lexically inside an arm is
        # attributed to that arm too, so per-method closures see it
        for rel in sorted(self.stitch_facts):
            for q, line, method, sync, held in \
                    self.stitch_facts[rel]["sends"]:
                fn = self.functions.get(q)
                if fn is None:
                    continue
                targets = tuple(sorted(self.rpc_arms.get(method, ())))
                holders = [(q, fn)]
                for armq, (dispq, lo, hi) in self._arm_spans.items():
                    if dispq == q and lo <= line <= hi:
                        holders.append((armq, self.functions[armq]))
                for hq, hfn in holders:
                    for aq in targets:
                        hfn.call_sites.append(CallSite(
                            line=line, raw=f"rpc:{method}", target=aq,
                            kind="rpc", locks_held=tuple(held)))
                    self.rpc_sites.append(
                        (hq, line, method, bool(sync), tuple(held), targets))

    # -- field-level thread-safety plan (R23-R25) --------------------------

    def _file_field_facts(self, rel: str) -> dict:
        """JSON-able per-file field facts, a pure function of that one
        file's source (cacheable under its content hash): shared-attribute
        access records and atomicity splits per function (synthetic rpc
        arms included — their accesses carry the arm's thread context),
        guarded-by declarations, atomic-typed attributes, and the tracked
        module-global name set."""
        from ray_tpu_torch.devtools import dataflow as _df
        ctx = self.ctx_of[rel]
        mod_name = module_name_for(rel)
        gnames = _df.module_global_names(ctx.tree)
        accesses: Dict[str, List[list]] = {}
        splits: Dict[str, List[list]] = {}
        for q in sorted(self.functions):
            fn = self.functions[q]
            if fn.ctx is not ctx:
                continue
            acc, spl = _df._FieldScan(fn, self, gnames).run()
            if acc:
                accesses[q] = acc
            if spl:
                splits[q] = spl
        return {
            "accesses": accesses,
            "splits": splits,
            "guarded": _df.guarded_decls(ctx, mod_name, self),
            "atomic": _df.atomic_attr_keys(ctx, mod_name, self),
            "globals": sorted(gnames),
        }

    def field_facts_all(self) -> Dict[str, dict]:
        if not self.field_facts:
            for rel in sorted(self.ctx_of):
                facts = self._field_cache.get(rel)
                if facts is not None:
                    self.field_hits += 1
                else:
                    facts = self._file_field_facts(rel)
                self.field_facts[rel] = facts
        return self.field_facts

    def field_plan(self) -> FieldPlan:
        """Join the per-file field facts with thread contexts and
        interprocedural must-hold locksets (memoized; built on demand by
        the first of R23-R25 to run).

        *Thread contexts* are the distinct roots code can run under:
        ``main`` (module import / direct API calls), every resolved
        ``spawn`` target (Thread/executor submit/call_soon_threadsafe),
        every ``Thread`` subclass ``run``, and every synthesized RPC
        dispatch arm.  Contexts propagate over ``call``/``loop`` edges
        (``loop`` resets the held-lock set: the task runs later); they do
        NOT cross ``spawn``/``rpc`` edges — the callee side is its own
        root.  Per (function, context) the must-held lockset is the
        intersection over all call paths from the root, so it can only
        shrink as more paths are discovered (sound for a race checker).
        """
        if self._plan is not None:
            return self._plan
        facts = self.field_facts_all()
        # 1. thread roots + spawn bookkeeping (for the happens-before-
        #    spawn suppression: a write before the spawn cannot race with
        #    the thread it starts)
        roots: Dict[str, Tuple[str, int, str]] = {}
        spawns_in: Dict[str, List[Tuple[str, int]]] = {}
        for q in sorted(self.functions):
            fn = self.functions[q]
            for s in fn.call_sites:
                if s.kind == "spawn" and s.target in self.functions:
                    roots.setdefault(
                        s.target, (fn.ctx.relpath, s.line,
                                   f"spawned from {q}"))
                    spawns_in.setdefault(q, []).append((s.target, s.line))
            if fn.synthetic == "rpc-arm":
                roots.setdefault(q, (fn.ctx.relpath, fn.node.lineno,
                                     "rpc dispatch arm"))
        for cq in sorted(self.classes):
            cls = self.classes[cq]
            if any(b.rsplit(".", 1)[-1] == "Thread" for b in cls.bases):
                run = cls.methods.get("run")
                if run is not None:
                    roots.setdefault(run.qname,
                                     (run.ctx.relpath, run.node.lineno,
                                      f"{cls.name}.run"))
        # 2. nested defs never become main entries: they only run when
        #    (and where) their enclosing function invokes them
        by_node = {id(f.node): q for q, f in self.functions.items()
                   if not f.synthetic}
        nested: Set[str] = set()
        for q, fn in self.functions.items():
            if fn.synthetic:
                continue
            for node in ast.walk(fn.node):
                if node is not fn.node and id(node) in by_node:
                    nested.add(by_node[id(node)])
        # 3. context fixpoint over call/loop edges
        callers: Dict[str, List[str]] = {}
        callees_of: Dict[str, List[CallSite]] = {}
        for q, fn in self.functions.items():
            outs = [s for s in fn.call_sites
                    if s.kind in ("call", "loop")
                    and s.target in self.functions]
            callees_of[q] = outs
            for s in outs:
                callers.setdefault(s.target, []).append(q)
        contexts: Dict[str, Dict[str, frozenset]] = {}
        work: List[str] = []
        for q in sorted(roots):
            contexts[q] = {q: frozenset()}
            work.append(q)
        for q in sorted(self.functions):
            fn = self.functions[q]
            if fn.synthetic or q in roots or q in nested or q in callers:
                continue
            contexts[q] = {"main": frozenset()}
            work.append(q)
        while work:
            q = work.pop()
            cur = contexts.get(q)
            if not cur:
                continue
            for s in callees_of.get(q, ()):
                tgt = contexts.setdefault(s.target, {})
                changed = False
                for cname, held in cur.items():
                    eff = frozenset() if s.kind == "loop" else \
                        held | frozenset(s.locks_held)
                    old = tgt.get(cname)
                    if old is None:
                        tgt[cname] = eff
                        changed = True
                    elif not (old <= eff):
                        tgt[cname] = old & eff
                        changed = True
                if changed:
                    work.append(s.target)
        # 4. construction-only closure: accesses there touch an instance
        #    no other thread can see yet (fresh-instance assumption —
        #    single-writer-before-spawn / immutable-after-init)
        init_names = {"__init__", "__new__", "__post_init__"}
        init_only: Set[str] = {q for q, fn in self.functions.items()
                               if fn.name in init_names and not fn.synthetic}
        changed = True
        while changed:
            changed = False
            for q, fn in self.functions.items():
                if q in init_only or fn.synthetic or q in roots:
                    continue
                cl = callers.get(q)
                if cl and all(c in init_only for c in cl):
                    init_only.add(q)
                    changed = True
        # 5. suppression sets + declarations, merged across files
        globals_of: Dict[str, Set[str]] = {}
        atomic_keys: Set[str] = set()
        guarded: Dict[str, Tuple[str, str, int]] = {}
        splits: List[Tuple[str, str, int, int, str]] = []
        for rel in sorted(facts):
            f = facts[rel]
            globals_of[module_name_for(rel)] = set(f.get("globals") or ())
            atomic_keys.update(f.get("atomic") or ())
            for key, lock, line in f.get("guarded") or ():
                guarded.setdefault(key, (lock, rel, line))
            for fnq in sorted(f.get("splits") or {}):
                for key, rline, wline, kind in f["splits"][fnq]:
                    splits.append((fnq, key, rline, wline, kind))
        # 6. expand access records with contexts; dedupe sites the stitch
        #    pass duplicated into rpc arms (same key/rel/line/mode) by
        #    unioning their context maps
        site_map: Dict[Tuple[str, str, int, str], FieldAccess] = {}
        for rel in sorted(facts):
            for fnq in sorted(facts[rel].get("accesses") or {}):
                fn = self.functions.get(fnq)
                if fn is None:
                    continue
                fctxs = contexts.get(fnq) or {}
                if not fctxs or fnq in init_only:
                    continue
                for line, key, mode, locks, wconst in \
                        facts[rel]["accesses"][fnq]:
                    if key in atomic_keys:
                        continue
                    if ":" not in key:
                        kmod, _, kname = key.rpartition(".")
                        tracked = globals_of.get(kmod)
                        if tracked is None or kname not in tracked:
                            continue
                    ident = (key, rel, line, mode)
                    fa = site_map.get(ident)
                    if fa is None:
                        fa = FieldAccess(key=key, rel=rel, line=line,
                                         mode=mode, fnq=fnq,
                                         locks=tuple(locks), wconst=wconst)
                        site_map[ident] = fa
                    for cname, held in fctxs.items():
                        eff = frozenset(locks) | held
                        old = fa.ctxs.get(cname)
                        fa.ctxs[cname] = eff if old is None else (old & eff)
        by_key: Dict[str, List[FieldAccess]] = {}
        for ident in sorted(site_map):
            fa = site_map[ident]
            by_key.setdefault(fa.key, []).append(fa)
        flag_keys = {
            key for key, lst in by_key.items()
            if any(a.mode == "write" for a in lst)
            and not any(a.mode == "mutate" for a in lst)
            and all(a.wconst == "flag" for a in lst if a.mode == "write")}
        self._plan = FieldPlan(
            roots=roots, contexts=contexts, accesses=by_key,
            guarded=guarded, splits=splits, init_only=init_only,
            atomic_keys=atomic_keys, flag_keys=flag_keys,
            spawns_in=spawns_in)
        return self._plan

    # -- fixpoint helpers for the interprocedural rules --------------------

    def _callees(self, fn: FunctionInfo,
                 kinds: Tuple[str, ...]) -> List[CallSite]:
        return [s for s in fn.call_sites
                if s.kind in kinds and s.target in self.functions]

    def transitive_paths(self, direct: Dict[str, List[Tuple[int, str]]],
                         kinds: Tuple[str, ...] = ("call",)
                         ) -> Dict[str, Dict[str, List[Tuple[str, int]]]]:
        """Fixpoint closure of a per-function fact set over the call graph.

        ``direct[qname]`` is a list of ``(line, key)`` facts established in
        that function.  Returns, per function, ``key -> witness path``
        where a path is ``[(qname, line), ...]`` ending at the function
        that establishes the fact directly.  The first-discovered witness
        is kept (deterministic: call sites are visited in source order).
        """
        out: Dict[str, Dict[str, List[Tuple[str, int]]]] = {}
        for q, facts in direct.items():
            d = out.setdefault(q, {})
            for line, key in facts:
                d.setdefault(key, [(q, line)])
        # reverse edges for the worklist
        callers: Dict[str, List[Tuple[str, CallSite]]] = {}
        for q, fn in self.functions.items():
            for site in self._callees(fn, kinds):
                callers.setdefault(site.target, []).append((q, site))
        work = list(out)
        while work:
            callee = work.pop()
            facts = out.get(callee, {})
            for caller, site in callers.get(callee, ()):
                d = out.setdefault(caller, {})
                changed = False
                for key, path in facts.items():
                    if key not in d:
                        d[key] = [(caller, site.line)] + path
                        changed = True
                if changed:
                    work.append(caller)
        return out
