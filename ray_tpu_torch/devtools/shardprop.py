"""Abstract sharding propagation for the SPMD lint rules (R27-R29).

The PyTorch form of the reference's model.  The SPMD surface of the tree
is *data*: ``ShardingRules`` tables map logical axis names to mesh axes,
``AXIS_ORDER`` and ``DeviceMesh(..., mesh_dim_names=...)`` /
``init_device_mesh(..., mesh_dim_names=...)`` constructions declare the
mesh-axis universe, and the spec tuples that ``spec_to_placements``
takes (one entry per tensor dim, the counterpart of a ``PartitionSpec``),
DTensor placements (``distribute_tensor``, ``DTensor.from_local``,
``redistribute``), ``local_map`` (the counterpart of ``shard_map``) and
the collectives consume both.  This module extracts those facts per file
(pure, JSON-able — they ride the incremental lint cache keyed by content
hash, exactly like the stitch and field facts of
:mod:`ray_tpu_torch.devtools.callgraph`) and joins them into a whole-tree
:class:`ShardModel` the R27/R28/R29 project rules query.

The propagation lattice is deliberately tiny: every value is either a
*known constant* (a string, ``None``, or a tuple of strings, resolved
through single-assignment locals in the enclosing scope chain) or ``"?"``
(top).  Anything dynamic — a spec built from parameters, a mesh with
computed dim names, a rules table spread from ``**kwargs`` — degrades to
top, and top never produces a finding.  When a file constructs a mesh or
a rules table we cannot enumerate, the whole corresponding universe is
marked *open* and membership checks shut off tree-wide: the rules
under-report but never invent, the same stance as R10-R26.

A placement is known in one of two forms, compared only with its own
kind: a spec (``spec_to_placements(mesh, ("data", None))``) or a literal
placement list (``(Shard(0), Replicate())``).

:func:`build_manifest` turns the same model into ``comms_manifest.json``
— the static plan of every explicit ``ray_tpu_torch.collective`` op
(keyed by group name) and every mesh collective with a resolved mesh axis
(keyed ``axis:<name>``): ``parallel.spmd``'s ``psum``/``ppermute``/
``all_to_all``/``all_gather`` over an axis, and ``torch.distributed`` ops
whose ``group=`` is a mesh axis's group.  Each entry carries its busbw
wire-factor formula.  The formulas mirror ``observability/comms.py``'s
``_BUSBW`` table; ``ray_tpu_torch.doctor --comms-baseline`` cross-checks
the runtime ledger against this plan and reports unplanned collectives as
drift.

JAX forms with no PyTorch counterpart: a wasted donation (R28's second
arm) — PyTorch has no buffer donation, so nothing can be wasted.
"""

from __future__ import annotations

import ast
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["file_shard_facts", "ShardModel", "build_manifest",
           "wire_factor", "WIRE_FORMULAS", "format_spec", "UNKNOWN"]

UNKNOWN = "?"

PKG = __name__.split(".", 1)[0]

# parallel/spmd.py's per-rank collectives over a named mesh axis (the
# counterparts of jax.lax's): the axis is the third positional argument
# or ``axis=``.
AXIS_COLLECTIVES = frozenset({"psum", "ppermute", "all_to_all",
                              "all_gather"})

# torch.distributed collectives, by the ledger op name the collective API
# records them under (observability/comms.py).
DIST_OPS: Dict[str, str] = {
    "all_reduce": "allreduce", "all_gather": "allgather",
    "all_gather_into_tensor": "allgather",
    "reduce_scatter": "reducescatter",
    "reduce_scatter_tensor": "reducescatter",
    "all_to_all": "all_to_all", "all_to_all_single": "all_to_all",
    "broadcast": "broadcast", "reduce": "reduce", "barrier": "barrier",
}

# Public ops of ray_tpu_torch/collective/collective.py, by ledger op name.
EXPLICIT_OPS = frozenset({
    "allreduce", "reduce", "broadcast", "allgather", "reducescatter",
    "send", "recv", "barrier",
})

# Human-readable busbw wire-factor formulas per op, mirroring
# observability/comms.py _BUSBW (asserted equal by the devtools tests).
WIRE_FORMULAS: Dict[str, str] = {
    "allreduce": "2*(n-1)/n", "psum": "2*(n-1)/n",
    "allgather": "(n-1)/n", "all_gather": "(n-1)/n",
    "reducescatter": "(n-1)/n", "all_to_all": "(n-1)/n",
}


def wire_factor(op: str, n: int) -> float:
    """Numeric busbw factor for *op* over an *n*-member group — the same
    ring formulas ``comms._BUSBW`` applies to the runtime ledger."""
    if op in ("allreduce", "psum"):
        return 2.0 * (n - 1) / n if n else 1.0
    if op in ("allgather", "all_gather", "reducescatter", "all_to_all"):
        return (n - 1) / n if n else 1.0
    return 1.0


def format_spec(parts: Sequence[Any]) -> str:
    """Render abstract spec parts back as spec-tuple source text."""
    def one(p: Any) -> str:
        if p is None:
            return "None"
        if isinstance(p, list):
            return "(" + ", ".join(repr(x) for x in p) + ")"
        if p == UNKNOWN:
            return "?"
        return repr(p)
    inner = ", ".join(one(p) for p in parts)
    return "(" + inner + ("," if len(parts) == 1 else "") + ")"


def _format_placement(val: List[Any]) -> str:
    """``["spec", parts]`` or ``["pl", names]`` as source text."""
    kind, parts = val
    if kind == "spec":
        return f"spec {format_spec(parts)}"
    return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"


def _dotted(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return base + "." + node.attr if base else None
    if isinstance(node, ast.Name):
        return node.id
    return None


def _const_str_tuple(node: ast.AST) -> Optional[List[str]]:
    """A tuple/list literal of string constants, or a single string."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        out: List[str] = []
        for elt in node.elts:
            if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                out.append(elt.value)
            else:
                return None
        return out
    return None


def _strip_trailing_none(parts: List[Any]) -> List[Any]:
    out = list(parts)
    while out and out[-1] is None:
        out.pop()
    return out


def _fully_known(parts: Sequence[Any]) -> bool:
    return all(p != UNKNOWN for p in parts)


def _placements_equal(a: List[Any], b: List[Any]) -> bool:
    """Equality of two fully-known placements of one kind; a spec ignores
    trailing ``None`` (unnamed trailing dims replicate either way)."""
    if a[0] == "spec":
        return _strip_trailing_none(a[1]) == _strip_trailing_none(b[1])
    return a[1] == b[1]


class _Scope:
    """One lexical scope's constant environment, chained to its parent."""

    def __init__(self, parent: Optional["_Scope"] = None):
        self.parent = parent
        self.consts: Dict[str, Any] = {}      # name -> str constant
        self.specs: Dict[str, Any] = {}       # name -> spec parts
        self.shardings: Dict[str, Any] = {}   # name -> placement value
        self.groups: Dict[str, Any] = {}      # name -> mesh axis of a group
        self.producers: Dict[str, Tuple[int, List[Any]]] = {}  # var -> (line, placement)
        self.consumers: Dict[str, Tuple[str, List[Any]]] = {}  # var -> (kind, in_placements)
        self.defs: Dict[str, List[Tuple[int, int]]] = {}       # name -> [(min, max)]

    def _lookup(self, attr: str, name: str) -> Any:
        s: Optional[_Scope] = self
        while s is not None:
            d = getattr(s, attr)
            if name in d:
                return d[name]
            s = s.parent
        return None

    def const(self, name: str) -> Any:
        return self._lookup("consts", name)

    def spec_of(self, name: str) -> Any:
        return self._lookup("specs", name)

    def sharding_of(self, name: str) -> Any:
        return self._lookup("shardings", name)

    def group_of(self, name: str) -> Any:
        return self._lookup("groups", name)

    def consumer_of(self, name: str) -> Any:
        return self._lookup("consumers", name)

    def arities_of(self, name: str) -> Any:
        return self._lookup("defs", name)


class _FileScanner:
    """Single-pass fact extraction for one parsed file."""

    def __init__(self, ctx: Any):
        self.ctx = ctx
        self.origin: Dict[str, str] = getattr(ctx, "import_origin", {})
        self.facts: Dict[str, Any] = {
            "rules": {},            # table name -> sorted logical keys
            "override_names": [],   # kwarg names seen at with_overrides()
            "axis_order": [],       # tuples assigned to *AXIS_ORDER* names
            "mesh_ctors": [],       # dim names from DeviceMesh(...) literals
            "dynamic_mesh": False,  # a mesh with unresolvable dim names
            "dynamic_rules": False,  # a rules table we cannot enumerate
            "axis_sites": [],       # [line, axis, kind]
            "dup_sites": [],        # [line, axis]
            "arity_sites": [],      # [line, got, want, callee]
            "logical_sites": [],    # [line, name, src]
            "reshard_sites": [],    # [line, argpos, got, want, callee]
            "collective_sites": [],  # [line, op, group]
            "mesh_op_sites": [],    # [line, op, axis]
        }

    # -- name resolution ----------------------------------------------------

    def _resolved(self, dn: Optional[str]) -> str:
        """*dn* with its head resolved through the file's imports."""
        if not dn:
            return ""
        head, _, rest = dn.partition(".")
        org = self.origin.get(head)
        if org:
            return org + ("." + rest if rest else "")
        return dn

    def _is_torch(self, dn: Optional[str], leaf: str) -> bool:
        """*dn* ends in *leaf* and plausibly resolves into torch."""
        if not dn or dn.split(".")[-1] != leaf:
            return False
        return self._resolved(dn).startswith("torch.")

    def _is_pkg(self, dn: Optional[str], leaf: str, sub: str) -> bool:
        """*dn* ends in *leaf* and resolves into this package's *sub*
        subpackage (``parallel``, ``collective``)."""
        if not dn or dn.split(".")[-1] != leaf:
            return False
        full = self._resolved(dn)
        return full.startswith(PKG + ".") and f".{sub}" in full

    # -- entry ------------------------------------------------------------

    def run(self) -> Dict[str, Any]:
        tree = self.ctx.tree
        self._module_pass(tree)
        root = _Scope()
        self._scan_block(tree.body, root, in_logical_fn=False)
        f = self.facts
        f["override_names"] = sorted(set(f["override_names"]))
        f["mesh_ctors"] = sorted(set(f["mesh_ctors"]))
        return f

    # -- module-level tables ----------------------------------------------

    def _module_pass(self, tree: ast.Module) -> None:
        for node in tree.body:
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            tgt = node.targets[0]
            if not isinstance(tgt, ast.Name):
                continue
            name = tgt.id
            if name.endswith("RULES") and isinstance(node.value, ast.Dict):
                table = self._rules_table(node.value)
                if table is None:
                    self.facts["dynamic_rules"] = True
                else:
                    self.facts["rules"][name] = sorted(table)
            if "AXIS_ORDER" in name:
                axes = _const_str_tuple(node.value)
                if axes:
                    self.facts["axis_order"].append(axes)

    def _rules_table(self, node: ast.Dict) -> Optional[List[str]]:
        """Logical keys of a rules-table dict literal; None if dynamic.
        Mesh-axis *values* are recorded as checkable axis sites."""
        keys: List[str] = []
        for k, v in zip(node.keys, node.values):
            if k is None:  # **spread
                return None
            if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
                return None
            keys.append(k.value)
            axes = _const_str_tuple(v)
            if axes:
                for ax in axes:
                    self.facts["axis_sites"].append(
                        [v.lineno, ax, "rules-table"])
        return keys

    # -- scope machinery ---------------------------------------------------

    def _scan_block(self, stmts: List[ast.stmt], scope: _Scope,
                    in_logical_fn: bool) -> None:
        self._prepass(stmts, scope)
        for stmt in stmts:
            self._visit_stmt(stmt, scope, in_logical_fn)

    def _prepass(self, stmts: List[ast.stmt], scope: _Scope) -> None:
        """Collect single-assignment locals usable as constants: strings,
        spec tuples, placements, mesh-axis groups, local_map consumers,
        DTensor producers, and def/lambda arities."""
        counts: Dict[str, int] = {}
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scope.defs.setdefault(stmt.name, []).append(
                    _arity_range(stmt.args))
                continue
            if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
                continue
            tgt = stmt.targets[0]
            if not isinstance(tgt, ast.Name):
                continue
            name, val = tgt.id, stmt.value
            counts[name] = counts.get(name, 0) + 1
            if counts[name] > 1:
                # reassigned: drop every interpretation except lambdas,
                # which accumulate (branch-dependent bodies are all real)
                for d in (scope.consts, scope.specs, scope.shardings,
                          scope.groups, scope.producers, scope.consumers):
                    d.pop(name, None)
            if isinstance(val, ast.Constant) and isinstance(val.value, str):
                if counts[name] == 1:
                    scope.consts[name] = val.value
            elif isinstance(val, ast.Lambda):
                scope.defs.setdefault(name, []).append(_arity_range(val.args))
            elif counts[name] > 1:
                continue
            elif isinstance(val, (ast.Tuple, ast.List)):
                parts = self._spec_literal(val, scope)
                if parts is not None:
                    scope.specs[name] = parts
                pl = self._placement_literal(val)
                if pl is not None:
                    scope.shardings[name] = pl
            elif isinstance(val, ast.Call):
                pl = self._placements_call(val, scope)
                if pl is not None:
                    scope.shardings[name] = pl
                    continue
                axis = self._group_axis(val, scope)
                if axis is not None:
                    scope.groups[name] = axis
                    continue
                prod = self._producer(val, scope)
                if prod is not None:
                    scope.producers[name] = (stmt.lineno, prod)
                    continue
                cons = self._consumer(val, scope)
                if cons is not None:
                    scope.consumers[name] = cons

    def _visit_stmt(self, stmt: ast.stmt, scope: _Scope,
                    in_logical_fn: bool) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in stmt.decorator_list:
                self._visit_expr(dec, scope, in_logical_fn)
            child = _Scope(scope)
            logical = in_logical_fn or "logical_axes" in stmt.name
            self._scan_block(stmt.body, child, logical)
            return
        if isinstance(stmt, ast.ClassDef):
            for dec in stmt.decorator_list:
                self._visit_expr(dec, scope, in_logical_fn)
            # class body shares the enclosing constant env read-only
            self._scan_block(stmt.body, _Scope(scope), in_logical_fn)
            return
        for node in ast.iter_child_nodes(stmt):
            if isinstance(node, ast.expr):
                self._visit_expr(node, scope, in_logical_fn)
            elif isinstance(node, ast.stmt):
                self._visit_stmt(node, scope, in_logical_fn)
            elif isinstance(node, (ast.excepthandler, ast.withitem,
                                   ast.match_case)):
                for sub in ast.iter_child_nodes(node):
                    if isinstance(sub, ast.expr):
                        self._visit_expr(sub, scope, in_logical_fn)
                    elif isinstance(sub, ast.stmt):
                        self._visit_stmt(sub, scope, in_logical_fn)

    def _visit_expr(self, node: ast.AST, scope: _Scope,
                    in_logical_fn: bool) -> None:
        if isinstance(node, ast.Lambda):
            child = _Scope(scope)
            self._visit_expr(node.body, child, in_logical_fn)
            return
        if isinstance(node, ast.Call):
            self._handle_call(node, scope)
        if in_logical_fn and isinstance(node, (ast.Tuple, ast.List)):
            names = self._logical_tuple(node)
            if names is not None:
                for nm in names:
                    self.facts["logical_sites"].append(
                        [node.lineno, nm, "logical-axes"])
                return  # elements consumed; nothing nested to visit
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._visit_expr(child, scope, in_logical_fn)
            elif isinstance(child, (ast.comprehension, ast.keyword,
                                    ast.Starred)):
                for sub in ast.iter_child_nodes(child):
                    if isinstance(sub, ast.expr):
                        self._visit_expr(sub, scope, in_logical_fn)

    # -- detectors ---------------------------------------------------------

    def _handle_call(self, node: ast.Call, scope: _Scope) -> None:
        dn = _dotted(node.func)
        leaf = dn.split(".")[-1] if dn else ""
        if leaf == "spec_to_placements" and self._is_pkg(
                dn, leaf, "parallel"):
            self._record_spec(node, scope)
        elif leaf in ("DeviceMesh", "init_device_mesh") and \
                self._is_torch(dn, leaf):
            self._record_mesh(node)
        elif leaf == "local_map" and self._is_torch(dn, leaf):
            self._record_local_map(node, scope)
        elif leaf in AXIS_COLLECTIVES and self._is_pkg(dn, leaf,
                                                       "parallel"):
            self._record_axis_op(node, leaf, scope)
        elif leaf in DIST_OPS and self._is_torch(dn, leaf) and \
                self._resolved(dn).startswith("torch.distributed."):
            self._record_dist_op(node, DIST_OPS[leaf], scope)
        elif leaf in EXPLICIT_OPS and self._is_pkg(dn, leaf, "collective"):
            self._record_explicit(node, leaf)
        elif leaf == "with_overrides":
            self._record_overrides(node)
        elif leaf in ("spec", "cleaned_spec", "sharding") and \
                self._is_rules_recv(node):
            self._record_logical_call(node, leaf)
        elif leaf == "shard_pytree":
            self._record_axes_tree(node)
        elif leaf == "ShardingRules":
            self._record_rules_ctor(node)
        # R28: call through a known local_map consumer
        if isinstance(node.func, ast.Name):
            cons = scope.consumer_of(node.func.id)
            if cons is not None:
                self._check_reshard(node, node.func.id, cons, scope)

    # spec tuples ----------------------------------------------------------

    def _part_value(self, node: ast.AST, scope: Optional[_Scope]) -> Any:
        if isinstance(node, ast.Constant):
            if node.value is None:
                return None
            if isinstance(node.value, str):
                return node.value
            return UNKNOWN
        if isinstance(node, (ast.Tuple, ast.List)):
            vals = _const_str_tuple(node)
            return list(vals) if vals is not None else UNKNOWN
        if isinstance(node, ast.Name) and scope is not None:
            c = scope.const(node.id)
            if c is not None:
                return c
        return UNKNOWN

    def _spec_literal(self, node: ast.AST,
                      scope: Optional[_Scope]) -> Optional[List[Any]]:
        """Abstract parts of a spec tuple literal (str / None / tuple of
        str per tensor dim), else None."""
        if not isinstance(node, (ast.Tuple, ast.List)):
            return None
        parts: List[Any] = []
        for elt in node.elts:
            if isinstance(elt, ast.Starred):
                parts.append(UNKNOWN)
            elif isinstance(elt, ast.Constant) and (
                    elt.value is None or isinstance(elt.value, str)):
                parts.append(elt.value)
            elif isinstance(elt, (ast.Tuple, ast.List)) or \
                    isinstance(elt, ast.Name):
                parts.append(self._part_value(elt, scope))
            else:
                return None
        return parts

    def _spec_arg(self, node: ast.Call) -> Optional[ast.AST]:
        arg = node.args[1] if len(node.args) >= 2 else None
        for kw in node.keywords:
            if kw.arg == "spec":
                arg = kw.value
        return arg

    def _resolve_spec(self, node: Optional[ast.AST],
                      scope: _Scope) -> Optional[List[Any]]:
        if node is None:
            return None
        parts = self._spec_literal(node, scope)
        if parts is None and isinstance(node, ast.Name):
            parts = scope.spec_of(node.id)
        return parts

    def _record_spec(self, node: ast.Call, scope: _Scope) -> None:
        parts = self._resolve_spec(self._spec_arg(node), scope)
        if parts is None:
            return
        used: List[str] = []
        for p in parts:
            axes = p if isinstance(p, list) else ([p] if isinstance(p, str)
                                                  else [])
            for ax in axes:
                if ax == UNKNOWN:
                    continue
                self.facts["axis_sites"].append([node.lineno, ax, "spec"])
                if ax in used:
                    self.facts["dup_sites"].append([node.lineno, ax])
                used.append(ax)

    # placements -----------------------------------------------------------

    def _placement_literal(self, node: ast.AST) -> Optional[List[Any]]:
        """``["pl", [...]]`` for a tuple/list of ``Shard(<int>)`` /
        ``Replicate()`` / ``Partial()`` calls, else None."""
        if not isinstance(node, (ast.Tuple, ast.List)) or not node.elts:
            return None
        out: List[str] = []
        for elt in node.elts:
            if not isinstance(elt, ast.Call):
                return None
            dn = _dotted(elt.func)
            leaf = dn.split(".")[-1] if dn else ""
            if leaf not in ("Shard", "Replicate", "Partial") or \
                    not self._is_torch(dn, leaf):
                return None
            if leaf == "Shard":
                if len(elt.args) != 1 or not isinstance(
                        elt.args[0], ast.Constant) or not isinstance(
                        elt.args[0].value, int):
                    out.append(UNKNOWN)
                    continue
                out.append(f"Shard({elt.args[0].value})")
            else:
                out.append(f"{leaf}()")
        return ["pl", out]

    def _placements_call(self, node: ast.Call,
                         scope: _Scope) -> Optional[List[Any]]:
        """``["spec", parts]`` for ``spec_to_placements(mesh, spec)``."""
        dn = _dotted(node.func)
        if not self._is_pkg(dn, "spec_to_placements", "parallel"):
            return None
        parts = self._resolve_spec(self._spec_arg(node), scope)
        return ["spec", parts] if parts is not None else None

    def _placement_value(self, node: Optional[ast.AST],
                         scope: _Scope) -> Any:
        """A placements expression as ``["spec"|"pl", ...]``, ``None``
        for a literal None (a non-DTensor argument), else UNKNOWN."""
        if node is None:
            return UNKNOWN
        if isinstance(node, ast.Constant) and node.value is None:
            return None
        if isinstance(node, ast.Call):
            val = self._placements_call(node, scope)
            return val if val is not None else UNKNOWN
        if isinstance(node, ast.Name):
            val = scope.sharding_of(node.id)
            return val if val is not None else UNKNOWN
        val = self._placement_literal(node)
        return val if val is not None else UNKNOWN

    def _producer(self, node: ast.Call, scope: _Scope) -> Optional[Any]:
        """The placement of ``x = distribute_tensor(t, mesh, pl)`` /
        ``DTensor.from_local(t, mesh, pl)`` / ``from_local(t, mesh, pl)`` /
        ``y.redistribute(mesh, pl)``: the producer side of R28."""
        dn = _dotted(node.func)
        leaf = dn.split(".")[-1] if dn else ""
        if leaf == "distribute_tensor" and self._is_torch(dn, leaf):
            pos = 2
        elif leaf == "from_local" and (
                self._is_torch(dn, leaf) or self._is_pkg(dn, leaf,
                                                         "parallel")):
            pos = 2
        elif leaf == "redistribute" and isinstance(node.func,
                                                   ast.Attribute):
            pos = 1
        else:
            return None
        arg = node.args[pos] if len(node.args) > pos else None
        for kw in node.keywords:
            if kw.arg == "placements":
                arg = kw.value
        val = self._placement_value(arg, scope)
        if not isinstance(val, list) or not _fully_known(val[1]):
            return None
        return val

    # DeviceMesh -------------------------------------------------------------

    def _record_mesh(self, node: ast.Call) -> None:
        axes_node: Optional[ast.AST] = None
        for kw in node.keywords:
            if kw.arg == "mesh_dim_names":
                axes_node = kw.value
            elif kw.arg is None:
                self.facts["dynamic_mesh"] = True  # **kwargs may name dims
                return
        if axes_node is None:
            return  # no named dims: nothing can name an axis of it
        if isinstance(axes_node, ast.Constant) and axes_node.value is None:
            return
        axes = _const_str_tuple(axes_node)
        if axes is None and isinstance(axes_node, ast.Name) and \
                "AXIS_ORDER" in axes_node.id and self.facts["axis_order"]:
            # e.g. DeviceMesh(..., mesh_dim_names=AXIS_ORDER)
            axes = self.facts["axis_order"][0]
        if axes is None:
            self.facts["dynamic_mesh"] = True
        else:
            self.facts["mesh_ctors"].extend(axes)

    # local_map ----------------------------------------------------------------

    def _in_placements(self, node: ast.Call,
                       scope: _Scope) -> Optional[List[Any]]:
        """One placement value per positional argument of a local_map's
        ``in_placements``; None when the shape itself is unresolvable."""
        arg = node.args[2] if len(node.args) >= 3 else None
        for kw in node.keywords:
            if kw.arg == "in_placements":
                arg = kw.value
        if not isinstance(arg, (ast.Tuple, ast.List)):
            return None
        out: List[Any] = []
        for elt in arg.elts:
            if isinstance(elt, ast.Starred):
                return None
            out.append(self._placement_value(elt, scope))
        return out

    def _record_local_map(self, node: ast.Call, scope: _Scope) -> None:
        in_pl = self._in_placements(node, scope)
        if in_pl is None or not node.args:
            return
        callee = node.args[0]
        callee_name = _dotted(callee) or "<fn>"
        arities: List[Tuple[int, int]] = []
        if isinstance(callee, ast.Lambda):
            arities = [_arity_range(callee.args)]
            callee_name = "<lambda>"
        elif isinstance(callee, ast.Name):
            found = scope.arities_of(callee.id)
            if found:
                arities = list(found)
        got = len(in_pl)
        if arities and not any(lo <= got <= hi for lo, hi in arities):
            lo, hi = arities[0]
            want = str(lo) if lo == hi else f"{lo}..{hi}"
            self.facts["arity_sites"].append(
                [node.lineno, got, want, callee_name])

    def _consumer(self, node: ast.Call,
                  scope: _Scope) -> Optional[Tuple[str, List[Any]]]:
        """``in_placements`` of a ``local_map(..., redistribute_inputs=
        True)`` assigned to a local — the consumer side of R28.  Without
        ``redistribute_inputs=True`` a mismatched input raises instead of
        being resharded, so nothing is silent."""
        dn = _dotted(node.func)
        if not self._is_torch(dn, "local_map"):
            return None
        redistributes = any(
            kw.arg == "redistribute_inputs" and
            isinstance(kw.value, ast.Constant) and kw.value.value is True
            for kw in node.keywords)
        if not redistributes:
            return None
        in_pl = self._in_placements(node, scope)
        return ("local_map", in_pl) if in_pl is not None else None

    def _check_reshard(self, node: ast.Call, fname: str,
                       cons: Tuple[str, List[Any]], scope: _Scope) -> None:
        _kind, in_pl = cons
        for i, arg in enumerate(node.args):
            if i >= len(in_pl):
                break
            if not isinstance(arg, ast.Name):
                continue
            prod = scope._lookup("producers", arg.id)
            if prod is None:
                continue
            _line, got = prod
            want = in_pl[i]
            if not isinstance(want, list) or want[0] != got[0]:
                continue
            if not (_fully_known(got[1]) and _fully_known(want[1])):
                continue
            if not _placements_equal(got, want):
                self.facts["reshard_sites"].append(
                    [node.lineno, i, _format_placement(got),
                     _format_placement(want), fname])

    # collectives (R29) -----------------------------------------------------

    def _axis_value(self, node: Optional[ast.AST], scope: _Scope) -> Any:
        if node is None:
            return UNKNOWN
        axis = self._part_value(node, scope)
        if isinstance(axis, list):  # several axes: any one str is fine
            axis = axis[0] if len(axis) == 1 else UNKNOWN
        return UNKNOWN if axis is None else axis

    def _record_axis_op(self, node: ast.Call, op: str,
                        scope: _Scope) -> None:
        axis_node: Optional[ast.AST] = node.args[2] if len(node.args) >= 3 \
            else None
        for kw in node.keywords:
            if kw.arg == "axis":
                axis_node = kw.value
        self.facts["mesh_op_sites"].append(
            [node.lineno, op, self._axis_value(axis_node, scope)])

    def _group_axis(self, node: ast.AST, scope: _Scope) -> Any:
        """The mesh axis of ``mesh.group("ax")`` /
        ``device_mesh.get_group("ax")`` (or a local bound to one); None
        when *node* is no such expression."""
        if isinstance(node, ast.Name):
            return scope.group_of(node.id)
        if not isinstance(node, ast.Call) or \
                not isinstance(node.func, ast.Attribute) or \
                node.func.attr not in ("group", "get_group"):
            return None
        arg = node.args[0] if node.args else None
        for kw in node.keywords:
            if kw.arg in ("mesh_dim", "axis"):
                arg = kw.value
        return self._axis_value(arg, scope)

    def _record_dist_op(self, node: ast.Call, op: str,
                        scope: _Scope) -> None:
        axis: Any = UNKNOWN
        for kw in node.keywords:
            if kw.arg == "group":
                found = self._group_axis(kw.value, scope)
                if found is not None:
                    axis = found
        self.facts["mesh_op_sites"].append([node.lineno, op, axis])

    def _record_explicit(self, node: ast.Call, op: str) -> None:
        group: Any = None
        dynamic = False
        for kw in node.keywords:
            if kw.arg == "group_name":
                if isinstance(kw.value, ast.Constant) and \
                        isinstance(kw.value.value, str):
                    group = kw.value.value
                else:
                    dynamic = True
            elif kw.arg is None:
                dynamic = True  # **kwargs may carry group_name
        if group is None:
            for arg in node.args[1:]:
                if isinstance(arg, ast.Constant) and \
                        isinstance(arg.value, str):
                    group = arg.value
                    break
                if not isinstance(arg, ast.Constant):
                    dynamic = True
        if group is None:
            group = "*" if dynamic else "default"
        self.facts["collective_sites"].append([node.lineno, op, group])

    # logical-axis uses (R27d) ----------------------------------------------

    def _record_overrides(self, node: ast.Call) -> None:
        for kw in node.keywords:
            if kw.arg is None:
                self.facts["dynamic_rules"] = True
                continue
            self.facts["override_names"].append(kw.arg)
            axes = _const_str_tuple(kw.value)
            if axes:
                for ax in axes:
                    self.facts["axis_sites"].append(
                        [kw.value.lineno, ax, "override"])

    def _is_rules_recv(self, node: ast.Call) -> bool:
        if not isinstance(node.func, ast.Attribute):
            return False
        recv = _dotted(node.func.value)
        return bool(recv) and "rules" in recv.split(".")[-1].lower()

    def _record_logical_call(self, node: ast.Call, leaf: str) -> None:
        # rules.spec(axes) / rules.cleaned_spec(mesh, axes) /
        # rules.sharding(mesh, axes)
        idx = 0 if leaf == "spec" else 1
        arg = node.args[idx] if len(node.args) > idx else None
        for kw in node.keywords:
            if kw.arg == "logical_axes":
                arg = kw.value
        if arg is None or not isinstance(arg, (ast.Tuple, ast.List)):
            return
        names = self._logical_tuple(arg)
        if names is None:
            return
        for nm in names:
            self.facts["logical_sites"].append([arg.lineno, nm, "spec-call"])

    def _logical_tuple(self, node: ast.AST) -> Optional[List[str]]:
        """Tuple/list literal of logical names: str and None elements only,
        at least one str."""
        if not isinstance(node, (ast.Tuple, ast.List)) or not node.elts:
            return None
        out: List[str] = []
        for elt in node.elts:
            if not isinstance(elt, ast.Constant):
                return None
            if isinstance(elt.value, str):
                out.append(elt.value)
            elif elt.value is not None:
                return None
        return out if out else None

    def _record_axes_tree(self, node: ast.Call) -> None:
        axes = node.args[1] if len(node.args) >= 2 else None
        for kw in node.keywords:
            if kw.arg == "axes_tree":
                axes = kw.value
        if not isinstance(axes, ast.Dict):
            return
        for v in axes.values:
            names = self._logical_tuple(v)
            if names:
                for nm in names:
                    self.facts["logical_sites"].append(
                        [v.lineno, nm, "axes-tree"])

    def _record_rules_ctor(self, node: ast.Call) -> None:
        for arg in node.args:
            if isinstance(arg, ast.Dict):
                table = self._rules_table(arg)
                if table is None:
                    self.facts["dynamic_rules"] = True
                else:
                    self.facts["rules"].setdefault(
                        f"<ctor:{node.lineno}>", sorted(table))
            else:
                self.facts["dynamic_rules"] = True
        for kw in node.keywords:
            if kw.arg == "rules" and isinstance(kw.value, ast.Dict):
                table = self._rules_table(kw.value)
                if table is None:
                    self.facts["dynamic_rules"] = True
                else:
                    self.facts["rules"].setdefault(
                        f"<ctor:{node.lineno}>", sorted(table))
            elif kw.arg is not None and not isinstance(kw.value, ast.Dict):
                # other dataclass fields (none today) — stay conservative
                self.facts["dynamic_rules"] = True


def _arity_range(args: ast.arguments) -> Tuple[int, int]:
    n = len(args.posonlyargs) + len(args.args)
    lo = n - len(args.defaults)
    hi = 10 ** 6 if args.vararg is not None else n
    return (lo, hi)


def file_shard_facts(ctx: Any) -> Dict[str, Any]:
    """Pure, JSON-able SPMD facts for one file — the cacheable unit."""
    return _FileScanner(ctx).run()


class ShardModel:
    """Whole-tree join of per-file shard facts.

    ``cached`` maps relpath -> previously computed facts (content-hash
    validated by the caller); files present there skip re-extraction and
    count toward ``hits`` for the ``raylint-cache: ... shard S/T`` line.
    """

    def __init__(self, ctxs: Sequence[Any],
                 cached: Optional[Dict[str, dict]] = None):
        cached = cached or {}
        self.facts: Dict[str, Dict[str, Any]] = {}
        self.hits = 0
        for ctx in ctxs:
            f = cached.get(ctx.relpath)
            if f is not None:
                self.hits += 1
            else:
                f = file_shard_facts(ctx)
            self.facts[ctx.relpath] = f
        self.mesh_axes: set = set()
        self.logical_names: set = set()
        self._open_mesh = False
        self._open_rules = False
        for f in self.facts.values():
            for order in f["axis_order"]:
                self.mesh_axes.update(order)
            self.mesh_axes.update(f["mesh_ctors"])
            self._open_mesh = self._open_mesh or f["dynamic_mesh"]
            for keys in f["rules"].values():
                self.logical_names.update(keys)
            self.logical_names.update(f["override_names"])
            self._open_rules = self._open_rules or f["dynamic_rules"]

    def mesh_closed(self) -> bool:
        """True when the mesh-axis universe is known exactly — only then
        may axis-membership checks fire (under-approximation stance)."""
        return bool(self.mesh_axes) and not self._open_mesh

    def rules_closed(self) -> bool:
        return bool(self.logical_names) and not self._open_rules


def build_manifest(model: ShardModel) -> Dict[str, Any]:
    """The static collective-cost plan: every resolvable collective site,
    keyed by runtime ledger group (explicit ops) or ``axis:<mesh-axis>``
    (``parallel.spmd`` and ``torch.distributed`` collectives over a mesh
    axis), with its busbw wire-factor formula.  ``unresolved_sites``
    counts the sites whose axis or group degraded to top — the plan never
    claims to cover them."""
    groups: Dict[str, Dict[str, Any]] = {}
    unresolved = 0

    def ent(group: str, op: str) -> Dict[str, Any]:
        return groups.setdefault(group, {}).setdefault(
            op, {"sites": [], "wire_formula": WIRE_FORMULAS.get(op, "1")})

    for rel in sorted(model.facts):
        f = model.facts[rel]
        for line, op, group in f["collective_sites"]:
            ent(group, op)["sites"].append([rel, int(line)])
        for line, op, axis in f["mesh_op_sites"]:
            if axis == UNKNOWN:
                unresolved += 1
                continue
            if model.mesh_closed() and axis not in model.mesh_axes:
                continue  # an R29 finding, not a plan entry
            ent("axis:" + axis, op)["sites"].append([rel, int(line)])
    return {"version": 1, "tool": "raylint/R29",
            "mesh_axes": sorted(model.mesh_axes),
            "unresolved_sites": unresolved, "groups": groups}
