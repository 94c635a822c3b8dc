"""Concurrency lint: AST + call-graph static analyzer for the runtime's
threading model, in the same table-driven spirit as ``check_metrics.py``.

This is ``ray_tpu``'s analyzer aimed at ``ray_tpu_torch/``: the tables
it mirrors are the port's own ``ray_tpu_torch/DESIGN.md`` (lock
hierarchy, shared-state ownership map) and the README's "Configuration"
table, where knobs only the port has go in the README's port section.

Reference analogue: the TSan/deadlock-annotation coverage the C++ core
gets from sanitizer CI builds (PAPER.md §1 layers 0-1); a Python runtime
gets the equivalent from this pass plus the opt-in runtime sanitizer
(``_private/locksan.py``, ``RTPU_LOCKSAN=1``).

Rules (each has a golden-fixture test in tests/test_concurrency_lint.py):

(a) **Declared locks only.** Every ``threading.Lock/RLock/Condition``
    construction under ray_tpu_torch/ must go through the ``locksan`` factory
    with a literal name that exists in ``locksan.REGISTRY`` AND in the
    DESIGN.md "Threading model & lock hierarchy" table; registry rows
    without a construction site are stale; names/modules/levels must
    agree across all three.

(b) **No lock-order inversion.** Per-function acquired-lock sets come
    from ``with <lock>:`` blocks; a call made while holding L
    contributes L -> M edges for every lock M the (transitively
    resolved) callee may acquire. Cycles in the acquisition-order graph
    and downhill edges (level(M) <= level(L)) are findings. Re-entry of
    a declared rlock is exempt; re-entry of a plain lock is a
    self-deadlock finding. (Explicit ``acquire()`` protocols — the
    transport's combining drainer — are covered at runtime by locksan,
    not here.)

(c) **No blocking calls under a lock.** Inside a ``with <lock>:`` body
    (lexically): ``Connection.send*/flush/kick``, request/reply RPCs,
    ``time.sleep``, socket ops, ``Future.result``/``join``, bare
    ``get()`` where the module imports the runtime's get, ``.remote()``
    submissions, ``subprocess.run``, and ``.wait()`` on anything other
    than the held lock's own condition. Escape hatch: a trailing
    ``# lint: allow-under-lock(<reason>)`` on the call line — counted
    and reported; an empty reason is a finding.

(d) **Reader-thread discipline.** Handlers reachable from the
    connection-reader dispatch tables (``NodeService._handle_direct``
    for ``_DIRECT_OPS``, ``CoreClient.handle_message``,
    ``RpcChannel._dispatch_one``, ``WorkerRuntime.run``) must not call
    functions marked ``# concurrency: dispatcher-only``, must not block
    (``result``/``join``/``sleep``), and must not make synchronous GCS
    RPCs (methods absent from ``RemoteControlPlane._CASTS``). Escape
    hatch: ``# lint: allow-on-reader(<reason>)`` on a call line stops
    traversal through that edge.

(e) **Protocol-op consistency.** Every op constant in ``protocol.py``
    needs at least one encoder (send site) and one handler (dispatch
    comparison), and every statically-visible payload tuple arity must
    agree across send sites and handler unpacks (the class of bug where
    an EXECUTE 4-tuple grows a field and one site is missed). Escape
    hatch: ``# lint: allow-op(<reason>)`` on the constant's line.

(f) **Config-knob registry.** Every ``_CONFIG_DEFS`` knob must have a
    README "Configuration" row whose env column is exactly
    ``RTPU_<NAME>``; stale/duplicate rows and ``CONFIG.<typo>`` reads
    of undefined knobs are findings.

(g) **Failpoint-site registry.** Every ``failpoints.fp(<site>)`` call
    must name a literal site registered in ``failpoints._SITES`` (a
    typo'd site silently never fires), and every registered site must
    have at least one planted call site (a stale row documents chaos
    coverage that doesn't exist).

(h) **Guarded-by field ownership** (``locksan.FIELDS`` — the data-side
    complement of the lock registry; reference: Clang ``GUARDED_BY``).
    Sub-checks: every declared guard is a REGISTRY lock (or a
    non-empty ``thread:``/``atomic:`` declaration); every declared
    field exists and its class carries ``@fieldsan.guarded`` (modules:
    a ``fieldsan.instrument_module`` call) so the runtime sanitizer
    actually sees it; every AST **write** to a lock-guarded field sits
    lexically under ``with <guard>`` — or inside a function annotated
    ``# concurrency: requires(<guard>)`` (Clang REQUIRES equivalent;
    call sites of such functions must themselves hold the guard) — or
    in ``__init__``, or carries a counted ``# lint: race-ok(<reason>)``
    waiver; the DESIGN.md "Shared-state ownership map" table mirrors
    FIELDS both directions; and an **inference pass** flags undeclared
    candidates — attributes assigned in ``__init__`` and mutated in
    functions reachable from two different thread entry points
    (reader roots + ``threading.Thread(target=...)`` functions,
    reusing rule (d)'s resolution) — so the registry can't rot as the
    code grows.

Wired into tier-1 (``tests/test_concurrency_lint.py``); standalone:
``python -m ray_tpu_torch.scripts.check_concurrency`` (also via ``rtpt lint``).
"""

from __future__ import annotations

import ast
import os
import re
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

# ------------------------------------------------------------- constants

_LOCK_CTORS = ("Lock", "RLock", "Condition")
_FACTORY_FNS = ("lock", "rlock", "condition")

_WAIVER_UNDER_LOCK = re.compile(r"#\s*lint:\s*allow-under-lock\(([^)]*)\)")
_WAIVER_ON_READER = re.compile(r"#\s*lint:\s*allow-on-reader\(([^)]*)\)")
_WAIVER_OP = re.compile(r"#\s*lint:\s*allow-op\(([^)]*)\)")
_WAIVER_RACE_OK = re.compile(r"#\s*lint:\s*race-ok\(([^)]*)\)")
_DISPATCHER_ONLY = re.compile(r"#\s*concurrency:\s*dispatcher-only")
_REQUIRES = re.compile(r"#\s*concurrency:\s*requires\(([a-z0-9_.]+)\)")

# container methods that mutate their receiver (rule (h): a call
# ``self.<field>.append(...)`` is a write to <field>)
_MUTATOR_METHODS = frozenset({
    "append", "appendleft", "add", "pop", "popleft", "popitem",
    "remove", "discard", "update", "extend", "extendleft", "clear",
    "insert", "setdefault", "sort", "reverse", "rotate", "move_to_end",
    "difference_update", "intersection_update",
    "symmetric_difference_update",
})

# the guarded-by plane's target modules: FIELDS declarations
# and the undeclared-candidate inference are scoped to these stems
_FIELD_MODULES = ("node", "gcs", "client", "worker", "protocol",
                  "coll_transport", "telemetry", "scheduler",
                  "object_store", "history")

_OWNERSHIP_HEADING = "## Shared-state ownership map"

# Attribute-call names that block (or can block) the calling thread.
# ``wait`` is special-cased: allowed on the held lock's own condition.
_BLOCKING_ATTRS = frozenset({
    "send", "send_many", "sendall", "sendmsg", "recv", "recv_many",
    "recv_into", "connect", "accept", "flush", "kick",
    "request", "request_async", "_request", "_send", "result", "join",
    "remote", "sleep",
})
# blocking names when the receiver is the subprocess module
_SUBPROCESS_BLOCKING = frozenset({"run", "check_call", "check_output",
                                  "communicate"})
# receivers whose .flush()/.write() are console output, not transport
_CONSOLE_RECEIVERS = frozenset({"stdout", "stderr"})

# reader-thread roots: (file rel path, class, function). The dispatch
# tables these implement: node._DIRECT_OPS (answered inline on node
# reader threads), the worker main recv loop, the client reader loop's
# push handler, and RpcChannel's reply/push dispatch.
_READER_ROOTS = (
    ("_private/node.py", "NodeService", "_handle_direct"),
    ("_private/worker.py", "WorkerRuntime", "run"),
    ("_private/client.py", "CoreClient", "handle_message"),
    ("_private/rpc.py", "RpcChannel", "_dispatch_one"),
)

# blocking names on reader threads (sends are allowed there — replies
# leave on the arrival conn; parking the reader is what's forbidden)
_READER_BLOCKING = frozenset({"result", "join", "sleep"})

# attr names too generic to resolve by package-wide uniqueness (they
# collide with builtin container/executor methods)
_RESOLVE_DENYLIST = frozenset({
    "append", "add", "pop", "get", "put", "clear", "remove", "discard",
    "update", "extend", "close", "send", "items", "keys", "values",
    "join", "start", "result", "copy", "read", "write", "flush", "open",
    "acquire", "release", "sort", "count", "index", "insert", "popleft",
    "popitem", "setdefault", "submit", "wait", "run", "load", "loads",
    "dumps", "dump", "encode", "decode", "hex", "empty", "set", "kill",
    "poll", "cancel", "stop", "free", "name", "exists", "create",
})

_DESIGN_HEADING = "## Threading model & lock hierarchy"
_CONFIG_HEADING = "## Configuration"
_PORT_HEADING = "## PyTorch/CUDA port"

# the package under analysis, and where its design tables live
_PKG = "ray_tpu_torch"


def _design_path(root: str) -> str:
    return os.path.join(root, _PKG, "DESIGN.md")


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _walk_files(pkg_dir: str):
    """[(rel, tree, source_lines)] for every parseable .py under pkg."""
    out = []
    for dirpath, _dirs, files in os.walk(pkg_dir):
        if "__pycache__" in dirpath:
            continue
        for fname in sorted(files):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            try:
                with open(path) as f:
                    src = f.read()
                tree = ast.parse(src, filename=path)
            except (SyntaxError, OSError):
                continue
            out.append((os.path.relpath(path, pkg_dir), tree,
                        src.splitlines()))
    return out


def _line(lines: List[str], lineno: int) -> str:
    return lines[lineno - 1] if 0 < lineno <= len(lines) else ""


# ===================================================== registry / rule (a)

def parse_locksan_registry(files) -> Dict[str, tuple]:
    """locksan.REGISTRY parsed from source (name -> (module, kind,
    level, protects)) — the analyzer never imports the runtime."""
    for rel, tree, _lines in files:
        if not rel.endswith("locksan.py"):
            continue
        for node in ast.walk(tree):
            tgt = val = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt, val = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign):
                tgt, val = node.target, node.value
            if (isinstance(tgt, ast.Name) and tgt.id == "REGISTRY"
                    and val is not None):
                try:
                    return ast.literal_eval(val)
                except (ValueError, SyntaxError):
                    return {}
    return {}


def parse_fields_registry(files) -> Dict[str, str]:
    """locksan.FIELDS parsed from source (field key -> guard spec) —
    like the lock registry, never imported."""
    for rel, tree, _lines in files:
        if not rel.endswith("locksan.py"):
            continue
        for node in ast.walk(tree):
            tgt = val = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt, val = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign):
                tgt, val = node.target, node.value
            if (isinstance(tgt, ast.Name) and tgt.id == "FIELDS"
                    and val is not None):
                try:
                    return ast.literal_eval(val)
                except (ValueError, SyntaxError):
                    return {}
    return {}


_DESIGN_ROW_RE = re.compile(
    r"^\|\s*`([a-z0-9_.]+)`\s*\|\s*`([^`]+)`\s*\|\s*(\d+)\s*\|"
    r"\s*(\w+)\s*\|", re.MULTILINE)

_OWNERSHIP_ROW_RE = re.compile(
    r"^\|\s*`([A-Za-z0-9_.]+)`\s*\|\s*`([^`]+)`\s*\|\s*([^|]*)\|",
    re.MULTILINE)


def parse_design_ownership_table(design_path: str) -> List[Tuple[str,
                                                                 str, str]]:
    """(field, guard, writers) rows of the DESIGN.md "Shared-state
    ownership map" table."""
    try:
        with open(design_path) as f:
            text = f.read()
    except OSError:
        return []
    start = text.find(_OWNERSHIP_HEADING)
    if start < 0:
        return []
    body = text[start + len(_OWNERSHIP_HEADING):]
    end = re.search(r"\n## ", body)
    if end:
        body = body[:end.start()]
    return [(f, g, w.strip()) for f, g, w in
            _OWNERSHIP_ROW_RE.findall(body)
            if f != "Field"]


def parse_design_lock_table(design_path: str) -> List[Tuple[str, str,
                                                            int, str]]:
    """(name, module, level, kind) rows of the DESIGN.md lock table."""
    try:
        with open(design_path) as f:
            text = f.read()
    except OSError:
        return []
    start = text.find(_DESIGN_HEADING)
    if start < 0:
        return []
    body = text[start + len(_DESIGN_HEADING):]
    end = re.search(r"\n## ", body)
    if end:
        body = body[:end.start()]
    return [(n, m, int(lv), k)
            for n, m, lv, k in _DESIGN_ROW_RE.findall(body)]


@dataclass
class LockSite:
    name: str
    rel: str
    lineno: int
    kind: str                       # lock | rlock | condition
    cv_lock_var: Optional[str]      # condition's shared-lock var name


def collect_lock_sites(files):
    """Returns (raw_sites, factory_sites, bindings).

    raw_sites: [(rel, lineno, ctor)] of direct threading constructions.
    factory_sites: [LockSite] of locksan factory calls.
    bindings: (rel, class_or_None, varname) -> lock name, for resolving
    ``with <expr>:`` items. ``self._x``/``cls._x`` resolve through the
    class key; module globals through the None key.
    """
    raw: List[tuple] = []
    sites: List[LockSite] = []
    bindings: Dict[tuple, str] = {}

    def scan(node, rel, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                scan(child, rel, child.name)
                continue
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scan(child, rel, cls)
                continue
            for sub in ast.walk(child):
                if not isinstance(sub, ast.Call):
                    continue
                fn = sub.func
                if (isinstance(fn, ast.Attribute)
                        and isinstance(fn.value, ast.Name)
                        and fn.value.id == "threading"
                        and fn.attr in _LOCK_CTORS
                        and not rel.endswith("locksan.py")):
                    raw.append((rel, sub.lineno, fn.attr))
                if (isinstance(fn, ast.Attribute)
                        and isinstance(fn.value, ast.Name)
                        and fn.value.id == "locksan"
                        and fn.attr in _FACTORY_FNS):
                    name = (sub.args[0].value
                            if sub.args and isinstance(sub.args[0],
                                                       ast.Constant)
                            and isinstance(sub.args[0].value, str)
                            else None)
                    cv = None
                    if fn.attr == "condition" and len(sub.args) > 1 \
                            and isinstance(sub.args[1], ast.Name):
                        cv = sub.args[1].id
                    sites.append(LockSite(name or "<dynamic>", rel,
                                          sub.lineno, fn.attr, cv))
                    if name is None:
                        continue
                    # bind the assignment target, if this call is one
                    parent = child
                    for stmt in ast.walk(parent):
                        if (isinstance(stmt, ast.Assign)
                                and stmt.value is sub
                                and len(stmt.targets) == 1):
                            tgt = stmt.targets[0]
                            if isinstance(tgt, ast.Name):
                                # module-level Name assigns bind at
                                # (rel, None, var); class-body assigns
                                # at (rel, cls, var)
                                bindings[(rel, cls, tgt.id)] = name
                            elif (isinstance(tgt, ast.Attribute)
                                  and isinstance(tgt.value, ast.Name)
                                  and tgt.value.id in ("self", "cls")):
                                bindings[(rel, cls, tgt.attr)] = name
        return

    for rel, tree, _lines in files:
        scan(tree, rel, None)
    return raw, sites, bindings


# ==================================================== module/function model

@dataclass
class CallSite:
    lineno: int
    func_name: str                      # attr or bare name
    recv: Tuple[str, ...]               # receiver name chain, outermost last
    held: Tuple[str, ...]               # lock names held lexically
    callee: Optional[tuple] = None      # resolved (rel, cls, name)
    waived_under_lock: Optional[str] = None
    waived_on_reader: Optional[str] = None
    waived_race_ok: Optional[str] = None
    bare: bool = False                  # Name call (not attribute)


@dataclass
class FieldWrite:
    """One AST write to an attribute/global (rule (h))."""

    name: str                           # attr (self-scope) or global name
    lineno: int
    held: Tuple[str, ...]               # lock names held lexically
    scope: str                          # "self" | "global"
    waiver: Optional[str] = None        # race-ok reason (None = none)


@dataclass
class FuncInfo:
    key: tuple                          # (rel, cls_or_None, name)
    lineno: int
    n_params: Tuple[int, int] = (0, 0)  # (required, total) after self
    dispatcher_only: bool = False
    requires: Optional[str] = None      # declared caller-holds lock
    is_async: bool = False              # coroutine: a call site only
                                        # creates it, never runs it
    with_locks: List[tuple] = field(default_factory=list)
    # [(lockname, lineno, outer_held_names)]
    calls: List[CallSite] = field(default_factory=list)
    writes: List[FieldWrite] = field(default_factory=list)
    thread_targets: List[tuple] = field(default_factory=list)
    # [(recv_chain_or_name, lineno)] of threading.Thread(target=...)


def _recv_chain(node) -> Tuple[str, ...]:
    out = []
    cur = node
    while isinstance(cur, ast.Attribute):
        out.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        out.append(cur.id)
    return tuple(reversed(out))         # e.g. ("self", "gcs", "kv_get")


class _Analyzer:
    def __init__(self, repo_root: str):
        self.root = repo_root
        self.pkg = os.path.join(repo_root, _PKG)
        self.files = _walk_files(self.pkg)
        self.lines = {rel: lines for rel, _t, lines in self.files}
        self.registry = parse_locksan_registry(self.files)
        self.fields = parse_fields_registry(self.files)
        (self.raw_sites, self.factory_sites,
         self.bindings) = collect_lock_sites(self.files)
        # rule (h) structural indexes
        self.guarded_classes: Set[tuple] = set()   # (rel, cls) decorated
        self.instrumented_mods: Set[str] = set()   # instrument_module args
        self.class_lines: Dict[tuple, int] = {}    # (rel, cls) -> lineno
        self.funcs: Dict[tuple, FuncInfo] = {}
        self.method_index: Dict[str, List[tuple]] = {}
        self.module_rels = {self._mod_of(rel): rel
                            for rel, _t, _l in self.files}
        self.aliases: Dict[str, Dict[str, str]] = {}  # rel -> alias -> rel
        self.from_funcs: Dict[str, Dict[str, tuple]] = {}
        self.imports_pkg_get: Set[str] = set()
        self.gcs_casts: Set[str] = set()
        self.waivers: List[tuple] = []   # (kind, rel, lineno, reason)
        self._index()

    # ------------------------------------------------------------- indexing
    @staticmethod
    def _mod_of(rel: str) -> str:
        mod = rel[:-3].replace(os.sep, ".")
        if mod.endswith(".__init__"):
            mod = mod[:-len(".__init__")]
        return mod

    def _resolve_module(self, rel: str, level: int,
                        module: Optional[str], name: str) -> Optional[str]:
        """rel path of the module an ImportFrom binds ``name`` to, or
        None when it binds a function/class instead of a module."""
        base = self._mod_of(rel).split(".")
        if rel.endswith("__init__.py"):
            base = base + ["__init__"]
        if level:
            base = base[:-level]
        parts = base + (module.split(".") if module else [])
        as_mod = ".".join(parts + [name])
        if as_mod in self.module_rels:
            return self.module_rels[as_mod]
        return None

    def _index(self):
        for rel, tree, lines in self.files:
            alias_map: Dict[str, str] = {}
            from_map: Dict[str, tuple] = {}
            for node in ast.walk(tree):
                if isinstance(node, ast.ImportFrom):
                    for a in node.names:
                        bound = a.asname or a.name
                        target = self._resolve_module(
                            rel, node.level, node.module, a.name)
                        if target is not None:
                            alias_map[bound] = target
                        else:
                            # from .mod import fn  /  from .. import get
                            src_mod = ".".join(
                                x for x in [self._parent_pkg(rel,
                                                             node.level),
                                            node.module] if x)
                            src_rel = self.module_rels.get(src_mod)
                            if src_rel is not None:
                                from_map[bound] = (src_rel, a.name)
                            if a.name == "get" and node.module is None:
                                self.imports_pkg_get.add(rel)
            self.aliases[rel] = alias_map
            self.from_funcs[rel] = from_map
            self._index_funcs(rel, tree, lines)
        # gcs cast methods (fire-and-forget: allowed on reader threads)
        for rel, tree, _lines in self.files:
            if not rel.endswith("gcs_service.py"):
                continue
            for node in ast.walk(tree):
                if (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and node.targets[0].id == "_CASTS"):
                    for sub in ast.walk(node.value):
                        if (isinstance(sub, ast.Constant)
                                and isinstance(sub.value, str)):
                            self.gcs_casts.add(sub.value)

    def _parent_pkg(self, rel: str, level: int) -> str:
        base = self._mod_of(rel).split(".")
        if rel.endswith("__init__.py"):
            base = base + ["__init__"]
        return ".".join(base[:-level]) if level else ".".join(base[:-1])

    def _index_funcs(self, rel, tree, lines):
        # fieldsan structural evidence: decorated classes and
        # instrument_module(<globals>, "<mod>") calls in this file
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "instrument_module"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "fieldsan"
                    and len(node.args) >= 2
                    and isinstance(node.args[1], ast.Constant)):
                self.instrumented_mods.add(node.args[1].value)

        def visit(node, cls):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    self.class_lines[(rel, child.name)] = child.lineno
                    for deco in child.decorator_list:
                        if ((isinstance(deco, ast.Attribute)
                             and deco.attr == "guarded"
                             and isinstance(deco.value, ast.Name)
                             and deco.value.id == "fieldsan")
                                or (isinstance(deco, ast.Name)
                                    and deco.id == "guarded")):
                            self.guarded_classes.add((rel, child.name))
                    visit(child, child.name)
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    key = (rel, cls, child.name)
                    fi = FuncInfo(key=key, lineno=child.lineno,
                                  is_async=isinstance(
                                      child, ast.AsyncFunctionDef))
                    args = child.args
                    names = [a.arg for a in args.args]
                    if cls and names and names[0] in ("self", "cls"):
                        names = names[1:]
                    total = len(names)
                    fi.n_params = (total - len(args.defaults), total)
                    head = _line(lines, child.lineno)
                    above = _line(lines, child.lineno - 1)
                    deco_top = _line(lines, min(
                        (d.lineno for d in child.decorator_list),
                        default=child.lineno) - 1)
                    if (_DISPATCHER_ONLY.search(head)
                            or _DISPATCHER_ONLY.search(above)
                            or _DISPATCHER_ONLY.search(deco_top)):
                        fi.dispatcher_only = True
                    for src_line in (head, above, deco_top):
                        m = _REQUIRES.search(src_line)
                        if m:
                            fi.requires = m.group(1)
                            break
                    self._scan_body(fi, child, rel, cls, lines)
                    self.funcs[key] = fi
                    self.method_index.setdefault(child.name,
                                                 []).append(key)
        visit(tree, None)

    def _lock_of_expr(self, expr, rel, cls) -> Optional[str]:
        if isinstance(expr, ast.Name):
            return (self.bindings.get((rel, None, expr.id))
                    or self.bindings.get((rel, cls, expr.id)))
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id in ("self", "cls")):
            hit = self.bindings.get((rel, cls, expr.attr))
            if hit is not None:
                return hit
            # fall back: unique attr binding anywhere in this file
            cands = {v for (r, _c, a), v in self.bindings.items()
                     if r == rel and a == expr.attr}
            if len(cands) == 1:
                return cands.pop()
        return None

    def _scan_body(self, fi: FuncInfo, func_node, rel, cls, lines):
        held: List[str] = []
        # names this function declares `global`: a whole-name rebind of
        # one of them is a module-field write (and, at runtime, would
        # replace a fieldsan proxy — rule (h) must see it)
        global_names: Set[str] = set()
        for sub in ast.walk(func_node):
            if isinstance(sub, ast.Global):
                global_names.update(sub.names)

        def note_write(target, lineno):
            """Record a store through ``target`` when it hits a
            ``self.<attr>`` / module-global field shape (rule (h))."""
            if isinstance(target, (ast.Tuple, ast.List)):
                for elt in target.elts:
                    note_write(elt, lineno)
                return
            name = scope = None
            if isinstance(target, ast.Starred):
                target = target.value
            if (isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id in ("self", "cls")):
                name, scope = target.attr, "self"
            elif (isinstance(target, ast.Name)
                  and target.id in global_names):
                name, scope = target.id, "global"
            elif isinstance(target, ast.Subscript):
                base = target.value
                if (isinstance(base, ast.Attribute)
                        and isinstance(base.value, ast.Name)
                        and base.value.id in ("self", "cls")):
                    name, scope = base.attr, "self"
                elif isinstance(base, ast.Name):
                    name, scope = base.id, "global"
            if name is None:
                return
            src = _line(lines, lineno)
            m = _WAIVER_RACE_OK.search(src)
            fi.writes.append(FieldWrite(
                name=name, lineno=lineno, held=tuple(held), scope=scope,
                waiver=m.group(1).strip() if m else None))
            if m:
                self.waivers.append(("race-ok", rel, lineno,
                                     m.group(1).strip()))

        def walk(node):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                return                      # separate scope/thread
            if isinstance(node, (ast.Assign, ast.AugAssign,
                                 ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for tgt in targets:
                    note_write(tgt, node.lineno)
                for child in ast.iter_child_nodes(node):
                    walk(child)
                return
            if isinstance(node, ast.Delete):
                for tgt in node.targets:
                    note_write(tgt, node.lineno)
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                pushed = 0
                for item in node.items:
                    lock = self._lock_of_expr(item.context_expr, rel, cls)
                    if lock is None:
                        walk(item.context_expr)
                    else:
                        fi.with_locks.append((lock, item.context_expr
                                              .lineno, tuple(held)))
                        held.append(lock)
                        pushed += 1
                for stmt in node.body:
                    walk(stmt)
                for _ in range(pushed):
                    held.pop()
                return
            if isinstance(node, ast.Call):
                fn = node.func
                name = recv = None
                bare = False
                if isinstance(fn, ast.Attribute):
                    name = fn.attr
                    recv = _recv_chain(fn.value)
                elif isinstance(fn, ast.Name):
                    name = fn.id
                    recv = ()
                    bare = True
                if name is not None:
                    src = _line(lines, node.lineno)
                    m_u = _WAIVER_UNDER_LOCK.search(src)
                    m_r = _WAIVER_ON_READER.search(src)
                    m_k = _WAIVER_RACE_OK.search(src)
                    cs = CallSite(
                        lineno=node.lineno, func_name=name,
                        recv=recv or (), held=tuple(held), bare=bare,
                        waived_under_lock=(m_u.group(1).strip()
                                           if m_u else None),
                        waived_on_reader=(m_r.group(1).strip()
                                          if m_r else None),
                        waived_race_ok=(m_k.group(1).strip()
                                        if m_k else None))
                    fi.calls.append(cs)
                    if m_u:
                        self.waivers.append(("allow-under-lock", rel,
                                             node.lineno,
                                             cs.waived_under_lock))
                    if m_r:
                        self.waivers.append(("allow-on-reader", rel,
                                             node.lineno,
                                             cs.waived_on_reader))
                    if m_k:
                        self.waivers.append(("race-ok", rel,
                                             node.lineno,
                                             cs.waived_race_ok))
                    # container-mutator calls are writes to the field
                    if name in _MUTATOR_METHODS and recv:
                        if len(recv) == 2 and recv[0] in ("self", "cls"):
                            fi.writes.append(FieldWrite(
                                name=recv[1], lineno=node.lineno,
                                held=tuple(held), scope="self",
                                waiver=cs.waived_race_ok))
                        elif len(recv) == 1:
                            fi.writes.append(FieldWrite(
                                name=recv[0], lineno=node.lineno,
                                held=tuple(held), scope="global",
                                waiver=cs.waived_race_ok))
                    # thread entry points (rule (h) inference roots)
                    if name == "Thread":
                        for kw in node.keywords:
                            if kw.arg == "target":
                                fi.thread_targets.append(
                                    (_recv_chain(kw.value)
                                     if isinstance(kw.value,
                                                   (ast.Attribute,
                                                    ast.Name))
                                     else (), node.lineno))
            for child in ast.iter_child_nodes(node):
                walk(child)

        for stmt in func_node.body:
            walk(stmt)

    # ---------------------------------------------------------- resolution
    def resolve_call(self, rel: str, cls: Optional[str],
                     cs: CallSite) -> Optional[tuple]:
        if cs.bare:
            key = (rel, None, cs.func_name)
            if key in self.funcs:
                return key
            hit = self.from_funcs.get(rel, {}).get(cs.func_name)
            if hit is not None:
                key = (hit[0], None, hit[1])
                return key if key in self.funcs else None
            return None
        recv = cs.recv
        if recv and recv[0] in ("self", "cls") and len(recv) == 1:
            key = (rel, cls, cs.func_name)
            if key in self.funcs:
                return key
        if len(recv) == 1 and recv[0] in self.aliases.get(rel, {}):
            key = (self.aliases[rel][recv[0]], None, cs.func_name)
            return key if key in self.funcs else None
        # package-wide unique method name (skipping collision-prone ones)
        if cs.func_name in _RESOLVE_DENYLIST:
            return None
        cands = self.method_index.get(cs.func_name, ())
        if len(cands) == 1:
            return cands[0]
        return None

    def resolve_all(self) -> None:
        for (rel, cls, _name), fi in self.funcs.items():
            for cs in fi.calls:
                cs.callee = self.resolve_call(rel, cls, cs)

    # ------------------------------------------------------- rule (b) graph
    def may_acquire(self) -> Dict[tuple, Set[str]]:
        may = {k: {w[0] for w in fi.with_locks}
               for k, fi in self.funcs.items()}
        changed = True
        while changed:
            changed = False
            for k, fi in self.funcs.items():
                cur = may[k]
                for cs in fi.calls:
                    if cs.callee is None or cs.waived_under_lock:
                        continue
                    callee_fi = self.funcs.get(cs.callee)
                    if callee_fi is not None and callee_fi.is_async:
                        continue    # a call only creates the coroutine
                    extra = may.get(cs.callee, ())
                    if not cur.issuperset(extra):
                        cur.update(extra)
                        changed = True
        return may

    def order_edges(self, may) -> Dict[tuple, tuple]:
        """(held_lock, acquired_lock) -> example (rel, lineno, via)."""
        edges: Dict[tuple, tuple] = {}
        for (rel, _cls, _name), fi in self.funcs.items():
            for lock, lineno, outer in fi.with_locks:
                for h in outer:
                    edges.setdefault((h, lock), (rel, lineno, None))
            for cs in fi.calls:
                if (cs.callee is None or not cs.held
                        or cs.waived_under_lock):
                    continue
                for m in may.get(cs.callee, ()):
                    for h in cs.held:
                        edges.setdefault(
                            (h, m), (rel, cs.lineno,
                                     "via %s" % (cs.callee[2],)))
        return edges


# ============================================================ rule checks

def _check_registry(an: _Analyzer, design_path: str) -> List[str]:
    problems: List[str] = []
    reg = an.registry
    if not reg:
        problems.append("locksan.REGISTRY not found/parseable — the "
                        "lock-registry scanner is broken")
        return problems
    for rel, lineno, ctor in an.raw_sites:
        problems.append(
            f"{rel}:{lineno}: raw threading.{ctor}() construction — "
            "runtime locks must go through locksan.lock/rlock/"
            "condition(<declared name>)")
    by_name: Dict[str, List[LockSite]] = {}
    for s in an.factory_sites:
        by_name.setdefault(s.name, []).append(s)
    for name, sites in sorted(by_name.items()):
        if name == "<dynamic>":
            for s in sites:
                problems.append(
                    f"{s.rel}:{s.lineno}: locksan factory called with a "
                    "non-literal name — the registry lint can't see it")
            continue
        if name not in reg:
            for s in sites:
                problems.append(
                    f"{s.rel}:{s.lineno}: lock name {name!r} is not "
                    "declared in locksan.REGISTRY")
            continue
        mod, kind, _level = reg[name][0], reg[name][1], reg[name][2]
        for s in sites:
            if s.rel.replace(os.sep, "/") != mod:
                problems.append(
                    f"{s.rel}:{s.lineno}: lock {name!r} declared for "
                    f"module {mod} but constructed here")
        kinds = {s.kind for s in sites}
        if len(sites) > 1:
            # one lock + one condition sharing it is the only legal
            # duplicate (the condition names the same registry entry)
            cond = [s for s in sites if s.kind == "condition"]
            lk = [s for s in sites if s.kind != "condition"]
            ok = (len(cond) == 1 and len(lk) == 1
                  and cond[0].cv_lock_var is not None)
            if not ok:
                problems.append(
                    f"lock name {name!r}: constructed at "
                    f"{len(sites)} sites — one construction site per "
                    "declared lock (condition-over-lock pairs exempt)")
        site_kind = ("condition" if "condition" in kinds
                     else sites[0].kind)
        if site_kind != kind:
            problems.append(
                f"lock {name!r}: registry declares kind {kind} but the "
                f"construction site uses {site_kind}")
    for name in sorted(set(reg) - set(by_name)):
        problems.append(
            f"lock {name!r}: declared in locksan.REGISTRY but never "
            "constructed — stale registry row")
    # levels must be unique (the hierarchy is a total order)
    seen_lv: Dict[int, str] = {}
    for name, row in sorted(reg.items()):
        lv = row[2]
        if lv in seen_lv:
            problems.append(
                f"locks {seen_lv[lv]!r} and {name!r} share level {lv} — "
                "levels must be distinct (the hierarchy is total)")
        else:
            seen_lv[lv] = name
    # DESIGN.md table must mirror the registry
    rows = parse_design_lock_table(design_path)
    if not rows:
        problems.append(
            "DESIGN.md has no 'Threading model & lock hierarchy' table "
            "— the declared hierarchy must be documented")
        return problems
    doc = {n: (m, lv, k) for n, m, lv, k in rows}
    if len(doc) != len(rows):
        problems.append("DESIGN.md lock table has duplicate rows")
    for name, row in sorted(reg.items()):
        d = doc.get(name)
        if d is None:
            problems.append(
                f"lock {name!r}: in locksan.REGISTRY but missing from "
                "the DESIGN.md lock-hierarchy table")
        elif (d[0], d[1], d[2]) != (row[0], row[2], row[1]):
            problems.append(
                f"lock {name!r}: DESIGN.md row (module={d[0]}, "
                f"level={d[1]}, kind={d[2]}) disagrees with "
                f"locksan.REGISTRY (module={row[0]}, level={row[2]}, "
                f"kind={row[1]})")
    for name in sorted(set(doc) - set(reg)):
        problems.append(
            f"lock {name!r}: documented in DESIGN.md but absent from "
            "locksan.REGISTRY — stale doc row")
    return problems


def _check_order(an: _Analyzer) -> List[str]:
    problems: List[str] = []
    reg = an.registry
    may = an.may_acquire()
    edges = an.order_edges(may)
    kind_of = {n: row[1] for n, row in reg.items()}
    level_of = {n: row[2] for n, row in reg.items()}
    adj: Dict[str, Set[str]] = {}
    for (a, b), (rel, lineno, via) in sorted(edges.items()):
        if a == b:
            if kind_of.get(a) != "rlock":
                problems.append(
                    f"{rel}:{lineno}: lock {a!r} re-acquired while held "
                    f"({via or 'nested with'}) — it is not an rlock: "
                    "guaranteed self-deadlock")
            continue
        adj.setdefault(a, set()).add(b)
        la, lb = level_of.get(a), level_of.get(b)
        if la is not None and lb is not None and lb <= la:
            problems.append(
                f"{rel}:{lineno}: acquires {b!r} (level {lb}) while "
                f"holding {a!r} (level {la}){' ' + via if via else ''} "
                "— violates the declared strictly-increasing hierarchy")
    # cycle scan (covers edges among unregistered/test locks too)
    state: Dict[str, int] = {}
    stack: List[str] = []

    def dfs(n: str) -> Optional[List[str]]:
        state[n] = 1
        stack.append(n)
        for m in sorted(adj.get(n, ())):
            if state.get(m, 0) == 1:
                return stack[stack.index(m):] + [m]
            if state.get(m, 0) == 0:
                cyc = dfs(m)
                if cyc:
                    return cyc
        stack.pop()
        state[n] = 2
        return None

    for n in sorted(adj):
        if state.get(n, 0) == 0:
            cyc = dfs(n)
            if cyc:
                problems.append(
                    "lock-order cycle: " + " -> ".join(cyc)
                    + " — deadlock-capable inversion")
                break
    return problems


def _is_blocking_call(an: _Analyzer, rel: str, cs: CallSite,
                      cond_ok: bool) -> Optional[str]:
    """Reason string if this call blocks, else None. ``cond_ok``: a
    ``wait`` on the held lock's own condition variable is legal."""
    name = cs.func_name
    recv_last = cs.recv[-1] if cs.recv else ""
    if recv_last in _CONSOLE_RECEIVERS:
        return None
    if cs.bare:
        if name == "get" and rel in an.imports_pkg_get:
            return "blocking runtime get()"
        return None
    if name == "wait":
        if cond_ok:
            return None
        return ".wait() on a condition/event other than the held " \
               "lock's own"
    if name in _BLOCKING_ATTRS:
        if name == "sleep" and cs.recv and cs.recv[0] != "time":
            return None
        if name == "join" and not _is_thread_join(cs):
            return None
        return f"blocking .{name}()"
    if cs.recv and cs.recv[0] == "subprocess" \
            and name in _SUBPROCESS_BLOCKING:
        return f"subprocess.{name}() under a lock"
    if len(cs.recv) >= 2 and cs.recv[-1] in ("gcs", "_gcs", "plane") \
            and name not in an.gcs_casts:
        return f"synchronous GCS RPC .{name}() (not in _CASTS)"
    return None


def _is_thread_join(cs: CallSite) -> bool:
    """``.join()`` blocks only on threads/processes; ``os.path.join``
    and ``str.join`` (the overwhelming uses) are pure. Judge by the
    receiver name."""
    if not cs.recv:
        return False                    # "".join / f-string receivers
    last = cs.recv[-1]
    if last == "path":
        return False                    # os.path.join
    return (last in ("t", "th", "thread", "proc", "process", "worker")
            or last.endswith("thread") or last.endswith("proc"))


def _check_blocking_under_lock(an: _Analyzer) -> List[str]:
    problems: List[str] = []
    for (rel, cls, _name), fi in sorted(
            an.funcs.items(), key=lambda kv: (kv[0][0], kv[0][1] or "",
                                              kv[0][2])):
        # condition names aliased to held locks: wait on the held
        # lock's own condition is the condvar protocol, not a foreign
        # blocking wait
        for cs in fi.calls:
            if not cs.held:
                continue
            if cs.waived_under_lock is not None:
                if not cs.waived_under_lock:
                    problems.append(
                        f"{rel}:{cs.lineno}: allow-under-lock waiver "
                        "with an empty reason")
                continue
            cond_ok = False
            if cs.func_name == "wait" and cs.recv:
                wait_lock = an._lock_of_expr(
                    ast.Name(id=cs.recv[-1]), rel, cls) \
                    if len(cs.recv) == 1 else None
                if len(cs.recv) == 2 and cs.recv[0] in ("self", "cls"):
                    wait_lock = an.bindings.get((rel, cls, cs.recv[1]))
                cond_ok = wait_lock is not None and wait_lock in cs.held
            reason = _is_blocking_call(an, rel, cs, cond_ok)
            if reason:
                problems.append(
                    f"{rel}:{cs.lineno}: {reason} while holding "
                    f"{'/'.join(cs.held)!s} — move it outside the lock "
                    "or waive with # lint: allow-under-lock(reason)")
    return problems


def _check_reader_discipline(an: _Analyzer) -> List[str]:
    problems: List[str] = []
    roots = []
    for rel, cls, name in _READER_ROOTS:
        key = (rel.replace("/", os.sep), cls, name)
        if key in an.funcs:
            roots.append(key)
        else:
            problems.append(
                f"reader root {cls}.{name} not found in {rel} — the "
                "reader-discipline scanner is broken")
    seen: Dict[tuple, tuple] = {}
    frontier = [(r, (r,)) for r in roots]
    while frontier:
        key, path = frontier.pop()
        fi = an.funcs.get(key)
        if fi is None:
            continue
        for cs in fi.calls:
            if cs.waived_on_reader is not None:
                if not cs.waived_on_reader:
                    problems.append(
                        f"{key[0]}:{cs.lineno}: allow-on-reader waiver "
                        "with an empty reason")
                continue
            pretty = " -> ".join(k[2] for k in path)
            if cs.callee is not None:
                callee_fi = an.funcs.get(cs.callee)
                if callee_fi is not None and callee_fi.is_async:
                    continue    # runs on the asyncio loop, not here
                if callee_fi is not None and callee_fi.dispatcher_only:
                    problems.append(
                        f"{key[0]}:{cs.lineno}: reader-thread path "
                        f"[{pretty}] calls dispatcher-only function "
                        f"{cs.callee[2]!r}")
                    continue
                if cs.callee not in seen:
                    seen[cs.callee] = path
                    frontier.append((cs.callee, path + (cs.callee,)))
            name = cs.func_name
            if (name in _READER_BLOCKING
                    and not (name == "sleep" and cs.recv
                             and cs.recv[0] != "time")
                    and not (name == "join"
                             and not _is_thread_join(cs))):
                problems.append(
                    f"{key[0]}:{cs.lineno}: reader-thread path "
                    f"[{pretty}] blocks in .{name}() — reader threads "
                    "must never park (waive with "
                    "# lint: allow-on-reader(reason))")
            if (len(cs.recv) >= 2
                    and cs.recv[-1] in ("gcs", "_gcs")
                    and name not in an.gcs_casts
                    and name not in _RESOLVE_DENYLIST):
                problems.append(
                    f"{key[0]}:{cs.lineno}: reader-thread path "
                    f"[{pretty}] makes a synchronous GCS RPC "
                    f".{name}() (not in RemoteControlPlane._CASTS)")
    return problems


# ======================================================== rule (e): protocol

def _collect_protocol_ops(files) -> Dict[str, tuple]:
    """op name -> (value, lineno, waiver_reason_or_None)."""
    out: Dict[str, tuple] = {}
    for rel, tree, lines in files:
        if not rel.endswith("_private/protocol.py".replace("/", os.sep)) \
                and not rel.endswith("protocol.py"):
            continue
        for node in tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, int)):
                name = node.targets[0].id
                if (not name.isupper() or name.startswith("_")
                        or name.startswith("KIND_")):
                    continue
                src = _line(lines, node.lineno)
                m = _WAIVER_OP.search(src)
                out[name] = (node.value.value, node.lineno,
                             m.group(1).strip() if m else None)
        break
    return out


_SEND_FUNCS = frozenset({"send", "send_many", "send_lazy", "_send",
                         "_reply", "_reply_batched", "request",
                         "request_async", "_request", "_debug_fanout",
                         "_send_submission", "cast", "_cast"})


def _op_ref_name(node, op_names: Set[str], in_protocol: bool
                 ) -> Optional[str]:
    if (isinstance(node, ast.Attribute) and node.attr in op_names
            and isinstance(node.value, ast.Name)):
        return node.attr
    if in_protocol and isinstance(node, ast.Name) and node.id in op_names:
        return node.id
    return None


def _payload_arity(node) -> Optional[int]:
    if isinstance(node, ast.Tuple):
        return len(node.elts)
    if isinstance(node, ast.Lambda) and isinstance(node.body, ast.Tuple):
        return len(node.body.elts)
    return None


def check_protocol_ops(files, funcs: Dict[tuple, FuncInfo]) -> List[str]:
    ops = _collect_protocol_ops(files)
    if not ops:
        return ["no op constants found in protocol.py — the protocol "
                "scanner is broken"]
    op_names = set(ops)
    enc_arity: Dict[str, List[tuple]] = {n: [] for n in op_names}
    enc_any: Dict[str, List[tuple]] = {n: [] for n in op_names}
    handler: Dict[str, List[tuple]] = {n: [] for n in op_names}
    hnd_arity: Dict[str, List[tuple]] = {n: [] for n in op_names}

    # function param table for starred-call handler arities
    params: Dict[tuple, Tuple[int, int]] = {
        k: fi.n_params for k, fi in funcs.items()}
    by_name: Dict[str, List[tuple]] = {}
    for k in funcs:
        by_name.setdefault(k[2], []).append(k)

    for rel, tree, _lines in files:
        in_proto = rel.endswith("protocol.py")
        # Each op reference is classified exactly once, by priority:
        # handler context (inside any Compare / all-op container) >
        # strong encoder ((OP, payload) 2-tuple or send-func arg) >
        # weak encoder (any other read). Definition targets in
        # protocol.py are excluded entirely.
        claimed: Set[int] = set()

        def refs_in(node) -> List[tuple]:
            out = []
            for sub in ast.walk(node):
                r = _op_ref_name(sub, op_names, in_proto)
                if r is not None:
                    out.append((id(sub), r, sub.lineno))
            return out

        if in_proto:
            for node in tree.body:
                if isinstance(node, ast.Assign):
                    for tgt in node.targets:
                        for nid, _r, _ln in refs_in(tgt):
                            claimed.add(nid)
        # pass 1: handler contexts
        for node in ast.walk(tree):
            if isinstance(node, ast.Compare):
                for nid, r, ln in refs_in(node):
                    if nid not in claimed:
                        claimed.add(nid)
                        handler[r].append((rel, ln))
            elif isinstance(node, (ast.Tuple, ast.List, ast.Set)):
                elts = getattr(node, "elts", [])
                refs = [_op_ref_name(e, op_names, in_proto)
                        for e in elts]
                if elts and all(refs) and (len(elts) > 1
                                           or isinstance(node,
                                                         (ast.Set,))
                                           or len(elts) == 1):
                    # container whose members are ALL ops: a dispatch/
                    # membership/reply-ops table -> handler evidence
                    # (a 2-tuple (OP, payload) never matches: payload
                    # is not an op ref)
                    for e, r in zip(elts, refs):
                        if id(e) not in claimed:
                            claimed.add(id(e))
                            handler[r].append((rel, e.lineno))
        # pass 2: handler unpack arities (per op-comparing If branch)
        for node in ast.walk(tree):
            if not (isinstance(node, ast.If)
                    and isinstance(node.test, ast.Compare)):
                continue
            refs = [r for _nid, r, _ln in refs_in(node.test)]
            if not refs:
                continue
            arity = None
            for sub in node.body:
                for s in ast.walk(sub):
                    if (isinstance(s, ast.Assign)
                            and len(s.targets) == 1
                            and isinstance(s.targets[0], ast.Tuple)
                            and isinstance(s.value, ast.Name)):
                        n = len(s.targets[0].elts)
                        arity = (n, n)
                        break
                    if (isinstance(s, ast.Call) and any(
                            isinstance(a, ast.Starred)
                            for a in s.args)):
                        fn = s.func
                        fname = (fn.attr if isinstance(
                            fn, ast.Attribute) else
                            fn.id if isinstance(fn, ast.Name)
                            else None)
                        cands = by_name.get(fname or "", ())
                        if len(cands) == 1:
                            req, tot = params[cands[0]]
                            bound = sum(
                                1 for a in s.args
                                if not isinstance(a, ast.Starred))
                            arity = (max(0, req - bound), tot - bound)
                            break
                if arity:
                    break
            if arity:
                for r in refs:
                    hnd_arity[r].append((rel, node.lineno, arity))
        # pass 3: encoder contexts
        for node in ast.walk(tree):
            if isinstance(node, ast.Tuple) and len(node.elts) == 2:
                r0 = _op_ref_name(node.elts[0], op_names, in_proto)
                r1 = _op_ref_name(node.elts[1], op_names, in_proto)
                if r0 and not r1 and id(node.elts[0]) not in claimed:
                    claimed.add(id(node.elts[0]))
                    enc_any[r0].append((rel, node.lineno))
                    ar = _payload_arity(node.elts[1])
                    if ar is not None:
                        enc_arity[r0].append((rel, node.lineno, ar))
            elif isinstance(node, ast.Call):
                fn = node.func
                fname = (fn.attr if isinstance(fn, ast.Attribute)
                         else fn.id if isinstance(fn, ast.Name)
                         else None)
                if fname not in _SEND_FUNCS:
                    continue
                for i, a in enumerate(node.args):
                    r = _op_ref_name(a, op_names, in_proto)
                    if r and id(a) not in claimed:
                        claimed.add(id(a))
                        enc_any[r].append((rel, node.lineno))
                        if i + 1 < len(node.args):
                            ar = _payload_arity(node.args[i + 1])
                            if ar is not None:
                                enc_arity[r].append(
                                    (rel, node.lineno, ar))
                        break
        # pass 4: weak encoder evidence (anything unclaimed: an op
        # flowing through a variable/property into a send)
        for node in ast.walk(tree):
            r = _op_ref_name(node, op_names, in_proto)
            if r is not None and id(node) not in claimed:
                claimed.add(id(node))
                enc_any[r].append((rel, node.lineno))

    problems: List[str] = []
    for name in sorted(op_names):
        _value, lineno, waiver = ops[name]
        if waiver is not None:
            if not waiver:
                problems.append(
                    f"protocol.py:{lineno}: allow-op waiver on {name} "
                    "with an empty reason")
            continue
        if not handler[name] and not enc_any[name]:
            problems.append(
                f"protocol op {name}: dead — never sent and never "
                "handled (retire the constant or waive with "
                "# lint: allow-op(reason))")
            continue
        if not handler[name]:
            problems.append(
                f"protocol op {name}: no handler — nothing compares "
                "against it in any dispatch path")
        if not enc_any[name]:
            problems.append(
                f"protocol op {name}: handled but never sent — no "
                "encoder site constructs a frame with it")
        arities = {a for _r, _l, a in enc_arity[name]}
        if len(arities) > 1:
            sites = ", ".join(f"{r}:{ln}(arity {a})"
                              for r, ln, a in enc_arity[name])
            problems.append(
                f"protocol op {name}: send sites disagree on payload "
                f"tuple arity: {sites}")
        elif len(arities) == 1:
            (enc_n,) = arities
            for r, ln, (lo, hi) in hnd_arity[name]:
                if not (lo <= enc_n <= hi):
                    problems.append(
                        f"protocol op {name}: send sites use a "
                        f"{enc_n}-tuple payload but the handler at "
                        f"{r}:{ln} unpacks {lo}"
                        + (f"..{hi}" if hi != lo else "")
                        + " fields")
    return problems


# ========================================================= rule (f): config

def _config_knobs(files) -> Dict[str, int]:
    for rel, tree, _lines in files:
        if not rel.endswith("config.py"):
            continue
        for node in ast.walk(tree):
            tgt = val = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt, val = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign):
                tgt, val = node.target, node.value
            if (isinstance(tgt, ast.Name) and tgt.id == "_CONFIG_DEFS"
                    and isinstance(val, ast.Dict)):
                out = {}
                for k in val.keys:
                    if isinstance(k, ast.Constant) and isinstance(
                            k.value, str):
                        out[k.value] = k.lineno
                return out
    return {}


_CONFIG_ROW_RE = re.compile(
    r"^\|\s*`([a-z0-9_]+)`\s*\|\s*`(RTPU_[A-Z0-9_]+)`\s*\|",
    re.MULTILINE)


def check_config_registry(files, readme_path: str) -> List[str]:
    problems: List[str] = []
    knobs = _config_knobs(files)
    if not knobs:
        return ["no _CONFIG_DEFS found in config.py — the config "
                "scanner is broken"]
    try:
        with open(readme_path) as f:
            text = f.read()
    except OSError:
        text = ""
    start = text.find(_CONFIG_HEADING)
    if start < 0:
        return ["README.md has no '## Configuration' section — every "
                "CONFIG knob must be documented there"]
    body = text[start + len(_CONFIG_HEADING):]
    end = re.search(r"\n## ", body)
    if end:
        body = body[:end.start()]
    # knobs only the port has are documented in the port's section
    port = text.find(_PORT_HEADING)
    if port >= 0:
        port_body = text[port + len(_PORT_HEADING):]
        end = re.search(r"\n## ", port_body)
        body += port_body[:end.start()] if end else port_body
    rows = _CONFIG_ROW_RE.findall(body)
    seen: Set[str] = set()
    for knob, env in rows:
        if knob in seen:
            problems.append(
                f"config knob {knob!r}: duplicate README row")
        seen.add(knob)
        want = "RTPU_" + knob.upper()
        if env != want:
            problems.append(
                f"config knob {knob!r}: README env column says {env} "
                f"but the override is {want}")
        if knob not in knobs:
            problems.append(
                f"config knob {knob!r}: README row has no matching "
                "_CONFIG_DEFS entry — stale doc row")
    for knob in sorted(set(knobs) - seen):
        problems.append(
            f"config knob {knob!r} (config.py:{knobs[knob]}): not "
            "documented in the README 'Configuration' table")
    # CONFIG.<attr> reads must name real knobs (typo'd reads silently
    # AttributeError only when hit at runtime)
    meth = {"dump", "reload"}
    for rel, tree, _lines in files:
        for node in ast.walk(tree):
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "CONFIG"
                    and node.attr not in knobs
                    and node.attr not in meth
                    and not node.attr.startswith("_")):
                problems.append(
                    f"{rel}:{node.lineno}: CONFIG.{node.attr} is not a "
                    "defined knob in _CONFIG_DEFS")
    return problems


# ===================================================== rule (g): failpoints

def check_failpoint_registry(files) -> List[str]:
    """Failpoint sites are registry-linted like config knobs: fp() call
    sites and failpoints._SITES must agree both directions."""
    problems: List[str] = []
    sites: Optional[tuple] = None
    for rel, tree, _lines in files:
        if not rel.endswith("failpoints.py"):
            continue
        for node in ast.walk(tree):
            tgt = val = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt, val = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign):
                tgt, val = node.target, node.value
            if (isinstance(tgt, ast.Name) and tgt.id == "_SITES"
                    and val is not None):
                try:
                    sites = tuple(ast.literal_eval(val))
                except (ValueError, SyntaxError):
                    sites = None
        break
    if sites is None:
        return ["no _SITES tuple found in failpoints.py — the "
                "failpoint-registry scanner is broken"]
    planted: Dict[str, List[tuple]] = {}
    for rel, tree, _lines in files:
        if rel.endswith("failpoints.py"):
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if not (isinstance(fn, ast.Attribute) and fn.attr == "fp"
                    and isinstance(fn.value, ast.Name)
                    and fn.value.id == "failpoints"):
                continue
            if (not node.args
                    or not isinstance(node.args[0], ast.Constant)
                    or not isinstance(node.args[0].value, str)):
                problems.append(
                    f"{rel}:{node.lineno}: failpoints.fp() called with "
                    "a non-literal site — the registry lint can't see "
                    "it")
                continue
            site = node.args[0].value
            planted.setdefault(site, []).append((rel, node.lineno))
            if site not in sites:
                problems.append(
                    f"{rel}:{node.lineno}: failpoint site {site!r} is "
                    "not registered in failpoints._SITES")
    for site in sorted(set(sites) - set(planted)):
        problems.append(
            f"failpoint site {site!r}: registered in "
            "failpoints._SITES but never planted (no "
            "failpoints.fp() call site) — stale registry row")
    return problems


# ================================================= rule (h): guarded fields

def _stem_rels(an: _Analyzer) -> Dict[str, str]:
    """module short name -> rel path, preferring _private/<stem>.py."""
    out: Dict[str, str] = {}
    for rel, _t, _l in an.files:
        stem = os.path.basename(rel)[:-3]
        posix = rel.replace(os.sep, "/")
        if posix == f"_private/{stem}.py" or stem not in out:
            if posix == f"_private/{stem}.py" or f"/{stem}.py" not in \
                    out.get(stem, "").replace(os.sep, "/"):
                out.setdefault(stem, rel)
        if posix == f"_private/{stem}.py":
            out[stem] = rel
    return out


def _parse_guard(spec: str) -> Tuple[str, str]:
    """(kind, payload): ("thread", pat) | ("atomic", reason) |
    ("lock", name) | ("static-lock", name). static-lock fields carry
    full rule-(h) write verification but are exempt from runtime
    instrumentation (the documented hot-path form, ``"<lock>|static"``)."""
    if spec.startswith("thread:"):
        return "thread", spec[len("thread:"):].strip()
    if spec.startswith("atomic:"):
        return "atomic", spec[len("atomic:"):].strip()
    if spec.endswith("|static"):
        return "static-lock", spec[:-len("|static")]
    return "lock", spec


def _module_level_names(tree) -> Set[str]:
    out: Set[str] = set()
    for node in tree.body:
        tgts = []
        if isinstance(node, ast.Assign):
            tgts = node.targets
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            tgts = [node.target]
        for t in tgts:
            if isinstance(t, ast.Name):
                out.add(t.id)
    return out


def _check_fields(an: _Analyzer, design_path: str) -> List[str]:
    problems: List[str] = []
    fields = an.fields
    if not fields:
        return ["locksan.FIELDS not found/parseable — the guarded-by "
                "field scanner is broken"]
    reg = an.registry
    stem_rel = _stem_rels(an)
    trees = {rel: tree for rel, tree, _l in an.files}

    declared_self: Dict[tuple, Dict[str, tuple]] = {}
    declared_glob: Dict[str, Dict[str, tuple]] = {}
    for key, spec in sorted(fields.items()):
        parts = key.split(".")
        kind, payload = _parse_guard(spec)
        if kind in ("thread", "atomic") and not payload:
            problems.append(
                f"field {key}: {kind}: declaration with an empty "
                f"{'pattern' if kind == 'thread' else 'reason'}")
        if kind in ("lock", "static-lock") and payload not in reg:
            problems.append(
                f"field {key}: guard {payload!r} is not a declared "
                "lock in locksan.REGISTRY")
        if len(parts) == 3:
            rel = stem_rel.get(parts[0])
            if rel is None:
                problems.append(
                    f"field {key}: module {parts[0]!r} not found under "
                    "ray_tpu_torch/ — stale registry row")
                continue
            declared_self.setdefault((rel, parts[1]), {})[parts[2]] = \
                (key, spec, kind)
        elif len(parts) == 2:
            rel = stem_rel.get(parts[0])
            if rel is None:
                problems.append(
                    f"field {key}: module {parts[0]!r} not found under "
                    "ray_tpu_torch/ — stale registry row")
                continue
            declared_glob.setdefault(rel, {})[parts[1]] = \
                (key, spec, kind)
        else:
            problems.append(
                f"field {key}: key must be <module>.<Class>.<attr> or "
                "<module>.<name>")

    # existence + instrumentation evidence
    written_attrs: Dict[tuple, Set[str]] = {}
    for (rel, cls, _name), fi in an.funcs.items():
        if cls is None:
            continue
        s = written_attrs.setdefault((rel, cls), set())
        for w in fi.writes:
            if w.scope == "self":
                s.add(w.name)
    for (rel, cls), attrs in sorted(declared_self.items()):
        if (rel, cls) not in an.class_lines:
            for attr, (key, _spec, _kind) in sorted(attrs.items()):
                problems.append(
                    f"field {key}: class {cls} not found in {rel} — "
                    "stale registry row")
            continue
        have = written_attrs.get((rel, cls), set())
        for attr, (key, _spec, _kind) in sorted(attrs.items()):
            if attr not in have:
                problems.append(
                    f"field {key}: attribute never assigned in {cls} "
                    "— stale registry row")
        if (any(k not in ("atomic", "static-lock")
                for _key, _s, k in attrs.values())
                and (rel, cls) not in an.guarded_classes):
            problems.append(
                f"{rel}:{an.class_lines[(rel, cls)]}: class {cls} "
                "declares guarded fields but lacks @fieldsan.guarded — "
                "the runtime sanitizer cannot instrument them")
    for rel, names in sorted(declared_glob.items()):
        stem = os.path.basename(rel)[:-3]
        mod_names = _module_level_names(trees[rel])
        for name, (key, _spec, kind) in sorted(names.items()):
            if name not in mod_names:
                problems.append(
                    f"field {key}: module-level name never assigned in "
                    f"{rel} — stale registry row")
        if (any(k not in ("atomic", "static-lock")
                for _key, _s, k in names.values())
                and stem not in an.instrumented_mods):
            problems.append(
                f"{rel}: declares module-level guarded fields but "
                f"never calls fieldsan.instrument_module(globals(), "
                f"{stem!r}) — the runtime sanitizer cannot see them")

    # every write to a lock-guarded field sits under its guard
    for (rel, cls, fname), fi in sorted(
            an.funcs.items(), key=lambda kv: (kv[0][0], kv[0][1] or "",
                                              kv[0][2])):
        if fi.requires and fi.requires not in reg:
            problems.append(
                f"{rel}:{fi.lineno}: {fname} requires({fi.requires}) "
                "names an undeclared lock")
        self_decl = declared_self.get((rel, cls), {}) if cls else {}
        glob_decl = declared_glob.get(rel, {})
        for w in fi.writes:
            decl = (self_decl.get(w.name) if w.scope == "self"
                    else glob_decl.get(w.name))
            if decl is None:
                continue
            key, spec, kind = decl
            if kind not in ("lock", "static-lock"):
                continue
            gname = (spec[:-len("|static")] if kind == "static-lock"
                     else spec)
            if fname == "__init__" and w.scope == "self":
                continue        # single-threaded construction window
            if w.waiver is not None:
                if not w.waiver:
                    problems.append(
                        f"{rel}:{w.lineno}: race-ok waiver with an "
                        "empty reason")
                continue
            held = set(w.held)
            if fi.requires:
                held.add(fi.requires)
            if gname not in held:
                where = ("under " + "/".join(sorted(set(w.held)))
                         if w.held else "with no lock held")
                problems.append(
                    f"{rel}:{w.lineno}: write to {key} (guarded by "
                    f"{gname!r}) {where} — wrap it in `with` of its "
                    f"guard, annotate the function `# concurrency: "
                    f"requires({gname})`, or waive with "
                    "# lint: race-ok(reason)")

    # requires() call-site discipline (Clang REQUIRES at the caller)
    for (rel, cls, fname), fi in sorted(
            an.funcs.items(), key=lambda kv: (kv[0][0], kv[0][1] or "",
                                              kv[0][2])):
        for cs in fi.calls:
            if cs.callee is None or cs.callee not in an.funcs:
                continue
            req = an.funcs[cs.callee].requires
            if not req:
                continue
            if cs.waived_race_ok is not None:
                if not cs.waived_race_ok:
                    problems.append(
                        f"{rel}:{cs.lineno}: race-ok waiver with an "
                        "empty reason")
                continue
            if req in cs.held or fi.requires == req \
                    or fname == "__init__":
                continue
            problems.append(
                f"{rel}:{cs.lineno}: calls {cs.callee[2]!r} (declared "
                f"`requires({req})`) without holding {req!r}")

    # DESIGN.md ownership map mirrors FIELDS, both directions
    rows = parse_design_ownership_table(design_path)
    if not rows:
        problems.append(
            "DESIGN.md has no 'Shared-state ownership map' table — the "
            "declared field ownership must be documented")
        return problems
    doc: Dict[str, tuple] = {}
    for f, g, wtext in rows:
        if f in doc:
            problems.append(
                f"field {f!r}: duplicate DESIGN.md ownership row")
        doc[f] = (g, wtext)
    for key, spec in sorted(fields.items()):
        want = "atomic" if spec.startswith("atomic:") else spec
        d = doc.get(key)
        if d is None:
            problems.append(
                f"field {key}: in locksan.FIELDS but missing from the "
                "DESIGN.md ownership map")
        elif d[0] != want:
            problems.append(
                f"field {key}: DESIGN.md guard column {d[0]!r} "
                f"disagrees with locksan.FIELDS ({want!r})")
        elif not d[1]:
            problems.append(
                f"field {key}: DESIGN.md ownership row has an empty "
                "writer-threads column")
    for f in sorted(set(doc) - set(fields)):
        problems.append(
            f"field {f!r}: documented in DESIGN.md but absent from "
            "locksan.FIELDS — stale doc row")
    return problems


def _thread_roots(an: _Analyzer) -> Dict[tuple, str]:
    """Thread entry points: rule (d)'s reader roots + every function
    handed to ``threading.Thread(target=...)``."""
    roots: Dict[tuple, str] = {}
    for rel, cls, name in _READER_ROOTS:
        key = (rel.replace("/", os.sep), cls, name)
        if key in an.funcs:
            roots[key] = f"reader:{cls}.{name}"
    for (rel, cls, _fname), fi in an.funcs.items():
        for recv, _lineno in fi.thread_targets:
            tkey = None
            if len(recv) == 2 and recv[0] in ("self", "cls"):
                tkey = (rel, cls, recv[1])
            elif len(recv) == 1:
                tkey = (rel, None, recv[0])
                if tkey not in an.funcs:
                    tkey = (rel, cls, recv[0])
            if tkey is not None and tkey in an.funcs:
                roots.setdefault(
                    tkey, f"thread:{(tkey[1] + '.') if tkey[1] else ''}"
                          f"{tkey[2]}")
    return roots


def _reachability(an: _Analyzer,
                  roots: Dict[tuple, str]) -> Dict[tuple, Set[str]]:
    reach: Dict[tuple, Set[str]] = {}
    for rkey, label in roots.items():
        seen = {rkey}
        frontier = [rkey]
        while frontier:
            k = frontier.pop()
            reach.setdefault(k, set()).add(label)
            fi = an.funcs.get(k)
            if fi is None:
                continue
            for cs in fi.calls:
                callee = cs.callee
                if callee is None or callee in seen:
                    continue
                cfi = an.funcs.get(callee)
                if cfi is None or cfi.is_async:
                    continue
                seen.add(callee)
                frontier.append(callee)
    return reach


def _infer_undeclared(an: _Analyzer) -> List[str]:
    """Inference pass: attributes assigned in ``__init__`` and written
    outside it from functions that two different thread entry points
    can reach must be DECLARED (guard / thread-confined / atomic) —
    the registry can't silently rot as code grows."""
    problems: List[str] = []
    fields = an.fields
    stem_rel = _stem_rels(an)
    target_rels = {stem_rel[s]: s for s in _FIELD_MODULES
                   if s in stem_rel}
    reach = _reachability(an, _thread_roots(an))

    init_attrs: Dict[tuple, Set[str]] = {}
    for (rel, cls, fname), fi in an.funcs.items():
        if cls is None or fname != "__init__" or rel not in target_rels:
            continue
        s = init_attrs.setdefault((rel, cls), set())
        for w in fi.writes:
            if w.scope == "self":
                s.add(w.name)

    # attr -> {labels of thread roots reaching a writer}
    writer_labels: Dict[tuple, Set[str]] = {}
    writer_sites: Dict[tuple, List[tuple]] = {}
    for (rel, cls, fname), fi in an.funcs.items():
        if cls is None or fname == "__init__" or rel not in target_rels:
            continue
        for w in fi.writes:
            if w.scope != "self":
                continue
            if (rel, cls) not in init_attrs \
                    or w.name not in init_attrs[(rel, cls)]:
                continue
            labels = reach.get((rel, cls, fname)) or {"driver"}
            k = (rel, cls, w.name)
            writer_labels.setdefault(k, set()).update(labels)
            writer_sites.setdefault(k, []).append((fname, w.lineno))

    for (rel, cls, attr), labels in sorted(writer_labels.items()):
        if len(labels) < 2:
            continue
        stem = target_rels[rel]
        key = f"{stem}.{cls}.{attr}"
        if key in fields:
            continue
        sites = ", ".join(f"{fn}:{ln}"
                          for fn, ln in sorted(writer_sites[
                              (rel, cls, attr)])[:4])
        problems.append(
            f"undeclared shared-field candidate {key}: mutated at "
            f"{sites} in functions reachable from "
            f"{'/'.join(sorted(labels))} — declare its guard in "
            "locksan.FIELDS (lock, thread:<owner>, or "
            "atomic:<reason>)")
    return problems


# ================================================================== driver

def analyze(repo_root: Optional[str] = None) -> _Analyzer:
    root = repo_root or _repo_root()
    an = _Analyzer(root)
    an.resolve_all()
    return an


def check(repo_root: Optional[str] = None,
          an: Optional[_Analyzer] = None) -> List[str]:
    root = repo_root or _repo_root()
    if an is None:
        an = analyze(root)
    problems: List[str] = []
    problems += _check_registry(an, _design_path(root))
    problems += _check_order(an)
    problems += _check_blocking_under_lock(an)
    problems += _check_reader_discipline(an)
    problems += check_protocol_ops(an.files, an.funcs)
    problems += check_config_registry(an.files,
                                      os.path.join(root, "README.md"))
    problems += check_failpoint_registry(an.files)
    problems += _check_fields(an, _design_path(root))
    problems += _infer_undeclared(an)
    return problems


def waiver_report(repo_root: Optional[str] = None,
                  an: Optional[_Analyzer] = None) -> List[tuple]:
    root = repo_root or _repo_root()
    if an is None:
        an = analyze(root)
    ops = _collect_protocol_ops(an.files)
    out: List[tuple] = []
    seen: Set[tuple] = set()
    for w in an.waivers:        # one waiver per line, not per call node
        key = w[:3]
        if key not in seen:
            seen.add(key)
            out.append(w)
    for name, (_v, lineno, reason) in sorted(ops.items()):
        if reason is not None:
            out.append(("allow-op", "_private/protocol.py", lineno,
                        reason))
    return out


def main() -> int:
    an = analyze()
    problems = check(an=an)
    for p in problems:
        print(f"concurrency-lint: {p}", file=sys.stderr)
    waivers = waiver_report(an=an)
    for kind, rel, lineno, reason in waivers:
        print(f"concurrency-lint: waiver {kind} at {rel}:{lineno}: "
              f"{reason}")
    if problems:
        print(f"concurrency-lint: {len(problems)} problem(s)",
              file=sys.stderr)
        return 1
    print(f"concurrency-lint: ok ({len(waivers)} waiver(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
