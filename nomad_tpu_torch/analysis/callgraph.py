"""Project-wide AST call graph + apply-path purity analysis.

Replica determinism rests on one invariant: every code path reachable
from the FSM apply handlers, the StateStore mutators, snapshot restore,
and the event builders is a deterministic function of the committed raft
entry. This module makes that invariant *checkable*: it builds a call
graph over the framework's cached per-file parses, computes the
transitive closure from the apply-path roots, and classifies every
reachable call against a declared nondeterminism taxonomy:

  wall_clock   time.time/monotonic/perf_counter(_ns), datetime.now/...
  randomness   random.*, uuid1/uuid4, os.urandom, secrets.*
  identity     id(), hash() — process-local values leaking into state
  unordered    iteration directly over a set display / set() call whose
               order could reach a replicated write or event list
  thread       thread/timer spawns inside the apply path
  io           open/subprocess/socket — external effects under apply

Resolution is deliberately conservative and name-based (Python has no
static types to lean on):

  * bare names resolve through the file's import table, then to
    same-module functions;
  * ``self.meth()`` resolves to the enclosing class's method, falling
    back to a project-wide method-name match (method dispatch);
  * ``obj.meth()`` resolves by method-name match across scanned classes
    RESTRICTED to the calling file and the modules it imports (a file
    cannot invoke a method of a class it has no path to), EXCLUDING
    common container/str method names (a denylist) so
    `items.append(...)` never drags in an unrelated `append`.

Declared observer seams are traversal BOUNDARIES: the telemetry package
(metrics/trace stamping is replica-local by contract) and the failpoint
registry (disarmed in production; armed only under chaos schedules).
Calls INTO them never flag; direct taxonomy calls in apply-path files
still do, and carry `# lint: allow(apply_pure, <reason>)` suppressions
where they are intentionally local-only.

Copied from nomad_tpu/analysis/callgraph.py; only the imports and
the package name it resolves modules under differ.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .framework import FileContext, PKG_ROOT

# --------------------------------------------------------------- taxonomy
_WALL_CLOCK_TIME = {"time", "time_ns", "monotonic", "monotonic_ns",
                    "perf_counter", "perf_counter_ns"}
_WALL_CLOCK_DATETIME = {"now", "utcnow", "today", "fromtimestamp"}
_RANDOM_UUID = {"uuid1", "uuid4"}
_THREAD_SPAWNS = {"Thread", "Timer"}
_IO_SUBPROCESS = {"run", "Popen", "call", "check_call", "check_output"}

# Method names too generic to resolve across classes: builtin container /
# str methods plus ubiquitous local-only verbs. Without this, every
# `watch_items.add(...)` would edge into every project class defining
# `add`.
_DENY_METHODS = {
    "get", "set", "add", "append", "extend", "insert", "remove", "pop",
    "clear", "keys", "values", "items", "update", "setdefault", "sort",
    "reverse", "join", "split", "strip", "startswith", "endswith",
    "format", "encode", "decode", "copy", "count", "index", "lower",
    "upper", "replace", "read", "close", "discard", "union", "wait",
    "notify", "notify_all", "acquire", "release", "put", "get_nowait",
    "tolist", "astype", "item", "fill", "any", "all", "sum", "max",
    "min", "isoformat", "total_seconds", "groups", "group", "match",
    "search", "finditer", "findall",
}

# Files that are declared traversal boundaries (relative to PKG_ROOT):
# replica-local observer seams whose internals are not apply-path state.
_BOUNDARY_PREFIXES = ("telemetry" + os.sep,)
_BOUNDARY_FILES = {os.path.join("resilience", "failpoints.py")}


@dataclass
class Impurity:
    """One nondeterministic call reachable from an apply-path root."""

    category: str      # taxonomy bucket, e.g. "wall_clock"
    label: str         # rendered call, e.g. "time.time()"
    path: str          # absolute path of the offending file
    lineno: int
    func: str          # qualname of the function containing the call
    chain: Tuple[str, ...]  # root -> ... -> func qualnames


class _FuncInfo:
    __slots__ = ("key", "path", "qualname", "cls", "name", "lineno",
                 "node", "boundary")

    def __init__(self, key, path, qualname, cls, name, lineno, node,
                 boundary):
        self.key = key
        self.path = path
        self.qualname = qualname
        self.cls = cls          # enclosing class name or None
        self.name = name        # bare function/method name
        self.lineno = lineno
        self.node = node        # the ast.FunctionDef
        self.boundary = boundary


def _rel(path: str) -> Optional[str]:
    """Path relative to the package root, or None for external files."""
    rel = os.path.relpath(path, PKG_ROOT)
    return None if rel.startswith("..") else rel


def _module_path(module: str) -> Optional[str]:
    """nomad_tpu_torch.x.y -> absolute source path (or None for externals)."""
    if module == "nomad_tpu_torch":
        return os.path.join(PKG_ROOT, "__init__.py")
    if not module.startswith("nomad_tpu_torch."):
        return None
    parts = module.split(".")[1:]
    path = os.path.join(PKG_ROOT, *parts)
    if os.path.isdir(path):
        return os.path.join(path, "__init__.py")
    return path + ".py"


def _dotted(func: ast.AST) -> Optional[List[str]]:
    """['self', 'state', 'upsert_node'] for self.state.upsert_node; None
    for calls through subscripts/calls (resolved by name-match instead)."""
    parts: List[str] = []
    node = func
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return None


class CallGraph:
    """Call graph over a set of scanned FileContexts."""

    def __init__(self) -> None:
        self._funcs: Dict[Tuple[str, str], _FuncInfo] = {}
        # method name -> keys of every class method with that name
        self._methods: Dict[str, List[Tuple[str, str]]] = {}
        # (path, name) -> key, for module-level functions
        self._module_funcs: Dict[Tuple[str, str], Tuple[str, str]] = {}
        # path -> {local name: module} from `import X [as Y]`
        self._imports: Dict[str, Dict[str, str]] = {}
        # path -> {local name: (module, attr)} from `from X import Y`
        self._from_imports: Dict[str, Dict[str, Tuple[str, str]]] = {}
        # path -> project source paths its imports can reach (the
        # visibility set for method-name fallback resolution)
        self._visible: Dict[str, Set[str]] = {}
        self._paths: Set[str] = set()

    # ---------------------------------------------------------- indexing
    def add_file(self, ctx: FileContext) -> None:
        path = ctx.path
        if path in self._paths:
            return
        self._paths.add(path)
        rel = _rel(path)
        boundary = rel is not None and (
            rel in _BOUNDARY_FILES
            or any(rel.startswith(p) for p in _BOUNDARY_PREFIXES))
        imports: Dict[str, str] = {}
        from_imports: Dict[str, Tuple[str, str]] = {}
        self._imports[path] = imports
        self._from_imports[path] = from_imports

        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    imports[alias.asname or alias.name.split(".")[0]] = \
                        alias.name
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for alias in node.names:
                    from_imports[alias.asname or alias.name] = \
                        (node.module, alias.name)
            elif isinstance(node, ast.ImportFrom) and node.level > 0 \
                    and rel is not None:
                # Relative import inside the package: resolve against rel.
                base = rel.replace(os.sep, ".")[:-3]
                pkg = base.rsplit(".", node.level)[0] if "." in base \
                    else ""
                module = "nomad_tpu_torch" + ("." + pkg if pkg else "") \
                    + ("." + node.module if node.module else "")
                for alias in node.names:
                    from_imports[alias.asname or alias.name] = \
                        (module, alias.name)

        def index(node: ast.AST, cls: Optional[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    qual = f"{cls}.{child.name}" if cls else child.name
                    key = (path, qual)
                    self._funcs[key] = _FuncInfo(
                        key, path, qual, cls, child.name, child.lineno,
                        child, boundary)
                    if cls:
                        self._methods.setdefault(child.name, []).append(key)
                    else:
                        self._module_funcs[(path, child.name)] = key
                    # Nested defs fold into the enclosing function; do
                    # not index them separately.
                elif isinstance(child, ast.ClassDef):
                    index(child, child.name)
                else:
                    index(child, cls)

        index(ctx.tree, None)

        visible = {path}
        for module in imports.values():
            p = _module_path(module)
            if p is not None:
                visible.add(p)
        for module, attr in from_imports.values():
            for candidate in (module, module + "." + attr):
                p = _module_path(candidate)
                if p is not None:
                    visible.add(p)
        self._visible[path] = visible

    def functions(self) -> Iterable[_FuncInfo]:
        return self._funcs.values()

    # -------------------------------------------------------- resolution
    def _classify_module_call(self, module: str, attr: str,
                              ) -> Optional[Tuple[str, str]]:
        """(category, label) when module.attr() is a taxonomy leaf."""
        tail = module.split(".")[-1]
        if tail == "time" and attr in _WALL_CLOCK_TIME:
            return ("wall_clock", f"time.{attr}()")
        if tail == "datetime" and attr in _WALL_CLOCK_DATETIME:
            return ("wall_clock", f"datetime.{attr}()")
        if tail == "random":
            return ("randomness", f"random.{attr}()")
        if tail == "uuid" and attr in _RANDOM_UUID:
            return ("randomness", f"uuid.{attr}()")
        if tail == "os" and attr == "urandom":
            return ("randomness", "os.urandom()")
        if tail == "secrets":
            return ("randomness", f"secrets.{attr}()")
        if tail == "threading" and attr in _THREAD_SPAWNS:
            return ("thread", f"threading.{attr}()")
        if tail == "subprocess" and attr in _IO_SUBPROCESS:
            return ("io", f"subprocess.{attr}()")
        if tail == "socket":
            return ("io", f"socket.{attr}()")
        return None

    def _classify_bare(self, name: str,
                       from_imports: Dict[str, Tuple[str, str]],
                       ) -> Optional[Tuple[str, str]]:
        if name in ("id", "hash"):
            return ("identity", f"{name}()")
        if name == "open":
            return ("io", "open()")
        if name in from_imports:
            module, attr = from_imports[name]
            return self._classify_module_call(module, attr)
        return None

    def _project_edge(self, module: str, attr: str,
                      ) -> Optional[Tuple[str, str]]:
        path = _module_path(module)
        if path is None:
            return None
        return self._module_funcs.get((path, attr))

    def resolve(self, info: _FuncInfo) -> Tuple[
            List[Tuple[str, str]], List[Tuple[str, str, int]]]:
        """(callee keys, taxonomy leaves [(category, label, lineno)]) for
        every call lexically inside `info` (nested defs included)."""
        edges: List[Tuple[str, str]] = []
        leaves: List[Tuple[str, str, int]] = []
        imports = self._imports.get(info.path, {})
        from_imports = self._from_imports.get(info.path, {})

        for node in ast.walk(info.node):
            if isinstance(node, (ast.For, ast.comprehension)):
                it = node.iter
                if isinstance(it, ast.Set) or (
                        isinstance(it, ast.Call)
                        and isinstance(it.func, ast.Name)
                        and it.func.id in ("set", "frozenset")):
                    lineno = getattr(node, "lineno", None) \
                        or getattr(it, "lineno", info.lineno)
                    leaves.append(("unordered",
                                   "iteration over a set (hash order)",
                                   lineno))
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if isinstance(func, ast.Name):
                name = func.id
                leaf = self._classify_bare(name, from_imports)
                if leaf is not None:
                    leaves.append((leaf[0], leaf[1], node.lineno))
                    continue
                if name in from_imports:
                    module, attr = from_imports[name]
                    edge = self._project_edge(module, attr)
                    if edge is not None:
                        edges.append(edge)
                    continue
                edge = self._module_funcs.get((info.path, name))
                if edge is not None:
                    edges.append(edge)
                continue
            parts = _dotted(func)
            attr = func.attr if isinstance(func, ast.Attribute) else ""
            if parts is None:
                # obj[...] .meth() / chained-call receivers: name-match.
                edges.extend(self._method_edges(attr, info))
                continue
            head = parts[0]
            if head == "self":
                if len(parts) == 2 and info.cls is not None:
                    own = (info.path, f"{info.cls}.{attr}")
                    if own in self._funcs:
                        edges.append(own)
                        continue
                edges.extend(self._method_edges(attr, info))
                continue
            if head in imports:
                module = imports[head]
                # `datetime.datetime.now()` and plain `time.time()` both
                # classify off the dotted tail.
                tail_mod = module if len(parts) == 2 \
                    else module + "." + ".".join(parts[1:-1])
                leaf = self._classify_module_call(tail_mod, attr)
                if leaf is not None:
                    leaves.append((leaf[0], leaf[1], node.lineno))
                    continue
                edge = self._project_edge(module, attr)
                if edge is not None:
                    edges.append(edge)
                continue
            if head in from_imports and len(parts) >= 2:
                module, sub = from_imports[head]
                leaf = self._classify_module_call(module + "." + sub, attr)
                if leaf is not None:
                    leaves.append((leaf[0], leaf[1], node.lineno))
                    continue
                edge = self._project_edge(module + "." + sub, attr)
                if edge is not None:
                    edges.append(edge)
                    continue
                edges.extend(self._method_edges(attr, info))
                continue
            edges.extend(self._method_edges(attr, info))
        return edges, leaves

    def _method_edges(self, attr: str,
                      info: _FuncInfo) -> List[Tuple[str, str]]:
        if not attr or attr in _DENY_METHODS:
            return []
        visible = self._visible.get(info.path, ())
        return [key for key in self._methods.get(attr, ())
                if key[0] in visible]

    # ------------------------------------------------------------- roots
    def apply_roots(self) -> List[Tuple[str, str]]:
        """The declared apply-path entry points.

        Inside the package: FSM apply/restore, StateStore mutators, the
        Restore loader, and the event builders. External files (the lint
        fixture, ad-hoc scans) root at apply/restore-named functions so
        the checker is provable outside the tree too — but that loose
        rule deliberately does NOT apply in-package (RaftBackend.apply
        wraps transport I/O that is not replicated-apply work).
        """
        roots: List[Tuple[str, str]] = []
        fsm_path = os.path.join(PKG_ROOT, "server", "fsm.py")
        store_path = os.path.join(PKG_ROOT, "state", "state_store.py")
        builders_path = os.path.join(PKG_ROOT, "events", "builders.py")
        for key, info in self._funcs.items():
            path, qual = key
            if path == fsm_path and info.cls == "FSM" and (
                    info.name == "apply"
                    or info.name.startswith("_apply_")
                    or info.name in ("restore", "restore_chunks")):
                roots.append(key)
            elif path == store_path and info.cls == "StateStore" and (
                    info.name.startswith(("upsert_", "delete_", "update_"))
                    or info.name == "apply_sweep_segment"):
                roots.append(key)
            elif path == store_path and info.cls == "Restore":
                roots.append(key)
            elif path == builders_path and info.cls is None:
                roots.append(key)
            elif _rel(path) is None and (
                    info.name == "apply"
                    or info.name.startswith("_apply_")
                    or info.name.startswith("restore")):
                roots.append(key)
        return roots

    # ------------------------------------------------------ reachability
    def impurities(self, roots: Optional[List[Tuple[str, str]]] = None,
                   ) -> List[Impurity]:
        """Taxonomy leaves in the transitive closure of `roots` (BFS;
        shortest chain wins when a site is reachable several ways)."""
        if roots is None:
            roots = self.apply_roots()
        parent: Dict[Tuple[str, str], Optional[Tuple[str, str]]] = {}
        queue: List[Tuple[str, str]] = []
        for r in roots:
            if r not in parent:
                parent[r] = None
                queue.append(r)
        resolved: Dict[Tuple[str, str], Tuple[list, list]] = {}
        order: List[Tuple[str, str]] = []
        while queue:
            key = queue.pop(0)
            info = self._funcs.get(key)
            if info is None or info.boundary:
                continue
            order.append(key)
            edges, leaves = self.resolve(info)
            resolved[key] = (edges, leaves)
            for callee in edges:
                if callee not in parent:
                    parent[callee] = key
                    queue.append(callee)

        def chain(key: Tuple[str, str]) -> Tuple[str, ...]:
            out: List[str] = []
            cur: Optional[Tuple[str, str]] = key
            while cur is not None:
                out.append(self._funcs[cur].qualname)
                cur = parent[cur]
            return tuple(reversed(out))

        seen: Set[Tuple[str, int, str]] = set()
        out: List[Impurity] = []
        for key in order:
            info = self._funcs[key]
            for category, label, lineno in resolved[key][1]:
                dedup = (info.path, lineno, label)
                if dedup in seen:
                    continue
                seen.add(dedup)
                out.append(Impurity(category, label, info.path, lineno,
                                    info.qualname, chain(key)))
        out.sort(key=lambda i: (i.path, i.lineno))
        return out


def build_graph(contexts: Iterable[FileContext]) -> CallGraph:
    graph = CallGraph()
    for ctx in contexts:
        graph.add_file(ctx)
    return graph
