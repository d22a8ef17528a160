"""The hosted checkers.

Concurrency discipline (the Eraser/lockset lineage, applied statically):

  guarded_by   — fields declared via `guarded_by("_lock", ...)` must only
                 be touched inside `with self.<lock>` in the owning class
                 (methods named *_locked or decorated @requires_lock are
                 lock-held contexts supplied by their caller).
  lock_blocking— blocking primitives (sleep, socket/RPC sends, subprocess,
                 device transfers) lexically inside a lock's `with` body.
  retry        — hand-rolled `time.sleep` retry/poll loops outside
                 nomad_tpu_torch/resilience (use RetryPolicy / Event.wait).
  thread       — `threading.Thread` without a descriptive name=, or a
                 non-daemon thread nobody retains a handle to (unjoinable).
  swallow      — broad `except Exception:` handlers that neither log,
                 re-raise, fire a failpoint, nor carry a suppression.

Telemetry key discipline (migrated from tests/test_telemetry_lint.py):

  failpoint_site — every fired failpoint literal declared in KNOWN_SITES
                   and (full-tree scans only) vice versa.
  metric_key     — metric key literals follow the nomad.* dotted scheme.
  trace_key      — span name literals follow the subsystem.operation
                   scheme.
  event_schema   — event topic/type literals exist in the events schema
                   registry and agree with each other.

Replica determinism:

  apply_pure     — call-graph closure from the FSM apply handlers,
                   StateStore mutators, Restore, and the event builders
                   must not reach the nondeterminism taxonomy (wall
                   clock, randomness, process identity, unordered set
                   iteration, thread spawns, I/O); declared local-only
                   sites carry `# lint: allow(apply_pure, <reason>)`.

Copied from nomad_tpu/analysis/checkers.py; only the imports and the
package named in two descriptions differ.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from .findings import Finding
from .framework import Checker, FileContext, PKG_ROOT, register

# Attribute / variable names that look like a mutual-exclusion primitive.
_LOCKISH_RE = re.compile(r"(lock|cond|mutex|mtx|mu)$")


def _call_name(node: ast.Call) -> str:
    func = node.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _receiver(node: ast.Call) -> str:
    func = node.func
    if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
        return func.value.id
    return ""


def _self_attr(node: ast.AST) -> Optional[str]:
    """'X' when node is the expression `self.X`, else None."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _with_lock_names(node: ast.With) -> List[str]:
    """Lock-ish names acquired by a `with` statement: `self.X` items and
    bare-name items whose name looks like a lock."""
    out = []
    for item in node.items:
        expr = item.context_expr
        attr = _self_attr(expr)
        if attr is not None and _LOCKISH_RE.search(attr):
            out.append(attr)
        elif isinstance(expr, ast.Name) and _LOCKISH_RE.search(expr.id):
            out.append(expr.id)
    return out


# --------------------------------------------------------------- guarded_by
@register
class GuardedByChecker(Checker):
    id = "guarded_by"
    description = ("access to a guarded_by()-declared field outside a "
                   "`with self.<lock>` block in the owning class")

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(self._check_class(ctx, node))
        return findings

    def _check_class(self, ctx: FileContext,
                     cls: ast.ClassDef) -> Iterable[Finding]:
        # field -> lock guarding it, from guarded_by() class attributes.
        guarded: Dict[str, str] = {}
        for stmt in cls.body:
            if not isinstance(stmt, ast.Assign) \
                    or not isinstance(stmt.value, ast.Call) \
                    or _call_name(stmt.value) != "guarded_by":
                continue
            args = [a.value for a in stmt.value.args
                    if isinstance(a, ast.Constant)
                    and isinstance(a.value, str)]
            if len(args) >= 2:
                for f in args[1:]:
                    guarded[f] = args[0]
        if not guarded:
            return ()
        all_locks = frozenset(guarded.values())

        findings: List[Finding] = []
        for stmt in cls.body:
            if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if stmt.name in ("__init__", "__del__"):
                continue  # construction/teardown precede or outlive sharing
            held = self._initial_held(stmt, all_locks)
            for sub in stmt.body:
                self._scan(sub, held, guarded, cls.name, ctx, findings)
        return findings

    @staticmethod
    def _initial_held(fn, all_locks: FrozenSet[str]) -> FrozenSet[str]:
        held: Set[str] = set()
        if fn.name.endswith("_locked"):
            held |= all_locks
        for deco in fn.decorator_list:
            if isinstance(deco, ast.Call) \
                    and _call_name(deco) == "requires_lock":
                held |= {a.value for a in deco.args
                         if isinstance(a, ast.Constant)
                         and isinstance(a.value, str)}
        return frozenset(held)

    def _scan(self, node: ast.AST, held: FrozenSet[str],
              guarded: Dict[str, str], cls_name: str, ctx: FileContext,
              findings: List[Finding]) -> None:
        if isinstance(node, ast.With):
            acquired = frozenset(a for item in node.items
                                 for a in [_self_attr(item.context_expr)]
                                 if a is not None)
            for item in node.items:
                self._scan(item.context_expr, held, guarded, cls_name, ctx,
                           findings)
            inner = held | acquired
            for sub in node.body:
                self._scan(sub, inner, guarded, cls_name, ctx, findings)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # Nested function: lexical position doesn't prove the lock is
            # held when it eventually runs — restart from its own markers.
            inner = self._initial_held(node, frozenset(guarded.values()))
            for sub in node.body:
                self._scan(sub, inner, guarded, cls_name, ctx, findings)
            return
        if isinstance(node, ast.ClassDef):
            return
        attr = _self_attr(node)
        if attr is not None and attr in guarded \
                and guarded[attr] not in held:
            findings.append(Finding(
                self.id, ctx.path, node.lineno,
                f"{cls_name}.{attr} is guarded by self.{guarded[attr]} "
                f"but accessed without holding it"))
            # fall through: still scan children (subscripts etc.)
        for child in ast.iter_child_nodes(node):
            self._scan(child, held, guarded, cls_name, ctx, findings)


# ------------------------------------------------------------ lock_blocking
_BLOCKING_RECEIVER_CALLS = {
    # receiver name -> blocked methods
    "time": {"sleep"}, "_time": {"sleep"},
    "subprocess": {"run", "Popen", "call", "check_call", "check_output"},
}
# Method names that block on the network regardless of receiver.
_BLOCKING_METHODS = {"sendall", "sendto", "recv", "recvfrom", "accept",
                     "connect", "send_frame", "recv_frame", "device_get"}
# Bare function names that block.
_BLOCKING_NAMES = {"send_frame", "recv_frame", "device_get"}


@register
class BlockingUnderLockChecker(Checker):
    id = "lock_blocking"
    description = ("blocking call (sleep / socket send / subprocess / "
                   "device transfer) lexically inside a lock's with body")

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.With) and _with_lock_names(node):
                lock = _with_lock_names(node)[0]
                for sub in node.body:
                    self._scan(sub, lock, ctx, findings)
        return findings

    def _scan(self, node: ast.AST, lock: str, ctx: FileContext,
              findings: List[Finding]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return  # runs later, not necessarily under the lock
        if isinstance(node, ast.Call):
            name = _call_name(node)
            recv = _receiver(node)
            blocked = (name in _BLOCKING_RECEIVER_CALLS.get(recv, ())
                       or (isinstance(node.func, ast.Attribute)
                           and name in _BLOCKING_METHODS
                           and not _LOCKISH_RE.search(recv))
                       or (isinstance(node.func, ast.Name)
                           and name in _BLOCKING_NAMES))
            if blocked:
                findings.append(Finding(
                    self.id, ctx.path, node.lineno,
                    f"blocking call {recv + '.' if recv else ''}{name}() "
                    f"inside `with self.{lock}` — move it outside the "
                    f"critical section"))
        for child in ast.iter_child_nodes(node):
            self._scan(child, lock, ctx, findings)


# -------------------------------------------------------------------- retry
@register
class HandRolledRetryChecker(Checker):
    id = "retry"
    description = ("time.sleep inside a loop outside "
                   "nomad_tpu_torch/resilience "
                   "— use RetryPolicy or a shutdown-aware Event.wait")

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        rel = ctx.rel()
        if rel.startswith("resilience" + os.sep):
            return ()
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.While, ast.For)):
                continue
            for sub in node.body + node.orelse:
                self._scan(sub, ctx, findings)
        return findings

    def _scan(self, node: ast.AST, ctx: FileContext,
              findings: List[Finding]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return
        if isinstance(node, (ast.While, ast.For)):
            return  # the outer ast.walk visits nested loops itself —
            #         descending here would double-report their sleeps
        if isinstance(node, ast.Call):
            name = _call_name(node)
            recv = _receiver(node)
            if name == "sleep" and (recv in ("time", "_time")
                                    or isinstance(node.func, ast.Name)):
                findings.append(Finding(
                    self.id, ctx.path, node.lineno,
                    "hand-rolled sleep loop — use resilience.retry."
                    "RetryPolicy (or a shutdown Event's .wait for pacing)"))
        for child in ast.iter_child_nodes(node):
            self._scan(child, ctx, findings)


# ------------------------------------------------------------------- thread
@register
class ThreadLifecycleChecker(Checker):
    id = "thread"
    description = ("threading.Thread without name=, or a non-daemon "
                   "thread with no retained handle to join")

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        assigned_calls: Set[int] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call) \
                    and self._is_thread_call(node.value):
                assigned_calls.add(id(node.value))
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and self._is_thread_call(node)):
                continue
            kwargs = {kw.arg for kw in node.keywords}
            if "name" not in kwargs:
                findings.append(Finding(
                    self.id, ctx.path, node.lineno,
                    "thread spawned without name= — SIGUSR1 dumps and "
                    "trace events cannot attribute it"))
            daemon = next((kw.value for kw in node.keywords
                           if kw.arg == "daemon"), None)
            is_daemon = (isinstance(daemon, ast.Constant)
                         and daemon.value is True)
            if not is_daemon and id(node) not in assigned_calls:
                findings.append(Finding(
                    self.id, ctx.path, node.lineno,
                    "non-daemon thread with no retained handle — nothing "
                    "can join it (assign it, or pass daemon=True)"))
        return findings

    @staticmethod
    def _is_thread_call(node: ast.Call) -> bool:
        func = node.func
        if isinstance(func, ast.Attribute):
            return (func.attr == "Thread"
                    and isinstance(func.value, ast.Name)
                    and func.value.id == "threading")
        return isinstance(func, ast.Name) and func.id == "Thread"


# ------------------------------------------------------------------ swallow
_LOG_METHODS = {"debug", "info", "warning", "warn", "error", "exception",
                "critical", "log"}


@register
class SilentSwallowChecker(Checker):
    id = "swallow"
    description = ("broad except handler that neither logs, re-raises, "
                   "nor fires a failpoint")

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not self._is_broad(node.type):
                continue
            if self._handles(node):
                continue
            findings.append(Finding(
                self.id, ctx.path, node.lineno,
                "broad except swallows the error silently — log it at "
                "debug with context, or mark intent with "
                "`# lint: allow(swallow, <reason>)`"))
        return findings

    @staticmethod
    def _is_broad(type_node: Optional[ast.AST]) -> bool:
        def broad(n: ast.AST) -> bool:
            return isinstance(n, ast.Name) and n.id in ("Exception",
                                                        "BaseException")
        if type_node is None:
            return True
        if broad(type_node):
            return True
        if isinstance(type_node, ast.Tuple):
            return any(broad(e) for e in type_node.elts)
        return False

    @staticmethod
    def _handles(handler: ast.ExceptHandler) -> bool:
        for node in ast.walk(handler):
            if isinstance(node, ast.Raise):
                return True
            if isinstance(node, ast.Call):
                name = _call_name(node)
                if name in _LOG_METHODS \
                        and isinstance(node.func, ast.Attribute):
                    return True
                if name in ("print", "fire"):
                    return True
        return False


# ----------------------------------------------------------- failpoint_site
@register
class FailpointSiteChecker(Checker):
    id = "failpoint_site"
    description = ("failpoints.fire() literals must be declared in "
                   "KNOWN_SITES, and declared sites must still fire "
                   "somewhere in the tree")

    def __init__(self) -> None:
        self._fired: Dict[str, Tuple[str, int]] = {}

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        from nomad_tpu_torch.resilience import failpoints

        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) \
                    or _call_name(node) != "fire":
                continue
            if _receiver(node) not in ("failpoints", ""):
                continue
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                site = node.args[0].value
                self._fired.setdefault(site, (ctx.path, node.lineno))
                if site not in failpoints.KNOWN_SITES:
                    findings.append(Finding(
                        self.id, ctx.path, node.lineno,
                        f"failpoint site {site!r} fired here but not "
                        f"declared in failpoints.KNOWN_SITES"))
        return findings

    def finalize(self, full_tree: bool) -> Iterable[Finding]:
        if not full_tree:
            return ()  # partial scans can't prove a site never fires
        from nomad_tpu_torch.resilience import failpoints

        fp_path = os.path.abspath(failpoints.__file__)
        try:
            with open(fp_path, encoding="utf-8") as f:
                fp_lines = f.read().splitlines()
        except OSError:
            fp_lines = []
        findings = []
        for site in sorted(set(failpoints.KNOWN_SITES) - set(self._fired)):
            line = next((i for i, text in enumerate(fp_lines, start=1)
                         if f'"{site}"' in text), 1)
            findings.append(Finding(
                self.id, fp_path, line,
                f"KNOWN_SITES declares {site!r} but no source location "
                f"fires it (renamed seam?)"))
        return findings


# --------------------------------------------------------------- metric_key
_METRIC_FNS = {"set_gauge", "incr_counter", "add_sample", "measure",
               "measure_since"}
_SEGMENT_RE = re.compile(r"^[a-z0-9_]+$")


@register
class MetricKeyChecker(Checker):
    id = "metric_key"
    description = "metric key literals must follow the nomad.* scheme"

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) \
                    or _call_name(node) not in _METRIC_FNS:
                continue
            if _receiver(node) not in ("metrics", "telemetry", "registry",
                                       "reg", ""):
                continue
            if not node.args or not isinstance(node.args[0], ast.Tuple):
                continue
            elts = node.args[0].elts
            consts = [e.value for e in elts
                      if isinstance(e, ast.Constant)
                      and isinstance(e.value, str)]
            if not consts:
                continue
            if isinstance(elts[0], ast.Constant) and consts[0] != "nomad":
                findings.append(Finding(
                    self.id, ctx.path, node.lineno,
                    f"metric key {tuple(consts)}: first segment must be "
                    f"'nomad'"))
                continue
            # Dynamic trailing segments (ev.Type, RPC method names) are
            # exempt; every CONSTANT segment must match the scheme.
            for seg in consts:
                if seg != "nomad" and not all(
                        _SEGMENT_RE.match(p) for p in seg.split(".")):
                    findings.append(Finding(
                        self.id, ctx.path, node.lineno,
                        f"metric key {tuple(consts)}: segment {seg!r} "
                        f"breaks [a-z0-9_]"))
                    break
        return findings


# ---------------------------------------------------------------- trace_key
_TRACE_SPAN_FNS = {"span", "root_span", "resume", "start_from"}
_SPAN_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[A-Za-z][A-Za-z0-9_]*)+$")


@register
class TraceKeyChecker(Checker):
    id = "trace_key"
    description = ("trace span name literals must follow the "
                   "subsystem.operation scheme")

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.rel() == os.path.join("telemetry", "trace.py"):
            return ()  # the implementation's docstrings/internals
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name_arg = None
            fn = _call_name(node)
            recv = _receiver(node)
            if recv not in ("trace", "_trace"):
                continue
            if fn in _TRACE_SPAN_FNS:
                # span(name)/root_span(name) take name first;
                # resume/start_from take (carrier, name).
                idx = 0 if fn in ("span", "root_span") else 1
                if len(node.args) > idx:
                    name_arg = node.args[idx]
            elif fn == "record_span" and len(node.args) > 1:
                name_arg = node.args[1]
            if name_arg is None or not isinstance(name_arg, ast.Constant) \
                    or not isinstance(name_arg.value, str):
                continue  # dynamic names ("rpc." + method) are exempt
            if not _SPAN_NAME_RE.match(name_arg.value):
                findings.append(Finding(
                    self.id, ctx.path, node.lineno,
                    f"span name {name_arg.value!r} breaks the "
                    f"subsystem.operation scheme"))
        return findings


# --------------------------------------------------------------- event_schema
@register
class EventSchemaChecker(Checker):
    id = "event_schema"
    description = ("event topic/type literals must exist in the events "
                   "schema registry (TOPICS / EVENT_TYPES) and agree "
                   "with each other")

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.rel() == os.path.join("events", "schema.py"):
            return ()  # the registry itself defines the literals
        findings: List[Finding] = []
        from nomad_tpu_torch.events.schema import EVENT_TYPES, TOPICS

        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) \
                    and _call_name(node) == "new_event":
                # new_event(topic, etype, ...): both literals must be
                # registered, and the type must publish on that topic.
                # Dynamic args (rebroadcast of an existing event) are
                # exempt — the constructor re-validates at runtime.
                lits = [a.value if isinstance(a, ast.Constant)
                        and isinstance(a.value, str) else None
                        for a in node.args[:2]]
                topic, etype = (lits + [None, None])[:2]
                if topic is not None and topic not in TOPICS:
                    findings.append(Finding(
                        self.id, ctx.path, node.lineno,
                        f"event topic {topic!r} is not declared in "
                        f"events.schema.TOPICS"))
                elif etype is not None and etype not in EVENT_TYPES:
                    findings.append(Finding(
                        self.id, ctx.path, node.lineno,
                        f"event type {etype!r} is not declared in "
                        f"events.schema.EVENT_TYPES"))
                elif topic is not None and etype is not None \
                        and EVENT_TYPES[etype] != topic:
                    findings.append(Finding(
                        self.id, ctx.path, node.lineno,
                        f"event type {etype!r} publishes on topic "
                        f"{EVENT_TYPES[etype]!r}, not {topic!r}"))
            elif isinstance(node, ast.Compare):
                # `ev["Topic"] == "X"` routing comparisons: the literal
                # side must name a real topic (a renamed topic would
                # otherwise make the branch silently dead).
                sides = [node.left] + list(node.comparators)
                if not any(
                        isinstance(s, ast.Subscript)
                        and isinstance(s.slice, ast.Constant)
                        and s.slice.value == "Topic" for s in sides):
                    continue
                for side in sides:
                    if isinstance(side, ast.Constant) \
                            and isinstance(side.value, str) \
                            and side.value not in TOPICS:
                        findings.append(Finding(
                            self.id, ctx.path, node.lineno,
                            f"comparison against unknown event topic "
                            f"{side.value!r}"))
        return findings


# ----------------------------------------------------------------- apply_pure
@register
class ApplyPurityChecker(Checker):
    id = "apply_pure"
    description = ("nondeterministic call (wall clock, randomness, "
                   "process identity, unordered set iteration, threads, "
                   "I/O) reachable from the replicated apply path")

    def __init__(self) -> None:
        from .callgraph import CallGraph

        self._graph = CallGraph()

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        # Whole-graph analysis: files accumulate here, findings land in
        # finalize once reachability is known.
        self._graph.add_file(ctx)
        return ()

    def finalize(self, full_tree: bool) -> Iterable[Finding]:
        findings: List[Finding] = []
        for imp in self._graph.impurities():
            hops = " -> ".join(imp.chain)
            findings.append(Finding(
                self.id, imp.path, imp.lineno,
                f"{imp.category}: {imp.label} reachable from the apply "
                f"path via {hops} — replicas diverge; make it a "
                f"function of the entry, or mark the site local-only "
                f"with `# lint: allow(apply_pure, <reason>)`"))
        return findings
