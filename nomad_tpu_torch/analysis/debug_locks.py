"""Runtime lock-order detector (the dynamic half of the concurrency
pass; lineage: Eraser's lockset discipline, ThreadSanitizer's dynamic
annotations, the kernel's lockdep lock-class graph).

``install()`` — wired by ``NOMAD_TPU_DEBUG_LOCKS=1`` through
tests/conftest.py — swaps ``threading.Lock``/``threading.RLock`` for
:class:`DebugLock`/:class:`DebugRLock`. Every lock constructed AFTER the
swap is identified by its construction site (file:line — the lockdep
"lock class": all instances from one site share one identity, so an
A->B/B->A inversion is caught even across distinct object pairs). The
wrappers maintain:

* a per-thread stack of held locks,
* a process-wide ordering graph (edges: "held A while acquiring B");
  a new edge whose reverse is already reachable is a potential deadlock
  and reports a ``lock_order_inversion``,
* per-acquisition hold timing; holds over ``NOMAD_TPU_LOCK_HOLD_MS``
  (default 500) report a ``long_hold``,
* a patched ``time.sleep`` that reports ``blocking_under_lock`` when
  called with any lock held.

Findings are appended to an in-process list (:func:`runtime_findings`),
logged at WARNING, counted on ``nomad.analysis.<kind>`` metrics, and —
when tracing is active — attached to the current span as an
``analysis.<kind>`` event. Nothing raises into the instrumented path.

Default-off: with the env var unset nothing is patched and the cost is
zero.

Copied from nomad_tpu/analysis/debug_locks.py; only the imports differ.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

LOG = logging.getLogger("nomad.analysis.locks")

ENV_VAR = "NOMAD_TPU_DEBUG_LOCKS"
HOLD_THRESHOLD_MS_VAR = "NOMAD_TPU_LOCK_HOLD_MS"


@dataclass
class RuntimeFinding:
    kind: str                    # lock_order_inversion | long_hold |
    #                              blocking_under_lock
    detail: str
    locks: Tuple[str, ...]
    thread: str
    when: float = field(default_factory=time.monotonic)

    def __str__(self) -> str:
        return (f"[{self.kind}] {self.detail} "
                f"(locks={list(self.locks)}, thread={self.thread})")


# Saved originals (populated by install()).
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_SLEEP = time.sleep

_installed = False
_tls = threading.local()

# Module state guarded by _state_lock (always a REAL lock, never a
# DebugLock — the detector must not watch itself).
_state_lock = threading.Lock()
_order: Dict[str, Set[str]] = {}           # site -> sites acquired under it
_edge_seen: Set[Tuple[str, str]] = set()
_findings: List[RuntimeFinding] = []
_MAX_FINDINGS = 1024


def _read_hold_threshold() -> float:
    try:
        return float(os.environ.get(HOLD_THRESHOLD_MS_VAR, "500")) / 1000.0
    except ValueError:
        return 0.5


# Cached at import and refreshed by install(): _pop runs on EVERY lock
# release, and an os.environ lookup + float parse there would inflate the
# very hold times being measured. Tests override via monkeypatch.setattr.
hold_threshold_s = _read_hold_threshold()


def _hold_threshold() -> float:
    return hold_threshold_s


def _held() -> List[Tuple[Any, float]]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _caller_site() -> str:
    """file:line of the frame that constructed the lock, skipping this
    module and threading internals — the lock's 'class' identity."""
    import sys

    frame = sys._getframe(2)
    here = os.path.dirname(os.path.abspath(__file__))
    while frame is not None:
        fn = frame.f_code.co_filename
        if not fn.startswith(here) and "threading" not in fn:
            rel = os.path.basename(os.path.dirname(fn)) + "/" \
                + os.path.basename(fn)
            return f"{rel}:{frame.f_lineno}"
        frame = frame.f_back
    return "<unknown>"


def _report(kind: str, detail: str, locks: Tuple[str, ...]) -> None:
    if getattr(_tls, "reporting", False):
        return  # a finding raised while reporting a finding: drop it
    _tls.reporting = True
    try:
        finding = RuntimeFinding(kind, detail, locks,
                                 threading.current_thread().name)
        with _state_lock:
            if len(_findings) < _MAX_FINDINGS:
                _findings.append(finding)
        LOG.warning("debug-locks: %s", finding)
        try:
            from nomad_tpu_torch.telemetry import metrics, trace

            metrics.incr_counter(("nomad", "analysis", kind), 1)
            trace.add_event(f"analysis.{kind}", detail=detail,
                            locks=",".join(locks))
        # lint: allow(swallow, detector must never raise into the watched path)
        except Exception:
            pass
    finally:
        _tls.reporting = False


def runtime_findings(kind: Optional[str] = None) -> List[RuntimeFinding]:
    with _state_lock:
        out = list(_findings)
    return [f for f in out if kind is None or f.kind == kind]


def clear_findings() -> None:
    with _state_lock:
        _findings.clear()
        _order.clear()
        _edge_seen.clear()


def _reachable(frm: str, to: str) -> bool:
    """DFS over the ordering graph; caller holds _state_lock."""
    seen: Set[str] = set()
    stack = [frm]
    while stack:
        cur = stack.pop()
        if cur == to:
            return True
        if cur in seen:
            continue
        seen.add(cur)
        stack.extend(_order.get(cur, ()))
    return False


def _note_acquire(lock: "DebugLock") -> None:
    """Record ordering edges BEFORE blocking on the inner acquire — the
    point of a deadlock detector is to fire on the attempt."""
    held = _held()
    if not held:
        return
    for other, _t0 in held:
        a, b = other.name, lock.name
        if a == b:
            continue
        with _state_lock:
            if (a, b) in _edge_seen:
                continue
            inversion = _reachable(b, a)
            _edge_seen.add((a, b))
            _order.setdefault(a, set()).add(b)
        if inversion:
            _report("lock_order_inversion",
                    f"acquiring {b} while holding {a}, but the reverse "
                    f"order was also observed (potential deadlock)",
                    (a, b))


def _push(lock: "DebugLock") -> None:
    _held().append((lock, time.monotonic()))


def _pop(lock: "DebugLock") -> None:
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] is lock:
            _, t0 = held.pop(i)
            dur = time.monotonic() - t0
            if dur > _hold_threshold():
                _report("long_hold",
                        f"{lock.name} held for {dur * 1e3:.0f}ms "
                        f"(threshold {_hold_threshold() * 1e3:.0f}ms)",
                        (lock.name,))
            return


class DebugLock:
    """Instrumented stand-in for ``threading.Lock``."""

    __slots__ = ("_inner", "name")

    def __init__(self, name: Optional[str] = None):
        self._inner = _REAL_LOCK()
        self.name = name or _caller_site()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if blocking:
            _note_acquire(self)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _push(self)
        return ok

    def release(self) -> None:
        _pop(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def _at_fork_reinit(self) -> None:
        # stdlib fork handlers (concurrent.futures, threading) re-arm
        # module locks in the child through this hook.
        self._inner._at_fork_reinit()
        _tls.__dict__.clear()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name}>"


class DebugRLock:
    """Instrumented stand-in for ``threading.RLock``. Only the outermost
    acquire/release touches the held stack; the ``_release_save`` /
    ``_acquire_restore`` / ``_is_owned`` trio keeps ``Condition.wait``
    honest about what is really held while waiting."""

    __slots__ = ("_inner", "name")

    def __init__(self, name: Optional[str] = None):
        self._inner = _REAL_RLOCK()
        self.name = name or _caller_site()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        first = not self._inner._is_owned()
        if blocking and first:
            _note_acquire(self)
        ok = self._inner.acquire(blocking, timeout)
        if ok and first:
            _push(self)
        return ok

    def release(self) -> None:
        self._inner.release()
        if not self._inner._is_owned():
            _pop(self)

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: Any) -> None:
        self.release()

    # Condition integration: wait() fully releases via _release_save.
    def _release_save(self) -> Any:
        _pop(self)
        return self._inner._release_save()

    def _acquire_restore(self, state: Any) -> None:
        self._inner._acquire_restore(state)
        _push(self)

    def _is_owned(self) -> bool:
        return self._inner._is_owned()

    def _at_fork_reinit(self) -> None:
        self._inner._at_fork_reinit()
        _tls.__dict__.clear()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name}>"


def _checked_sleep(secs: float) -> None:
    held = _held()
    if held and not getattr(_tls, "reporting", False):
        names = tuple(lk.name for lk, _ in held)
        _report("blocking_under_lock",
                f"time.sleep({secs!r}) while holding {', '.join(names)}",
                names)
    _REAL_SLEEP(secs)


def install() -> None:
    """Swap the threading lock factories + time.sleep. Idempotent. Locks
    constructed BEFORE install (import-time singletons) stay raw — the
    detector watches the per-object locks the system creates at runtime."""
    global _installed, _REAL_LOCK, _REAL_RLOCK, _REAL_SLEEP
    if _installed:
        return
    _REAL_LOCK = threading.Lock
    _REAL_RLOCK = threading.RLock
    _REAL_SLEEP = time.sleep
    global hold_threshold_s
    hold_threshold_s = _read_hold_threshold()
    threading.Lock = DebugLock          # type: ignore[assignment]
    threading.RLock = DebugRLock        # type: ignore[assignment]
    time.sleep = _checked_sleep         # type: ignore[assignment]
    _installed = True
    LOG.info("debug-locks: installed (hold threshold %.0fms)",
             _hold_threshold() * 1e3)


def uninstall() -> None:
    global _installed
    if not _installed:
        return
    threading.Lock = _REAL_LOCK         # type: ignore[assignment]
    threading.RLock = _REAL_RLOCK       # type: ignore[assignment]
    time.sleep = _REAL_SLEEP            # type: ignore[assignment]
    _installed = False


def installed() -> bool:
    return _installed


def install_from_env() -> bool:
    if os.environ.get(ENV_VAR, "") == "1":
        install()
        return True
    return False
