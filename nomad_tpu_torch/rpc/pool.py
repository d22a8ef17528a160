"""Connection pool: one multiplexed connection per target with seq-routed
concurrent requests and reconnect (reference: nomad/pool.go ConnPool — pooled
yamux sessions with stream reuse; here sequence multiplexing serves the same
concurrency purpose with one socket).

Copied from nomad_tpu/rpc/pool.py; only the imports differ.
"""

from __future__ import annotations

import itertools
import socket
import threading
from typing import Any, Dict, Optional

from nomad_tpu_torch.resilience import failpoints
from nomad_tpu_torch.resilience.retry import Backoff, RetryPolicy
from nomad_tpu_torch.telemetry import trace

from .wire import RPC_NOMAD, MessageCodec, recv_frame, send_frame


class RPCError(Exception):
    """Remote handler raised; .remote_type carries the exception class name
    so callers can react to NotLeaderError etc. across the wire."""

    def __init__(self, message: str):
        super().__init__(message)
        self.remote_type = message.split(":", 1)[0] if ":" in message else ""


class ConnError(Exception):
    pass


class DroppedRPCError(ConnError):
    """A request black-holed by the `rpc.server.handle` drop failpoint.
    Distinct from plain ConnError so the RPC server kills only injected
    drops: a REAL ConnError out of a handler (e.g. a dead leader
    forward) still serializes to the caller as a remote error, exactly
    as it did before failpoints existed."""


class _Conn:
    def __init__(self, addr: str, stream_type: int, timeout: float,
                 tls_context=None):
        host, port = addr.rsplit(":", 1)
        self.sock = socket.create_connection((host, int(port)),
                                             timeout=timeout)
        if tls_context is not None:
            # TLS byte in plaintext, handshake, then the inner stream type
            # rides encrypted (reference: rpc.go rpcTLS).
            from .wire import RPC_TLS

            self.sock.sendall(bytes([RPC_TLS]))
            self.sock = tls_context.wrap_socket(
                self.sock,
                server_hostname=host if tls_context.check_hostname
                else None)
        self.sock.settimeout(None)
        self.sock.sendall(bytes([stream_type]))
        self._seq = itertools.count(1)
        self._send_lock = threading.Lock()
        self._waiters: Dict[int, "queue_like"] = {}
        self._waiter_lock = threading.Lock()
        self._dead = False
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name=f"rpc-pool-read-{addr}")
        self._reader.start()

    def _read_loop(self) -> None:
        while True:
            try:
                frame = recv_frame(self.sock)
            except OSError:
                frame = None
            if frame is None:
                self._fail_all()
                return
            with self._waiter_lock:
                waiter = self._waiters.pop(frame.get("Seq", -1), None)
            if waiter is not None:
                waiter["frame"] = frame
                waiter["event"].set()

    def _fail_all(self) -> None:
        self._dead = True
        try:
            # Close promptly: a half-open CLOSE_WAIT socket pins the peer's
            # port in FIN_WAIT_2 and blocks listener rebinds.
            self.sock.close()
        except OSError:
            pass
        with self._waiter_lock:
            waiters = list(self._waiters.values())
            self._waiters.clear()
        for w in waiters:
            w["event"].set()

    def call(self, method: str, body: Any,
             timeout: Optional[float]) -> Any:
        if self._dead:
            raise ConnError("connection closed")
        seq = next(self._seq)
        waiter = {"event": threading.Event(), "frame": None}
        with self._waiter_lock:
            self._waiters[seq] = waiter
        try:
            with self._send_lock:
                # lint: allow(lock_blocking, lock exists to serialize socket writes)
                send_frame(self.sock, MessageCodec.request(
                    seq, method, body, trace=trace.inject()))
        except OSError as exc:
            with self._waiter_lock:
                self._waiters.pop(seq, None)
            self._fail_all()
            raise ConnError(str(exc))
        if not waiter["event"].wait(timeout):
            with self._waiter_lock:
                self._waiters.pop(seq, None)
            raise TimeoutError(f"rpc {method} timed out")
        frame = waiter["frame"]
        if frame is None:
            raise ConnError("connection closed mid-request")
        if "Error" in frame:
            raise RPCError(frame["Error"])
        return frame.get("Body")

    def close(self) -> None:
        self._dead = True
        try:
            self.sock.close()
        except OSError:
            pass


class ConnPool:
    """addr -> shared multiplexed connection, created on demand, dropped on
    failure (reference: pool.go:111-180 acquire/release lifecycle)."""

    def __init__(self, stream_type: int = RPC_NOMAD,
                 connect_timeout: float = 5.0,
                 call_timeout: float = 330.0,
                 tls_context=None):
        # call_timeout must exceed the 300s blocking-query cap PLUS the
        # server's herd jitter of up to wait/16 (300 * 17/16 = 318.75s;
        # reference: rpc.go:33-47 maxQueryTime + :334-343 jitter).
        self.stream_type = stream_type
        self.connect_timeout = connect_timeout
        self.call_timeout = call_timeout
        self.tls_context = tls_context
        self._conns: Dict[str, _Conn] = {}
        self._lock = threading.Lock()
        self._addr_locks: Dict[str, threading.Lock] = {}

    def _get(self, addr: str) -> _Conn:
        with self._lock:
            conn = self._conns.get(addr)
            if conn is not None and not conn._dead:
                return conn
            addr_lock = self._addr_locks.setdefault(addr, threading.Lock())
        # Connect outside the pool-wide lock: raft heartbeats to every peer
        # share this pool, so a hung connect to one partitioned address must
        # not stall calls to healthy peers for connect_timeout seconds.
        with addr_lock:
            with self._lock:
                conn = self._conns.get(addr)
                if conn is not None and not conn._dead:
                    return conn
            conn = _Conn(addr, self.stream_type, self.connect_timeout,
                         tls_context=self.tls_context)
            with self._lock:
                self._conns[addr] = conn
            return conn

    def call(self, addr: str, method: str, body: Any = None,
             timeout: Optional[float] = None) -> Any:
        """One RPC. Retries once through a fresh connection on transport
        failure (NOT on remote errors) via the shared RetryPolicy."""
        timeout = timeout if timeout is not None else self.call_timeout
        if failpoints.fire("rpc.pool.call") == "drop":
            raise ConnError(f"rpc {method} to {addr} dropped (failpoint)")

        def evict_stale(exc, attempt, delay):
            with self._lock:
                stale = self._conns.pop(addr, None)
            if stale is not None:
                stale.close()

        policy = RetryPolicy(max_attempts=2,
                             backoff=Backoff(base=0.005, cap=0.05),
                             retry_on=(ConnError, OSError),
                             on_retry=evict_stale)
        return policy.call(
            lambda: self._get(addr).call(method, body, timeout))

    def close(self) -> None:
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            c.close()
