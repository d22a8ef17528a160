"""RPC listener: accepts connections, demuxes stream types, dispatches
msgpack-RPC requests on worker threads (reference: nomad/rpc.go:56-132
listen/handleConn + the per-request goroutine model of net/rpc).

Copied from nomad_tpu/rpc/server.py; only the imports differ.
"""

from __future__ import annotations

import logging
import socket
import threading
from typing import Any, Callable, Dict, Optional

from nomad_tpu_torch.telemetry import trace

from .pool import DroppedRPCError
from .wire import (
    RPC_NOMAD,
    RPC_RAFT,
    RPC_TLS,
    MessageCodec,
    recv_frame,
    send_frame,
)

logger = logging.getLogger("nomad.rpc")

Handler = Callable[[str, Any], Any]


class RPCServer:
    """One TCP port for both application RPC and raft traffic; with a TLS
    context, TLS-prefixed streams unwrap and re-dispatch (reference:
    rpc.go:88-132 handleConn's rpcTLS arm)."""

    def __init__(self, bind_addr: str = "127.0.0.1", port: int = 0,
                 rpc_handler: Optional[Handler] = None,
                 raft_handler: Optional[Handler] = None,
                 tls_context=None, require_tls: bool = False):
        self.rpc_handler = rpc_handler
        self.raft_handler = raft_handler
        self.tls_context = tls_context
        # verify_incoming semantics: plaintext streams are refused outright.
        self.require_tls = require_tls
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((bind_addr, port))
        self._sock.listen(128)
        self.addr = "%s:%d" % self._sock.getsockname()[:2]
        self._shutdown = threading.Event()
        self._conns: set = set()
        self._lock = threading.Lock()
        self._accept_thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name=f"rpc-{self.addr}")
        self._accept_thread.start()

    def shutdown(self) -> None:
        self._shutdown.set()
        try:
            # shutdown() wakes the blocked accept(); close() alone leaves
            # the kernel socket alive under the accept thread on Linux.
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    # -------------------------------------------------------------- accept
    def _accept_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            with self._lock:
                self._conns.add(conn)
            threading.Thread(target=self._handle_conn, args=(conn,),
                             daemon=True, name="rpc-conn").start()

    def _handle_conn(self, conn: socket.socket) -> None:
        """(reference: handleConn byte-prefix dispatch, rpc.go:88-132)"""
        try:
            prefix = conn.recv(1)
            if not prefix:
                return
            stream_type = prefix[0]
            if stream_type == RPC_TLS:
                if self.tls_context is None:
                    logger.warning(
                        "rpc: TLS connection attempted, server not "
                        "configured for TLS")
                    return
                import ssl

                raw = conn
                try:
                    conn = self.tls_context.wrap_socket(conn,
                                                        server_side=True)
                except (ssl.SSLError, OSError) as e:
                    logger.warning("rpc: TLS handshake failed: %s", e)
                    return
                # Track the SSLSocket, not the detached raw socket: the
                # finally-block discard and shutdown()'s force-close must
                # see the live object.
                with self._lock:
                    self._conns.discard(raw)
                    self._conns.add(conn)
                inner = conn.recv(1)
                if not inner:
                    return
                stream_type = inner[0]
            elif self.require_tls:
                logger.warning(
                    "rpc: non-TLS connection rejected (verify_incoming)")
                return
            if stream_type == RPC_NOMAD:
                self._serve_rpc(conn, self.rpc_handler)
            elif stream_type == RPC_RAFT:
                self._serve_rpc(conn, self.raft_handler)
            else:
                logger.warning("rpc: unknown stream type %#x", stream_type)
        except OSError:
            pass
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _serve_rpc(self, conn: socket.socket, handler: Optional[Handler]
                   ) -> None:
        if handler is None:
            return
        send_lock = threading.Lock()
        while not self._shutdown.is_set():
            try:
                frame = recv_frame(conn)
            except OSError:
                return
            if frame is None:
                return
            # Each request on its own thread: blocking queries must not
            # head-of-line block the stream (reference: rpc.go:294-349).
            threading.Thread(
                target=self._dispatch,
                args=(conn, send_lock, handler, frame), daemon=True,
                name=f"rpc-dispatch-{frame.get('Method', '?')}").start()

    def _dispatch(self, conn: socket.socket, send_lock: threading.Lock,
                  handler: Handler, frame: Dict[str, Any]) -> None:
        seq = frame.get("Seq", 0)
        try:
            # Attach the caller's trace context (if the envelope carried
            # one) so handler spans join the remote trace.
            with trace.attach(frame.get("Trace")):
                result = handler(frame["Method"], frame.get("Body"))
            resp = MessageCodec.response(seq, body=result)
        except DroppedRPCError:
            # A black-holed request (rpc.server.handle drop failpoint):
            # kill the connection instead of answering, so the caller
            # sees a transport failure and runs its failover path. Only
            # the injected type — a real ConnError out of a handler
            # (dead leader forward) serializes as a remote error like
            # any other handler exception.
            try:
                conn.close()
            except OSError:
                pass
            return
        # lint: allow(swallow, error crosses the wire as the RPC response)
        except Exception as exc:  # errors cross the wire as strings
            resp = MessageCodec.response(seq, error=_err_string(exc))
        try:
            with send_lock:
                # lint: allow(lock_blocking, lock exists to serialize socket writes)
                send_frame(conn, resp)
        except OSError:
            pass


def _err_string(exc: Exception) -> str:
    """Stable, parseable error strings (the reference forwards well-known
    errors like structs.ErrNoLeader by string match, rpc.go:207-216)."""
    name = type(exc).__name__
    return f"{name}: {exc}"
