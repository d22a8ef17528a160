"""TLS for the single-port RPC mux (reference: nomad/rpc.go:25-30 reserves
the rpcTLS stream byte; handleConn:88-132 unwraps it and re-reads the inner
stream type; TLSConfig in nomad/config.go).

Mutual TLS: the server presents its cert and (verify_incoming) requires a
client cert signed by the same CA; outgoing connections present the node
cert and verify the server against the CA. One CA per cluster region is the
deployment model.

Copied from nomad_tpu/rpc/tls.py; only the imports differ.
"""

from __future__ import annotations

import ssl
from dataclasses import dataclass
from typing import Optional


@dataclass
class TLSConfig:
    """(reference: nomad/config.go TLSConfig)"""

    enable_rpc: bool = False
    ca_file: str = ""
    cert_file: str = ""
    key_file: str = ""
    # Require client certs signed by the CA (mutual TLS) and refuse
    # plaintext streams entirely.
    verify_incoming: bool = True
    # Verify the server cert's hostname on outgoing connections. Off by
    # default: cluster members dial each other by IP:port and certs are
    # typically issued per-role, not per-host (reference default).
    verify_server_hostname: bool = False


def server_context(cfg: TLSConfig) -> Optional[ssl.SSLContext]:
    if not cfg.enable_rpc:
        return None
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cfg.cert_file, cfg.key_file)
    if cfg.ca_file:
        ctx.load_verify_locations(cfg.ca_file)
    if cfg.verify_incoming:
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def client_context(cfg: TLSConfig) -> Optional[ssl.SSLContext]:
    if not cfg.enable_rpc:
        return None
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    if cfg.ca_file:
        ctx.load_verify_locations(cfg.ca_file)
    ctx.check_hostname = cfg.verify_server_hostname
    ctx.verify_mode = ssl.CERT_REQUIRED
    if cfg.cert_file:
        ctx.load_cert_chain(cfg.cert_file, cfg.key_file)
    return ctx
