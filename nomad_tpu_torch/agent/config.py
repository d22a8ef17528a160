"""Agent config files: HCL/JSON (reference: command/agent/config.go,
config_parse.go).

Supports the reference's block layout:

  region = "global"
  datacenter = "dc1"
  data_dir = "/var/lib/nomad"
  bind_addr = "0.0.0.0"
  ports { http = 4646 }
  server { enabled = true  num_schedulers = 4 }
  client { enabled = true  node_class = "foo"  meta { k = "v" }
           options { "driver.raw_exec.enable" = "1" } }

Ported from nomad_tpu/agent/config.py. Beyond the imports, the server
block takes `device = "cuda" | "cpu"`: where the server's node table and
placement kernels run (AgentConfig.device, "cuda" when absent).
"""

from __future__ import annotations

import json

from nomad_tpu_torch.jobspec.hcl import parse as parse_hcl
from nomad_tpu_torch.jobspec.parse import parse_duration

from .agent import AgentConfig


def load_config_file(path: str) -> AgentConfig:
    """One file, or a DIRECTORY of .hcl/.json files merged in sorted order
    (later files override; nested blocks merge key-wise) — the reference
    accepts config directories the same way (command/agent/config.go
    LoadConfigDir), and the shipped systemd unit points at /etc/nomad-tpu."""
    import os

    if os.path.isdir(path):
        merged: dict = {}
        for name in sorted(os.listdir(path)):
            if not (name.endswith(".hcl") or name.endswith(".json")):
                continue
            _merge(merged, _parse_one(os.path.join(path, name)))
        if not merged:
            raise ValueError(f"no .hcl/.json config files in {path}")
        return config_from_dict(merged)
    return config_from_dict(_parse_one(path))


def _parse_one(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    if path.endswith(".json"):
        return json.loads(text)
    return parse_hcl(text)


def _merge(base: dict, extra: dict) -> None:
    for key, value in extra.items():
        if isinstance(value, dict) and isinstance(base.get(key), dict):
            _merge(base[key], value)
        else:
            base[key] = value


def config_from_dict(data: dict) -> AgentConfig:
    cfg = AgentConfig()
    cfg.region = data.get("region", cfg.region)
    cfg.datacenter = data.get("datacenter", cfg.datacenter)
    cfg.node_name = data.get("name", cfg.node_name)
    cfg.data_dir = data.get("data_dir", cfg.data_dir)
    cfg.enable_syslog = bool(data.get("enable_syslog", cfg.enable_syslog))
    cfg.enable_debug = bool(data.get("enable_debug", cfg.enable_debug))
    cfg.bind_addr = data.get("bind_addr", cfg.bind_addr)
    ports = data.get("ports") or {}
    cfg.http_port = int(ports.get("http", cfg.http_port))
    cfg.rpc_port = int(ports.get("rpc", cfg.rpc_port))
    cfg.serf_port = int(ports.get("serf", cfg.serf_port))

    server = data.get("server") or {}
    cfg.server_enabled = bool(server.get("enabled", False))
    cfg.num_schedulers = int(server.get("num_schedulers", cfg.num_schedulers))
    cfg.bootstrap_expect = int(server.get("bootstrap_expect",
                                          cfg.bootstrap_expect))
    join = server.get("start_join") or []
    cfg.start_join = [join] if isinstance(join, str) else list(join)
    cfg.scheduler_window = int(server.get("scheduler_window",
                                          cfg.scheduler_window))
    cfg.pipelined_scheduling = bool(server.get("pipelined_scheduling",
                                               cfg.pipelined_scheduling))
    cfg.scheduler_mesh = server.get("scheduler_mesh", cfg.scheduler_mesh)
    cfg.device = server.get("device", cfg.device)
    # Event broker ring size (server { event_buffer_size = 8192 });
    # 0 disables the broker and /v1/event/stream (README "Event stream").
    cfg.event_buffer_size = int(server.get("event_buffer_size",
                                           cfg.event_buffer_size))
    # QoS knobs (server { qos { enabled = true high_floor = 70 ... } });
    # passed through as a plain dict and materialized into a QoSConfig by
    # the agent (README "QoS & SLO serving" documents each knob).
    cfg.qos = dict(server.get("qos") or {})
    # Federation knobs (server { federation { enabled = true
    # max_staleness_s = 0.25 ... } }); same pass-through contract —
    # unknown keys fail at server boot (README "Federation").
    cfg.federation = dict(server.get("federation") or {})

    telemetry = data.get("telemetry") or {}
    cfg.statsd_addr = telemetry.get("statsd_address", cfg.statsd_addr)
    if "collection_interval" in telemetry:
        # Bare numbers mean SECONDS here (an interval config, not a wire
        # duration): interpreting 30 as 30ns would silently floor to the
        # sink minimum. Strings take Go duration syntax ("10s", "1m").
        raw = telemetry["collection_interval"]
        if isinstance(raw, (int, float)):
            cfg.telemetry_interval = float(raw)
        else:
            cfg.telemetry_interval = parse_duration(raw) / 1e9
    cfg.trace_enabled = bool(telemetry.get("trace", cfg.trace_enabled))
    cfg.trace_sample_ratio = float(
        telemetry.get("trace_sample_ratio", cfg.trace_sample_ratio))
    cfg.trace_ring = int(telemetry.get("trace_ring", cfg.trace_ring))

    client = data.get("client") or {}
    cfg.client_enabled = bool(client.get("enabled", False))
    cfg.node_class = client.get("node_class", "")
    servers = client.get("servers") or []
    cfg.servers = [servers] if isinstance(servers, str) else list(servers)
    cfg.server_discovery_url = client.get("server_discovery_url",
                                          cfg.server_discovery_url)
    cfg.meta = {k: str(v) for k, v in (client.get("meta") or {}).items()}
    cfg.options = {k: str(v) for k, v in (client.get("options") or {}).items()}

    # TLS for the RPC mux (reference: config.go TLSConfig; tls {} block).
    tls = data.get("tls") or {}
    cfg.tls_enable_rpc = bool(tls.get("rpc", cfg.tls_enable_rpc))
    cfg.tls_ca_file = tls.get("ca_file", cfg.tls_ca_file)
    cfg.tls_cert_file = tls.get("cert_file", cfg.tls_cert_file)
    cfg.tls_key_file = tls.get("key_file", cfg.tls_key_file)
    cfg.tls_verify_incoming = bool(tls.get("verify_incoming",
                                           cfg.tls_verify_incoming))
    return cfg
