"""The port's RPC layer (nomad_tpu_torch/rpc) against the reference's.

A `ConnPool` -> `RPCServer` -> `Endpoints` round trip on a CPU dev server
of each package: the same calls give the same answers (their keys, and
the values that are not ids or indexes), and a remote error comes back as
the same `RPCError`. The wire: for the same bodies, both packages write
byte-identical frames, and each reads the other's."""

import socket
import time

import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu.rpc import ConnPool as RefConnPool
from nomad_tpu.rpc import Endpoints as RefEndpoints
from nomad_tpu.rpc import RPCError as RefRPCError
from nomad_tpu.rpc import RPCServer as RefRPCServer
from nomad_tpu.rpc import wire as ref_wire
from nomad_tpu.server.server import Server as RefServer
from nomad_tpu.server.server import ServerConfig as RefServerConfig
from nomad_tpu.structs import to_dict as ref_to_dict
from nomad_tpu_torch import rpc
from nomad_tpu_torch.rpc import wire
from nomad_tpu_torch.server import Server, ServerConfig

BODIES = [
    {},
    {"Seq": 1, "Method": "Status.Ping", "Body": None},
    {"Seq": 2 ** 40, "Body": {"Job": {"ID": "j", "Priority": 50,
                                      "Meta": {"k": "ü✓"}}}},
    {"Seq": 3, "Body": [1, -2, 3.5, True, False, None, b"\x00\xff",
                        "x" * 300, list(range(20))]},
    {"Seq": 4, "Error": "rpc error: unknown method"},
    {"Seq": 5, "Body": {"Nested": {"Deep": {"Deeper": [{"a": 1e-300}]}}}},
]


def _frame(mod, body):
    a, b = socket.socketpair()
    try:
        mod.send_frame(a, body)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            chunk = b.recv(65536)
            if not chunk:
                return b"".join(chunks)
            chunks.append(chunk)
    finally:
        a.close()
        b.close()


def _read(mod, raw):
    a, b = socket.socketpair()
    try:
        a.sendall(raw)
        a.shutdown(socket.SHUT_WR)
        return mod.recv_frame(b)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("body", BODIES)
def test_frames_are_byte_identical(body):
    raw = _frame(wire, body)
    assert raw == _frame(ref_wire, body)
    assert _read(ref_wire, raw) == _read(wire, raw) == body


def test_envelopes_and_constants():
    for name in ("RPC_NOMAD", "RPC_RAFT", "RPC_TLS", "MAX_FRAME"):
        assert getattr(wire, name) == getattr(ref_wire, name)
    for args in ((7, "Job.Register", {"Job": {}}),
                 (8, "Node.List", None, {"TraceID": "t", "SpanID": "s"})):
        assert wire.MessageCodec.request(*args) == \
            ref_wire.MessageCodec.request(*args)
        assert _frame(wire, wire.MessageCodec.request(*args)) == \
            _frame(ref_wire, ref_wire.MessageCodec.request(*args))
    assert wire.MessageCodec.response(9, {"a": 1}) == \
        ref_wire.MessageCodec.response(9, {"a": 1})
    assert wire.MessageCodec.response(9, error="x") == \
        ref_wire.MessageCodec.response(9, error="x")


def test_oversized_frame_refused():
    import struct

    raw = struct.pack("<I", wire.MAX_FRAME + 1)
    a, b = socket.socketpair()
    try:
        a.sendall(raw)
        with pytest.raises(wire.WireError):
            wire.recv_frame(b)
    finally:
        a.close()
        b.close()


class _Stack:
    def __init__(self, server, endpoints_cls, server_cls, pool_cls):
        self.server = server
        server.establish_leadership()
        self.endpoints = endpoints_cls(server)
        self.rpc = server_cls(rpc_handler=self.endpoints.handle)
        self.rpc.start()
        self.pool = pool_cls()

    def call(self, method, body=None):
        return self.pool.call(self.rpc.addr, method, body)

    def close(self):
        self.pool.close()
        self.rpc.shutdown()
        self.server.shutdown()


@pytest.fixture()
def stacks():
    ref = _Stack(RefServer(RefServerConfig(num_schedulers=1)), RefEndpoints,
                 RefRPCServer, RefConnPool)
    port = _Stack(Server(ServerConfig(num_schedulers=1, device="cpu")),
                  rpc.Endpoints, rpc.RPCServer, rpc.ConnPool)
    try:
        yield ref, port
    finally:
        port.close()
        ref.close()


def _keys(x):
    if isinstance(x, dict):
        return {k: _keys(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_keys(v) for v in x]
    return type(x).__name__


def both(stacks, method, body=None):
    ref, port = stacks
    got, want = port.call(method, body), ref.call(method, body)
    assert _keys(got) == _keys(want), method
    return got, want


def _wait_complete(stack, eval_id):
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        ev = stack.call("Eval.GetEval", {"EvalID": eval_id})["Eval"]
        if ev and ev["Status"] == "complete":
            return ev
        time.sleep(0.02)
    raise AssertionError(f"eval {eval_id} never completed")


def test_round_trip_through_the_pool(stacks):
    ref, port = stacks
    got, want = both(stacks, "Status.Ping")
    assert got == want
    nodes = [ref_to_dict(ref_mock.node()) for _ in range(3)]
    for node in nodes:
        got, want = both(stacks, "Node.Register", {"Node": node})
        assert got["HeartbeatTTL"] > 0
    got, want = both(stacks, "Node.List")
    assert sorted(n["ID"] for n in got["Nodes"]) == \
        sorted(n["ID"] for n in want["Nodes"]) == sorted(
            n["ID"] for n in nodes)
    job = ref_to_dict(ref_mock.job())
    job["TaskGroups"][0]["Count"] = 4
    got, want = both(stacks, "Job.Register", {"Job": job})
    evals = [_wait_complete(s, r["EvalID"])
             for s, r in ((port, got), (ref, want))]
    assert evals[0]["Status"] == evals[1]["Status"] == "complete"
    got, want = both(stacks, "Job.GetJob", {"JobID": job["ID"]})
    assert got["Job"]["TaskGroups"] == want["Job"]["TaskGroups"]
    got, want = both(stacks, "Job.Allocations", {"JobID": job["ID"]})
    assert len(got["Allocations"]) == len(want["Allocations"]) == 4
    got, want = both(stacks, "Job.Plan", {"Job": job, "Diff": True})
    assert got["Diff"] == want["Diff"]
    assert got["Annotations"] == want["Annotations"]


def test_remote_errors_come_back_alike(stacks):
    ref, port = stacks
    with pytest.raises(rpc.RPCError) as got:
        port.call("Bogus.Method", {})
    with pytest.raises(RefRPCError) as want:
        ref.call("Bogus.Method", {})
    assert str(got.value) == str(want.value)
    with pytest.raises(rpc.RPCError) as got:
        port.call("Job.GetJob", {})
    with pytest.raises(RefRPCError) as want:
        ref.call("Job.GetJob", {})
    assert str(got.value) == str(want.value)


def test_self_service_registration_through_rpc(stacks):
    ref, port = stacks
    for stack in stacks:
        assert stack.server.register_self_service(stack.rpc.addr,
                                                  "127.0.0.1:4646") > 0
    got, want = both(stacks, "Service.List", {})
    names = lambda out: sorted(  # noqa: E731
        s["ServiceName"] for s in out["Services"])
    assert names(got) == names(want) and "nomad-server" in names(got)
