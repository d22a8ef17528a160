"""HTTP API (reference: command/agent/http.go + *_endpoint.go).

Serves the /v1 API over a stdlib threading HTTP server: jobs, nodes,
allocations, evaluations, client fs/stats, agent, status, regions, system GC,
with blocking-query support (`index` + `wait` params) wired to state-store
watches and the same JSON envelope/headers as the reference (X-Nomad-Index,
error text bodies, 4xx/5xx codes).

Copied from nomad_tpu/agent/http.py; only the imports differ.
"""

from __future__ import annotations

import json
import logging
import re
import sys
import threading
import traceback
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

from nomad_tpu_torch.qos import QoSBackpressureError
from nomad_tpu_torch.rpc.pool import RPCError
from nomad_tpu_torch.state.watch import Item
from nomad_tpu_torch.structs import Job, from_dict, job_stub, to_dict

logger = logging.getLogger("nomad.http")

MAX_WAIT = 300.0  # blocking query cap (reference: rpc.go:33-43)


class CodedError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class HTTPServer:
    def __init__(self, agent, host: str = "127.0.0.1", port: int = 4646):
        self.agent = agent
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        handler = _make_handler(self.agent)
        self._httpd = ThreadingHTTPServer((self.host, self.port), handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="http")
        self._thread.start()
        logger.info("http: listening on %s:%d", self.host, self.port)

    def shutdown(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()


def _accepts_gzip(header: str) -> bool:
    """True when the Accept-Encoding header permits gzip — a bare substring
    match would treat the explicit refusal 'gzip;q=0' as acceptance."""
    for part in header.split(","):
        token, _, params = part.strip().partition(";")
        if token.strip().lower() not in ("gzip", "*"):
            continue
        q = 1.0
        for p in params.split(";"):
            k, _, v = p.strip().partition("=")
            if k.strip().lower() == "q":
                try:
                    q = float(v)
                except ValueError:
                    q = 0.0
        return q > 0
    return False


def _make_handler(agent):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through logging
            logger.debug("http: " + fmt, *args)

        def _respond(self, obj: Any, index: Optional[int] = None,
                     code: int = 200) -> None:
            if isinstance(obj, bytes):
                # Binary payloads (the cProfile-compatible profile blob):
                # no JSON wrapping, no gzip (already dense marshal data).
                self.send_response(code)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(obj)))
                self.end_headers()
                self.wfile.write(obj)
                return
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            # gzip for clients that accept it (reference: every handler is
            # gzip-wrapped, command/agent/http.go:70-80) — list responses
            # like /v1/allocations run to megabytes of JSON. Small bodies
            # skip it: the header+CPU overhead beats the saved bytes.
            if _accepts_gzip(self.headers.get("Accept-Encoding", "")) \
                    and len(body) >= 1024:
                import gzip as _gzip

                body = _gzip.compress(body, compresslevel=1)
                self.send_header("Content-Encoding", "gzip")
            self.send_header("Content-Length", str(len(body)))
            if index is not None:
                self.send_header("X-Nomad-Index", str(index))
                self.send_header("X-Nomad-KnownLeader", "true")
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, message: str) -> None:
            body = message.encode()
            self.send_response(code)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> Any:
            length = int(self.headers.get("Content-Length", 0))
            if length == 0:
                return None
            return json.loads(self.rfile.read(length))

        def _write_chunk(self, payload: bytes) -> None:
            # Manual chunked transfer-encoding: one frame per chunk so
            # consumers see complete JSON lines as they flush.
            self.wfile.write(b"%X\r\n" % len(payload) + payload + b"\r\n")
            self.wfile.flush()

        def _stream_events(self, query) -> None:
            """GET /v1/event/stream: chunked JSON-lines event frames
            (README "Event stream"). Each chunk is one frame —
            ``{"Index": N, "Events": [...]}`` — or a bare ``{}``
            heartbeat; the stream ends with a ``{"Closed": true,
            "Reason": ...}`` frame when the broker resets or shuts down.
            Streams are REGION-LOCAL: the ring is fed by this region's
            raft log, so a request naming another region is refused
            rather than forwarded (a forwarded stream could not honor
            the from_index resume contract across logs)."""
            from nomad_tpu_torch.events import TOPICS, EventGapError

            if self.command != "GET":
                self._error(405, "method not allowed")
                return
            server = agent.server
            broker = server.fsm.events if server is not None else None
            if broker is None:
                self._error(501, "event streaming requires a server "
                                 "agent with events enabled "
                                 "(server.event_buffer_size > 0)")
                return
            q_region = query.get("region", [""])[0]
            if q_region and q_region != agent.region():
                self._error(400, f"event streams are region-local: this "
                                 f"agent serves region "
                                 f"{agent.region()!r}, not {q_region!r}")
                return
            topics: set = set()
            filters: Dict[str, set] = {}
            for spec in query.get("topic", []):
                topic, _, key = spec.partition(":")
                if topic not in TOPICS:
                    self._error(400, f"unknown topic {topic!r} "
                                     f"(known: {sorted(TOPICS)})")
                    return
                topics.add(topic)
                if key:
                    filters.setdefault(topic, set()).add(key)
            try:
                from_index = int(query.get("index", ["0"])[0])
            except ValueError:
                self._error(400, "index must be an integer")
                return
            fanout = ("fanout" in query
                      and query["fanout"][0] not in ("false", "0"))
            raw_hb = query.get("heartbeat", [""])[0]
            try:
                heartbeat = float(raw_hb) if raw_hb else 10.0
            except ValueError:
                self._error(400, f"heartbeat must be seconds, "
                                 f"got {raw_hb!r}")
                return
            if not (0.05 <= heartbeat <= 60.0):  # NaN-rejecting clamp
                heartbeat = 10.0
            try:
                sub = broker.subscribe(topics=topics or None,
                                       filters=filters,
                                       from_index=from_index,
                                       fanout=fanout)
            except EventGapError as e:
                # 416: the requested window is gone. JSON body so the
                # client can re-snapshot and resubscribe from Floor.
                self._respond({"Error": str(e), "Requested": e.requested,
                               "Floor": e.floor}, code=416)
                return
            # One long-lived response per connection: no keep-alive reuse
            # after a stream (the consumer reconnects to resume).
            self.close_connection = True
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("X-Nomad-Region", agent.region())
            self.end_headers()
            try:
                while True:
                    frame = sub.next(timeout=heartbeat)
                    if frame is None:
                        closed, reason = sub.status()
                        if closed:
                            self._write_chunk(json.dumps(
                                {"Closed": True,
                                 "Reason": reason}).encode() + b"\n")
                            break
                        self._write_chunk(b"{}\n")  # heartbeat
                        continue
                    self._write_chunk(json.dumps(
                        frame, separators=(",", ":")).encode() + b"\n")
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass  # consumer went away; unsubscribe below
            finally:
                broker.unsubscribe(sub)

        def _dispatch(self) -> None:
            parsed = urllib.parse.urlparse(self.path)
            # keep_blank_values: bare flags like `?stale` must survive
            # parsing (parse_qs drops blank-valued params by default).
            query = urllib.parse.parse_qs(parsed.query,
                                          keep_blank_values=True)
            if parsed.path == "/v1/event/stream":
                # Streaming writes chunked frames directly to the socket;
                # it cannot go through route()/_respond (one
                # Content-Length'd body per response).
                self._stream_events(query)
                return
            try:
                result = route(agent, self.command, parsed.path, query,
                               self._body)
            except CodedError as e:
                self._error(e.code, str(e))
                return
            except QoSBackpressureError as e:
                # Admission shed: 429 so clients back off and retry
                # (api/client.py maps this to BackpressureAPIError and
                # re-sends with RetryPolicy — nothing was written).
                self._error(429, str(e))
                return
            except KeyError as e:
                self._error(404, str(e))
                return
            except RPCError as e:
                # A shed raised on a REMOTE server (client-only agent /
                # leader forward) arrives as an RPCError carrying the
                # exception class name; keep the 429 contract.
                if e.remote_type == "QoSBackpressureError":
                    self._error(429, str(e))
                    return
                logger.exception("http: request failed")
                self._error(500, str(e))
                return
            except ValueError as e:
                self._error(400, str(e))
                return
            except Exception as e:
                logger.exception("http: request failed")
                self._error(500, str(e))
                return
            if result is None:
                self._respond(None)
            else:
                obj, index = result
                self._respond(obj, index)

        do_GET = _dispatch
        do_PUT = _dispatch
        do_POST = _dispatch
        do_DELETE = _dispatch

    return Handler


# ---------------------------------------------------------------- routing


def _capture_profile(seconds: float, period: float = 0.005) -> bytes:
    """Sample every live thread's Python stack for `seconds` and return a
    pstats-compatible marshal blob (the format cProfile dumps and
    pstats.Stats loads). Per function: ct approximates wall time anywhere
    on a stack, tt time at the top of one; call counts are sample counts.
    Sampling (vs tracing) is the only approach that can observe every
    server thread without instrumenting them — the same trade the
    reference's pprof CPU profile makes."""
    import marshal

    # {(file, line, name): [cc, nc, tt, ct, {caller: ...}]}
    stats: Dict[tuple, list] = {}
    deadline = time.monotonic() + seconds
    me = threading.get_ident()
    n_samples = 0
    last = time.monotonic()
    while True:
        now = time.monotonic()
        # Credit the MEASURED inter-sample gap, not the nominal period:
        # under GIL contention or deep stacks the real gap stretches well
        # past the sleep, and a fixed credit would undercount wall time.
        dt = now - last
        last = now
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            top = True
            seen = set()
            while frame is not None:
                code = frame.f_code
                key = (code.co_filename, code.co_firstlineno, code.co_name)
                ent = stats.get(key)
                if ent is None:
                    ent = stats[key] = [0, 0, 0.0, 0.0, {}]
                ent[0] += 1
                ent[1] += 1
                if top:
                    ent[2] += dt
                    top = False
                if key not in seen:  # recursion: count wall time once
                    ent[3] += dt
                    seen.add(key)
                frame = frame.f_back
        n_samples += 1
        if now >= deadline:
            break
        # lint: allow(retry, fixed-cadence sampling profiler, not a retry)
        time.sleep(period)
    stats[("~", 0, f"<sampling-profile {n_samples} samples "
           f"@{period * 1e3:g}ms>")] = [n_samples, n_samples, 0.0, 0.0, {}]
    return marshal.dumps({k: tuple(v[:4]) + (v[4],)
                          for k, v in stats.items()})


def _parse_wait(query) -> Tuple[int, float]:
    from nomad_tpu_torch.jobspec import parse_duration

    min_index = int(query.get("index", ["0"])[0])
    wait_raw = query.get("wait", ["0"])[0]
    try:
        wait = float(wait_raw or 0)  # bare number: seconds
    except ValueError:
        wait = parse_duration(wait_raw) / 1e9  # Go duration string
    return min_index, min(wait, MAX_WAIT)


def _blocking(state, items: List[Item], query, run: Callable[[], Tuple[Any, int]]
              ) -> Tuple[Any, int]:
    """Blocking-query wrapper (reference: rpc.go:294-349 blockingRPC)."""
    min_index, wait = _parse_wait(query)
    if min_index <= 0 or wait <= 0:
        return run()
    event = threading.Event()
    state.watch(items, event)
    try:
        deadline = time.monotonic() + wait
        while True:
            obj, index = run()
            if index > min_index:
                return obj, index
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return obj, index
            event.clear()
            event.wait(remaining)
    finally:
        state.stop_watch(items, event)


def _require_write(method: str) -> None:
    if method not in ("PUT", "POST"):
        raise CodedError(405, "method not allowed")


def route(agent, method: str, path: str, query, get_body):
    server = agent.server
    client = agent.client
    state = server.state if server is not None else None
    # A request naming another region, hitting a client-only agent, or
    # needing CONSISTENT reads on a follower is served over RPC (with
    # region/leader forwarding) instead of local state (reference: every
    # HTTP handler goes through agent.RPC and server.forward; `?stale`
    # opts into the local-replica fast path, command/agent/http.go
    # parseConsistency + nomad/rpc.go:177-221). Without the forward, a
    # read right after a write could miss it on a follower that hasn't
    # replicated yet.
    q_region = query.get("region", [""])[0]
    stale_ok = "stale" in query and query["stale"][0] not in ("false", "0")
    remote = (server is None
              or (bool(q_region) and q_region != agent.region())
              or (not stale_ok and not server.is_leader()))

    def rpc(method_name: str, body: dict):
        if q_region:
            body = dict(body, Region=q_region)
        return agent.rpc(method_name, body)

    def rpc_read(method_name: str, body: dict, key: str):
        """Forwarded read with RPC-level blocking-query params."""
        min_index, wait = _parse_wait(query)
        body = dict(body)
        if min_index:
            body["MinQueryIndex"] = min_index
            # Forward `wait` verbatim: index-without-wait returns
            # immediately on the local path and must do the same when the
            # read happens to route through a follower.
            body["MaxQueryTime"] = wait
        if stale_ok:
            body["AllowStale"] = True
        resp = rpc(method_name, body)
        return resp.get(key), resp.get("Index", 0)

    def need_server():
        if server is None:
            raise CodedError(501, "no server running on this agent")
        return server

    def need_client():
        if client is None:
            raise CodedError(501, "no client running on this agent")
        return client

    # ------------------------------ jobs
    if path == "/v1/jobs":
        if method == "GET":
            prefix = query.get("prefix", [""])[0]
            if remote:
                jobs, index = rpc_read("Job.List", {}, "Jobs")
                if prefix:
                    jobs = [j for j in jobs if j["ID"].startswith(prefix)]
                return sorted(jobs, key=lambda j: j["ID"]), index
            need_server()

            def run():
                jobs = state.jobs_by_id_prefix(prefix) if prefix else state.jobs()
                stubs = sorted((to_dict(job_stub(j)) for j in jobs),
                               key=lambda j: j["ID"])
                return stubs, state.get_index("jobs")

            return _blocking(state, [Item(table="jobs")], query, run)
        if method in ("PUT", "POST"):
            payload = get_body()
            enforce = payload.get("EnforceIndex")
            enforce_index = payload.get("JobModifyIndex") if enforce else None
            resp = rpc("Job.Register", {
                "Job": payload.get("Job"), "EnforceIndex": enforce_index})
            resp["EvalCreateIndex"] = resp["Index"]
            return resp, resp["Index"]
        raise CodedError(405, "method not allowed")

    m = re.match(r"^/v1/job/([^/]+)$", path)
    if m:
        job_id = urllib.parse.unquote(m.group(1))
        if method == "GET":
            if remote:
                job, index = rpc_read("Job.GetJob", {"JobID": job_id}, "Job")
                if job is None:
                    raise KeyError(f"job not found: {job_id}")
                return job, index
            need_server()

            def run():
                job = state.job_by_id(job_id)
                if job is None:
                    raise KeyError(f"job not found: {job_id}")
                return to_dict(job), state.get_index("jobs")

            return _blocking(state, [Item(job=job_id)], query, run)
        if method in ("PUT", "POST"):
            payload = get_body()
            resp = rpc("Job.Register", {"Job": payload.get("Job")})
            return resp, resp["Index"]
        if method == "DELETE":
            resp = rpc("Job.Deregister", {"JobID": job_id})
            return resp, resp["Index"]
        raise CodedError(405, "method not allowed")

    m = re.match(r"^/v1/job/([^/]+)/plan$", path)
    if m:
        _require_write(method)
        payload = get_body()
        job = from_dict(Job, payload.get("Job"))
        if job is None:
            raise CodedError(400, "Job must be specified")
        path_id = urllib.parse.unquote(m.group(1))
        if job.ID != path_id:
            raise CodedError(400, "Job ID does not match")
        want_diff = bool(payload.get("Diff"))
        resp = rpc("Job.Plan", {"Job": payload.get("Job"),
                                      "Diff": want_diff})
        return (resp, resp.get("JobModifyIndex", 0))

    m = re.match(r"^/v1/job/([^/]+)/allocations$", path)
    if m:
        job_id = urllib.parse.unquote(m.group(1))
        if remote:
            return rpc_read("Job.Allocations", {"JobID": job_id},
                            "Allocations")
        need_server()

        def run():
            allocs = [to_dict(a.stub()) for a in state.allocs_by_job(job_id)]
            return allocs, state.get_index("allocs")

        return _blocking(state, [Item(alloc_job=job_id)], query, run)

    m = re.match(r"^/v1/job/([^/]+)/evaluations$", path)
    if m:
        job_id = urllib.parse.unquote(m.group(1))
        if remote:
            return rpc_read("Job.Evaluations", {"JobID": job_id},
                            "Evaluations")
        need_server()

        def run():
            evals = [to_dict(e) for e in state.evals_by_job(job_id)]
            return evals, state.get_index("evals")

        return _blocking(state, [Item(table="evals")], query, run)

    m = re.match(r"^/v1/job/([^/]+)/evaluate$", path)
    if m:
        _require_write(method)
        resp = rpc("Job.Evaluate",
                         {"JobID": urllib.parse.unquote(m.group(1))})
        return (resp, resp["Index"])

    m = re.match(r"^/v1/job/([^/]+)/periodic/force$", path)
    if m:
        _require_write(method)
        rpc("Periodic.Force",
                  {"JobID": urllib.parse.unquote(m.group(1))})
        index = state.latest_index() if state is not None else 0
        return ({"Index": index}, index)

    # ------------------------------ nodes
    if path == "/v1/nodes":
        prefix = query.get("prefix", [""])[0]
        if remote:
            stubs, index = rpc_read("Node.List", {}, "Nodes")
            if prefix:
                stubs = [n for n in stubs if n["ID"].startswith(prefix)]
            return stubs, index
        need_server()


        def run():
            stubs = sorted((to_dict(n.stub()) for n in state.nodes()
                            if n.ID.startswith(prefix)),
                           key=lambda n: n["ID"])
            return stubs, state.get_index("nodes")

        return _blocking(state, [Item(table="nodes")], query, run)

    m = re.match(r"^/v1/node/([^/]+)$", path)
    if m:
        node_id = urllib.parse.unquote(m.group(1))
        if method == "GET" and remote:
            node, index = rpc_read("Node.GetNode", {"NodeID": node_id},
                                   "Node")
            if node is None:
                raise KeyError(f"node not found: {node_id}")
            return node, index
        need_server()

        def run():
            node = state.node_by_id(node_id)
            if node is None:
                raise KeyError(f"node not found: {node_id}")
            return to_dict(node), state.get_index("nodes")

        return _blocking(state, [Item(node=node_id)], query, run)

    m = re.match(r"^/v1/node/([^/]+)/allocations$", path)
    if m:
        node_id = urllib.parse.unquote(m.group(1))
        if remote:
            return rpc_read("Node.GetAllocs", {"NodeID": node_id}, "Allocs")
        need_server()

        def run():
            allocs = [to_dict(a) for a in state.allocs_by_node(node_id)]
            return allocs, state.get_index("allocs")

        return _blocking(state, [Item(alloc_node=node_id)], query, run)

    m = re.match(r"^/v1/node/([^/]+)/drain$", path)
    if m:
        _require_write(method)
        enable = query.get("enable", ["false"])[0].lower() in ("1", "true")
        resp = rpc("Node.UpdateDrain",
                         {"NodeID": urllib.parse.unquote(m.group(1)),
                          "Drain": enable})
        return (resp, resp["Index"])

    m = re.match(r"^/v1/node/([^/]+)/evaluate$", path)
    if m:
        _require_write(method)
        resp = rpc("Node.Evaluate",
                         {"NodeID": urllib.parse.unquote(m.group(1))})
        index = state.latest_index() if state is not None else 0
        return ({"EvalIDs": resp["EvalIDs"], "Index": index}, index)

    # ------------------------------ allocations
    if path == "/v1/allocations":
        prefix = query.get("prefix", [""])[0]
        if remote:
            allocs, index = rpc_read("Alloc.List", {}, "Allocations")
            if prefix:
                allocs = [a for a in allocs if a["ID"].startswith(prefix)]
            return allocs, index
        need_server()


        def run():
            allocs = sorted((to_dict(a.stub()) for a in state.allocs()
                             if a.ID.startswith(prefix)),
                            key=lambda a: a["ID"])
            return allocs, state.get_index("allocs")

        return _blocking(state, [Item(table="allocs")], query, run)

    m = re.match(r"^/v1/allocation/([^/]+)$", path)
    if m:
        alloc_id = urllib.parse.unquote(m.group(1))
        if remote:
            alloc, index = rpc_read("Alloc.GetAlloc", {"AllocID": alloc_id},
                                    "Alloc")
        else:
            need_server()
            found = state.alloc_by_id(alloc_id)
            alloc = to_dict(found) if found else None
            index = state.get_index("allocs")
        if alloc is None:
            raise KeyError(f"alloc not found: {alloc_id}")
        return alloc, index

    # ------------------------------ service registry
    if path == "/v1/services":
        if remote:
            regs, index = rpc_read("Service.List", {}, "Services")
            return sorted(regs, key=lambda s: s["ID"]), index
        need_server()

        def run():
            regs = sorted((to_dict(s) for s in state.services()),
                          key=lambda s: s["ID"])
            return regs, state.get_index("services")

        return _blocking(state, [Item(table="services")], query, run)

    m = re.match(r"^/v1/service/([^/]+)$", path)
    if m:
        name = urllib.parse.unquote(m.group(1))
        if remote:
            regs, index = rpc_read("Service.GetService",
                                   {"ServiceName": name}, "Services")
            return sorted(regs, key=lambda s: s["ID"]), index
        need_server()

        def run():
            regs = state.services_by_name(name)
            # Table index, not max(ModifyIndex): a delete must not regress
            # the reported index (see Service.GetService).
            return sorted((to_dict(r) for r in regs),
                          key=lambda s: s["ID"]), state.get_index("services")

        return _blocking(state, [Item(service_name=name)], query, run)

    # ------------------------------ evaluations
    if path == "/v1/evaluations":
        prefix = query.get("prefix", [""])[0]
        if remote:
            evals, index = rpc_read("Eval.List", {}, "Evaluations")
            if prefix:
                evals = [e for e in evals if e["ID"].startswith(prefix)]
            return sorted(evals, key=lambda e: e["ID"]), index
        need_server()


        def run():
            evals = sorted((to_dict(e) for e in state.evals()
                            if e.ID.startswith(prefix)),
                           key=lambda e: e["ID"])
            return evals, state.get_index("evals")

        return _blocking(state, [Item(table="evals")], query, run)

    m = re.match(r"^/v1/evaluation/([^/]+)$", path)
    if m:
        eval_id = urllib.parse.unquote(m.group(1))
        if remote:
            ev, index = rpc_read("Eval.GetEval", {"EvalID": eval_id}, "Eval")
            if ev is None:
                raise KeyError(f"eval not found: {eval_id}")
            return ev, index
        need_server()

        def run():
            ev = state.eval_by_id(eval_id)
            if ev is None:
                raise KeyError(f"eval not found: {eval_id}")
            return to_dict(ev), state.get_index("evals")

        return _blocking(state, [Item(eval=eval_id)], query, run)

    m = re.match(r"^/v1/evaluation/([^/]+)/allocations$", path)
    if m:
        eval_id = urllib.parse.unquote(m.group(1))
        if remote:
            return rpc_read("Eval.Allocations", {"EvalID": eval_id},
                            "Allocations")
        need_server()
        allocs = [to_dict(a.stub()) for a in state.allocs_by_eval(eval_id)]
        return allocs, state.get_index("allocs")

    # ------------------------------ client fs + stats
    m = re.match(r"^/v1/client/fs/(ls|stat|cat|readat)/([^/]+)$", path)
    if m:
        op = m.group(1)
        alloc_id = urllib.parse.unquote(m.group(2))
        fs = need_client().get_alloc_fs(alloc_id)
        if fs is None:
            raise KeyError(f"alloc not found on client: {alloc_id}")
        rel = query.get("path", ["/"])[0]
        if op == "ls":
            return [to_dict(fi) for fi in fs.list_dir(rel)], None
        if op == "stat":
            return to_dict(fs.stat(rel)), None
        offset = int(query.get("offset", ["0"])[0])
        limit = int(query.get("limit", ["-1"])[0])
        data = fs.read_at(rel, offset, limit)
        return data.decode("utf-8", "replace"), None

    if path == "/v1/client/stats":
        return need_client().stats(), None

    m = re.match(r"^/v1/client/allocation/([^/]+)/stats$", path)
    if m:
        alloc_id = urllib.parse.unquote(m.group(1))
        return need_client().alloc_stats(alloc_id), None

    # ------------------------------ agent / status / regions / system
    if path == "/v1/agent/self":
        out = {"config": agent.self_config(), "member": agent.member_info()}
        return out, None
    if path == "/v1/agent/members":
        return agent.members(), None
    if path == "/v1/agent/monitor":
        # Recent agent log lines; `after=<seq>` polls incrementally
        # (reference capability: the log streaming behind `nomad monitor`
        # / log_writer.go).
        lines = int(query.get("lines", ["200"])[0])
        after = int(query.get("after", ["0"])[0])
        entries, seq = agent.log_ring.tail(lines, after)
        return {"Lines": [line for _, line in entries], "Seq": seq}, None

    if path == "/v1/agent/debug/stacks":
        # The runtime-profiling hook, gated exactly like the reference's
        # pprof routes (command/agent/http.go registers them only when
        # debug is enabled): stack traces leak code structure, so the
        # agent must opt in.
        if not getattr(agent.config, "enable_debug", False):
            raise CodedError(404, "debug endpoints disabled "
                                  "(set enable_debug)")
        frames = sys._current_frames()
        stacks = {}
        for t in threading.enumerate():
            frame = frames.get(t.ident)
            if frame is None:
                continue
            stacks[f"{t.name} ({t.ident})"] = traceback.format_stack(frame)
        return stacks, None

    if path == "/v1/agent/debug/profile":
        # Whole-process CPU profile capture, the analogue of the
        # reference's pprof CPU endpoint (command/agent/http.go:133-139,
        # mounted only under enable_debug). A tracing profiler would need
        # a hook in every server thread; instead a sampler walks
        # sys._current_frames() for `seconds` (5ms period) and synthesizes
        # a standard pstats marshal blob — load it with
        # pstats.Stats(path_to_saved_body). Sample counts scale to
        # seconds: ct ~ wall time a function was anywhere on a stack,
        # tt ~ time it was at the top.
        if not getattr(agent.config, "enable_debug", False):
            raise CodedError(404, "debug endpoints disabled "
                                  "(set enable_debug)")
        raw_seconds = query.get("seconds", ["2"])[0]
        try:
            seconds = float(raw_seconds)
        except ValueError:
            raise CodedError(400, f"invalid seconds value "
                                  f"{raw_seconds!r}: not a number")
        if not (0.0 < seconds <= 30.0):  # NaN-rejecting clamp
            seconds = 2.0
        return _capture_profile(seconds), None

    if path == "/v1/agent/debug/faults":
        # Fault-injection control (resilience/failpoints.py), debug-gated
        # like stacks/profile: arming a failpoint is an operational
        # hazard, so the agent must opt in. GET lists every known site
        # with its armed spec and lifetime trigger count; PUT/POST arms
        # from the shared spec grammar (?spec=... or {"Spec": ...});
        # DELETE (or {"DisarmAll": true}) heals everything.
        if not getattr(agent.config, "enable_debug", False):
            raise CodedError(404, "debug endpoints disabled "
                                  "(set enable_debug)")
        from nomad_tpu_torch.resilience import failpoints

        if method == "GET":
            return {"Sites": failpoints.snapshot()}, None
        if method == "DELETE":
            failpoints.disarm_all()
            return {"DisarmedAll": True}, None
        _require_write(method)
        payload = get_body()
        if isinstance(payload, dict) and payload.get("DisarmAll"):
            failpoints.disarm_all()
            return {"DisarmedAll": True}, None
        spec = query.get("spec", [""])[0]
        if not spec and isinstance(payload, dict):
            spec = payload.get("Spec", "")
        if not isinstance(spec, str):
            raise CodedError(400, f"Spec must be a string, "
                                  f"got {type(spec).__name__}")
        if not spec:
            raise CodedError(400, "need ?spec=site=mode[:p=..][:count=..]"
                                  " or a {\"Spec\": ...} body")
        try:
            touched = failpoints.arm_from_spec(spec)
        except ValueError as e:
            raise CodedError(400, str(e))
        return {"Touched": touched, "Sites": failpoints.snapshot()}, None

    if path == "/v1/agent/debug/trace":
        # Evaluation-lifecycle tracing (telemetry/trace.py), debug-gated
        # like faults/stacks/profile. GET lists retained traces (or one
        # full trace with ?id=..., Chrome trace-event JSON with
        # &format=chrome); PUT reconfigures ({"Enabled":..,
        # "SampleRatio":.., "Ring":..}); DELETE clears collected traces.
        if not getattr(agent.config, "enable_debug", False):
            raise CodedError(404, "debug endpoints disabled "
                                  "(set enable_debug)")
        from nomad_tpu_torch.telemetry import trace as _trace

        if method == "GET":
            trace_id = query.get("id", [""])[0]
            fmt = query.get("format", [""])[0]
            full = _trace.get_trace(trace_id) if trace_id else None
            if trace_id and full is None:
                # Unknown ids 404 on BOTH paths — the chrome exporter
                # would otherwise 200 an empty, useless file.
                raise KeyError(f"trace not found: {trace_id}")
            if fmt == "chrome":
                return _trace.export_chrome(trace_id or None), None
            if trace_id:
                return {"Trace": full}, None
            out = _trace.status()
            entries = _trace.traces()
            # limit/after pagination over the newest-last summary list.
            # `after` is a TraceID cursor: resume just past it. A cursor
            # whose trace was evicted restarts from the oldest retained
            # entry (the ring is bounded — stale cursors are normal in a
            # poll loop, not an error).
            after = query.get("after", [""])[0]
            if after:
                for i, entry in enumerate(entries):
                    if entry["TraceID"] == after:
                        entries = entries[i + 1:]
                        break
            raw_limit = query.get("limit", [""])[0]
            if raw_limit:
                try:
                    limit = int(raw_limit)
                except ValueError:
                    raise CodedError(400, f"limit must be an integer, "
                                          f"got {raw_limit!r}")
                if limit <= 0:
                    raise CodedError(400, f"limit must be positive, "
                                          f"got {limit}")
                if len(entries) > limit:
                    entries = entries[:limit]
                    out["NextAfter"] = entries[-1]["TraceID"]
            out["Traces"] = entries
            return out, None
        if method == "DELETE":
            _trace.clear()
            return {"Cleared": True}, None
        _require_write(method)
        payload = get_body() or {}
        if not isinstance(payload, dict):
            raise CodedError(400, "body must be a JSON object")
        try:
            _trace.configure(
                enabled=payload.get("Enabled"),
                sample_ratio=payload.get("SampleRatio"),
                ring=payload.get("Ring"))
        except (TypeError, ValueError) as e:
            raise CodedError(400, str(e))
        return _trace.status(), None

    if path == "/v1/agent/debug/sched-stats":
        # Scheduling-pipeline observability: the same per-worker stage
        # timers and flow counters bench.py prints (PipelinedWorker.stats,
        # one declared schema — see README "Serving pipeline
        # observability"). Debug-gated like stacks/profile: stage timings
        # leak workload shape, so the agent must opt in.
        if not getattr(agent.config, "enable_debug", False):
            raise CodedError(404, "debug endpoints disabled "
                                  "(set enable_debug)")
        srv = need_server()
        workers = []
        by_worker: Dict[str, Any] = {}
        totals: Dict[str, Any] = {}
        for i, w in enumerate(getattr(srv, "workers", [])):
            stats = getattr(w, "stats", None)
            # ONE snapshot feeds the worker entry, the by-name map, and
            # the totals: the worker threads mutate the live dict, and
            # two reads could make Totals disagree with Workers[].Stats
            # in the same response.
            snap = dict(stats) if stats is not None else None
            name = getattr(w, "name", None) or f"worker-{i}"
            workers.append({
                "Index": i,
                "Name": name,
                "Type": type(w).__name__,
                "Window": getattr(w, "window", None),
                "Stats": snap,
            })
            if snap is not None:
                # Per-worker stats keyed by worker name: a scaling
                # regression (one worker starved, one convoying on the
                # chain lease) is invisible in the aggregate.
                by_worker[name] = snap
                for k, v in snap.items():
                    if isinstance(v, (int, float)):
                        totals[k] = totals.get(k, 0) + v
        qos_out: Dict[str, Any] = {"Enabled": False}
        srv_qos = getattr(srv, "qos", None)
        if srv_qos is not None and srv_qos.enabled:
            # Per-tier queue depth / SLO burn / promotions from the
            # broker, plus admission + preemption flow counters — the
            # operator's view of whether tiers are actually being served
            # within their deadlines (README "QoS & SLO serving").
            qos_out = {"Enabled": True,
                       **srv.eval_broker.qos_stats(),
                       "Counters": srv.qos_counters.snapshot()}
        # Columnar-store counters: segment/live-row/promoted counts plus
        # committed batches split by commit path (system sweep vs service
        # window) — which path a storm took (README "Columnar state
        # store").
        store_out = None
        state = getattr(srv, "state", None)
        col_stats = getattr(state, "columnar_stats", None)
        if col_stats is not None:
            store_out = col_stats()
        # Federation block: local snapshot-source behavior (reuse vs
        # refresh, current age), parked foreign-region evals, and the
        # polled per-region health view (README "Federation").
        fed_out: Dict[str, Any] = {"Enabled": False}
        if getattr(srv, "fed_health", None) is not None:
            fed_out = {
                "Enabled": True,
                "Region": srv.config.region,
                "Snapshots": (srv.fed_source.stats()
                              if srv.fed_source is not None else None),
                "ForeignParked": srv.eval_broker.foreign_count(),
                "Regions": srv.fed_health.snapshot(),
            }
        # Replica-digest block: this replica's chain position, verified
        # watermark, sync mode, and fold/exchange/divergence counters
        # (README "Replica determinism"). None when digests are disabled.
        digest = getattr(getattr(srv, "fsm", None), "digest", None)
        digest_out = digest.stats() if digest is not None else None
        return {"Workers": workers, "ByWorker": by_worker,
                "Totals": totals, "QoS": qos_out, "Store": store_out,
                "Federation": fed_out, "Digest": digest_out}, None

    if path == "/v1/agent/metrics":
        # In-memory telemetry snapshot (reference shape: go-metrics
        # DisplayMetrics behind the agent metrics endpoint).
        from nomad_tpu_torch.telemetry import metrics as _metrics
        return _metrics.snapshot(), None
    if path == "/v1/agent/join":
        _require_write(method)
        addrs = query.get("address", [])
        return {"num_joined": agent.gossip_join(addrs)}, None
    if path == "/v1/agent/force-leave":
        _require_write(method)
        node = query.get("node", [""])[0]
        return {"ok": agent.gossip_force_leave(node)}, None
    if path == "/v1/agent/servers":
        return agent.server_addresses(), None
    if path == "/v1/status/leader":
        if remote:
            return rpc("Status.Leader", {}), None
        return agent.leader_address(), None
    if path == "/v1/status/peers":
        return rpc("Status.Peers", {}), None
    if path == "/v1/regions":
        # gossip-derived region list when federated (reference:
        # Region.List over the serf peers map, region_endpoint.go)
        try:
            return sorted(agent.rpc("Region.List", {})), None
        except ValueError:
            return [agent.region()], None
    if path == "/v1/system/gc":
        _require_write(method)
        rpc("System.GC", {})
        return None
    raise CodedError(404, f"no handler for {path}")
