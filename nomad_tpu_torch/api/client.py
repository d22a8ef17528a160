"""API client library (reference: api/api.go, api/jobs.go, api/nodes.go,
api/allocations.go, api/evaluations.go, api/fs.go, api/agent.go).

Typed wrappers over the /v1 HTTP API with blocking-query support
(QueryOptions.wait_index / wait_time -> `index`/`wait` params, last index
read back from X-Nomad-Index).

Copied from nomad_tpu/api/client.py; only the imports differ.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from nomad_tpu_torch.resilience.retry import Backoff, RetryPolicy
from nomad_tpu_torch.structs import Job, from_dict, to_dict


class APIError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(f"Unexpected response code: {code} ({message})")
        self.code = code


class BackpressureAPIError(APIError):
    """HTTP 429: the submission was shed by QoS admission control
    (server-side QoSBackpressureError). Safe to retry — the server
    rejected BEFORE writing anything — and the client does so
    automatically with RetryPolicy (``backpressure_retries``)."""


class EventGapAPIError(APIError):
    """HTTP 416 from /v1/event/stream: the requested resume index
    precedes the server's retained event window — events were evicted
    (or predate a snapshot install) and can NEVER be replayed. Not
    retryable: the consumer must re-snapshot state via the list APIs and
    resubscribe from ``floor`` (or 0 for "live from now")."""

    def __init__(self, code: int, message: str,
                 requested: int = 0, floor: int = 0):
        super().__init__(code, message)
        self.requested = requested
        self.floor = floor


@dataclass
class QueryOptions:
    region: str = ""
    prefix: str = ""
    wait_index: int = 0
    wait_time: float = 0.0  # seconds


@dataclass
class WriteOptions:
    region: str = ""


@dataclass
class QueryMeta:
    last_index: int = 0
    known_leader: bool = False


class Client:
    def __init__(self, address: str = "http://127.0.0.1:4646",
                 region: str = "", retries: int = 3,
                 backpressure_retries: int = 4):
        self.address = address.rstrip("/")
        self.region = region
        # Transient-transport retry budget for idempotent reads (an agent
        # mid-restart, a briefly unreachable listener). Writes never
        # retry automatically: re-sending a register is not idempotent
        # from the caller's perspective (duplicate evals).
        self.retries = max(1, retries)
        # QoS backpressure (HTTP 429) retry budget — applies to writes
        # too: a shed submission was rejected BEFORE any server write, so
        # re-sending cannot duplicate anything. 1 disables (the 429
        # surfaces as BackpressureAPIError).
        self.backpressure_retries = max(1, backpressure_retries)
        self.jobs = Jobs(self)
        self.nodes = Nodes(self)
        self.allocations = Allocations(self)
        self.evaluations = Evaluations(self)
        self.agent = Agent(self)
        self.regions = Regions(self)
        self.services = Services(self)
        self.system = System(self)
        self.alloc_fs = AllocFS(self)

    # ------------------------------------------------------------ plumbing
    def _url(self, path: str, params: Optional[Dict[str, str]] = None) -> str:
        url = self.address + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        return url

    def _params(self, q: Optional[QueryOptions]) -> Dict[str, str]:
        params: Dict[str, str] = {}
        region = (q.region if q else "") or self.region
        if region:
            params["region"] = region
        if q is not None:
            if q.prefix:
                params["prefix"] = q.prefix
            if q.wait_index:
                params["index"] = str(q.wait_index)
            if q.wait_time:
                params["wait"] = f"{q.wait_time}s"
        return params

    def request(self, method: str, path: str,
                params: Optional[Dict[str, str]] = None,
                body: Any = None,
                timeout: float = 330.0) -> Tuple[Any, QueryMeta]:
        def once() -> Tuple[Any, QueryMeta]:
            data = json.dumps(body).encode() if body is not None else None
            req = urllib.request.Request(self._url(path, params), data=data,
                                         method=method)
            if data is not None:
                req.add_header("Content-Type", "application/json")
            req.add_header("Accept-Encoding", "gzip")
            try:
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    raw = resp.read()
                    if resp.headers.get("Content-Encoding") == "gzip":
                        import gzip

                        raw = gzip.decompress(raw)
                    meta = QueryMeta(
                        last_index=int(resp.headers.get("X-Nomad-Index", 0)),
                        known_leader=resp.headers.get(
                            "X-Nomad-KnownLeader", "") == "true")
                    return (json.loads(raw) if raw else None), meta
            except urllib.error.HTTPError as e:
                body_text = e.read().decode(errors="replace")
                if e.code == 429:
                    raise BackpressureAPIError(e.code, body_text) from e
                raise APIError(e.code, body_text) from e

        if method != "GET" or self.retries <= 1:
            if self.backpressure_retries <= 1:
                return once()
            # Writes retry ONLY typed backpressure (QoS admission shed):
            # nothing was written server-side, so a jittered re-send is
            # safe where a blind transport retry would not be.
            policy = RetryPolicy(max_attempts=self.backpressure_retries,
                                 backoff=Backoff(base=0.25, cap=3.0),
                                 retry_on=(BackpressureAPIError,))
            return policy.call(once)

        def transient(exc: BaseException) -> bool:
            # A timed-out request already waited the full budget; against
            # a wedged (accepting-but-silent) agent, re-waiting it
            # retries-times over turns one hang into several. Only
            # connection-level failures (refused/reset mid-restart) are
            # worth re-trying.
            return not isinstance(getattr(exc, "reason", exc),
                                  TimeoutError)

        # HTTPError never reaches the policy (mapped to APIError above),
        # so retry_on=URLError is purely transport-level failures.
        policy = RetryPolicy(max_attempts=self.retries,
                             backoff=Backoff(base=0.1, cap=2.0),
                             retry_on=(urllib.error.URLError,
                                       ConnectionError),
                             should_retry=transient)
        return policy.call(once)

    def event_stream(self, topics: Optional[List[str]] = None,
                     from_index: int = 0, fanout: bool = False,
                     heartbeat: float = 10.0,
                     yield_heartbeats: bool = False,
                     reconnect_attempts: Optional[int] = None):
        """Follow /v1/event/stream: yields event frames
        ``{"Index": N, "Events": [...]}`` in raft-index order, forever.

        Resume is automatic: the iterator tracks the last delivered
        index, and a transport drop mid-stream (agent restart, leader
        kill, broker reset) reconnects with ``index=<last seen>`` under
        a jittered RetryPolicy — the server replays its retained window
        after that index, so the consumer observes a gapless,
        duplicate-free continuation. A resume that falls off the
        retained window raises :class:`EventGapAPIError` (HTTP 416);
        that is not retried — the consumer must re-snapshot state.

        ``topics`` entries are ``"Topic"`` or ``"Topic:key"`` selectors;
        ``fanout=True`` asks the server to expand AllocationBatch events
        into per-alloc rows; heartbeats (empty frames proving liveness)
        are swallowed unless ``yield_heartbeats``.
        """
        last = int(from_index)
        attempts = (self.retries if reconnect_attempts is None
                    else reconnect_attempts)

        def connect():
            params: List[Tuple[str, str]] = []
            if self.region:
                params.append(("region", self.region))
            for t in (topics or ()):
                params.append(("topic", t))
            params.append(("index", str(last)))
            if fanout:
                params.append(("fanout", "true"))
            params.append(("heartbeat", str(heartbeat)))
            url = (self.address + "/v1/event/stream?"
                   + urllib.parse.urlencode(params))
            req = urllib.request.Request(url, method="GET")
            try:
                # Read timeout must comfortably exceed the heartbeat
                # cadence — a healthy-but-quiet stream is not a hang.
                return urllib.request.urlopen(
                    req, timeout=max(30.0, heartbeat * 3))
            except urllib.error.HTTPError as e:
                body_text = e.read().decode(errors="replace")
                if e.code == 416:
                    try:
                        info = json.loads(body_text)
                    except ValueError:
                        info = {}
                    raise EventGapAPIError(
                        e.code, body_text,
                        requested=int(info.get("Requested", last)),
                        floor=int(info.get("Floor", 0))) from e
                raise APIError(e.code, body_text) from e

        policy = RetryPolicy(max_attempts=max(1, attempts),
                             backoff=Backoff(base=0.25, cap=5.0),
                             retry_on=(urllib.error.URLError,
                                       ConnectionError))
        # lint: allow(retry, reconnect loop around RetryPolicy-backed
        # connects — each successful frame resets the budget by design)
        while True:
            resp = policy.call(connect)
            try:
                for line in resp:
                    line = line.strip()
                    if not line:
                        continue
                    frame = json.loads(line)
                    if frame.get("Closed"):
                        # Broker reset/shutdown: reconnect and resume
                        # from the last delivered index; a real gap
                        # surfaces as EventGapAPIError on reconnect.
                        break
                    if "Events" not in frame:
                        if yield_heartbeats:
                            yield frame
                        continue
                    last = int(frame.get("Index", last))
                    yield frame
            except (urllib.error.URLError, ConnectionError, OSError):
                pass  # transport drop mid-stream: resume from `last`
            finally:
                try:
                    resp.close()
                except OSError:
                    pass

    def get(self, path: str, q: Optional[QueryOptions] = None):
        return self.request("GET", path, self._params(q))

    def put(self, path: str, body: Any = None,
            w: Optional[WriteOptions] = None,
            params: Optional[Dict[str, str]] = None):
        merged = self._params(None)
        if params:
            merged.update(params)
        return self.request("PUT", path, merged, body)

    def delete(self, path: str):
        return self.request("DELETE", path, self._params(None))


class Jobs:
    """(reference: api/jobs.go)"""

    def __init__(self, c: Client):
        self.c = c

    def register(self, job: Job, enforce_index: Optional[int] = None
                 ) -> Tuple[str, QueryMeta]:
        eval_id, _, meta = self.register_with_warnings(job, enforce_index)
        return eval_id, meta

    def register_with_warnings(
            self, job: Job, enforce_index: Optional[int] = None
    ) -> Tuple[str, List[str], QueryMeta]:
        """Register, also returning server-side validation warnings
        (reference: JobRegisterResponse.Warnings — e.g. accepted-but-
        ignored driver config keys)."""
        body: Dict[str, Any] = {"Job": to_dict(job)}
        if enforce_index is not None:
            body["EnforceIndex"] = True
            body["JobModifyIndex"] = enforce_index
        out, meta = self.c.put("/v1/jobs", body)
        return out.get("EvalID", ""), list(out.get("Warnings") or ()), meta

    def list(self, q: Optional[QueryOptions] = None):
        return self.c.get("/v1/jobs", q)

    def info(self, job_id: str, q: Optional[QueryOptions] = None) -> Tuple[Job, QueryMeta]:
        out, meta = self.c.get(f"/v1/job/{urllib.parse.quote(job_id)}", q)
        return from_dict(Job, out), meta

    def deregister(self, job_id: str) -> Tuple[str, QueryMeta]:
        out, meta = self.c.delete(f"/v1/job/{urllib.parse.quote(job_id)}")
        return out.get("EvalID", ""), meta

    def plan(self, job: Job, diff: bool = True
             ) -> Tuple["JobPlanResponse", QueryMeta]:
        """Dry-run scheduling (reference: api/jobs.go:144-160 Jobs.Plan)."""
        from nomad_tpu_torch.structs import JobPlanResponse
        from nomad_tpu_torch.structs.diff import JobDiff

        body = {"Job": to_dict(job), "Diff": diff}
        out, meta = self.c.put(
            f"/v1/job/{urllib.parse.quote(job.ID)}/plan", body)
        resp = from_dict(JobPlanResponse, out)
        if resp.Diff is not None:
            resp.Diff = from_dict(JobDiff, resp.Diff)
        return resp, meta

    def allocations(self, job_id: str, q: Optional[QueryOptions] = None):
        return self.c.get(f"/v1/job/{urllib.parse.quote(job_id)}/allocations", q)

    def evaluations(self, job_id: str, q: Optional[QueryOptions] = None):
        return self.c.get(f"/v1/job/{urllib.parse.quote(job_id)}/evaluations", q)

    def force_evaluate(self, job_id: str) -> Tuple[str, QueryMeta]:
        out, meta = self.c.put(f"/v1/job/{urllib.parse.quote(job_id)}/evaluate")
        return out.get("EvalID", ""), meta

    def periodic_force(self, job_id: str):
        return self.c.put(
            f"/v1/job/{urllib.parse.quote(job_id)}/periodic/force")


class Nodes:
    """(reference: api/nodes.go)"""

    def __init__(self, c: Client):
        self.c = c

    def list(self, q: Optional[QueryOptions] = None):
        return self.c.get("/v1/nodes", q)

    def info(self, node_id: str, q: Optional[QueryOptions] = None):
        return self.c.get(f"/v1/node/{node_id}", q)

    def allocations(self, node_id: str, q: Optional[QueryOptions] = None):
        return self.c.get(f"/v1/node/{node_id}/allocations", q)

    def toggle_drain(self, node_id: str, drain: bool):
        return self.c.put(f"/v1/node/{node_id}/drain",
                          params={"enable": "true" if drain else "false"})

    def force_evaluate(self, node_id: str):
        return self.c.put(f"/v1/node/{node_id}/evaluate")


class Allocations:
    def __init__(self, c: Client):
        self.c = c

    def list(self, q: Optional[QueryOptions] = None):
        return self.c.get("/v1/allocations", q)

    def info(self, alloc_id: str, q: Optional[QueryOptions] = None):
        return self.c.get(f"/v1/allocation/{alloc_id}", q)

    def stats(self, alloc_id: str):
        """Live task resource usage from the client agent running the alloc
        (reference: /v1/client/allocation/<id>/stats)."""
        return self.c.get(f"/v1/client/allocation/{alloc_id}/stats")


class Evaluations:
    def __init__(self, c: Client):
        self.c = c

    def list(self, q: Optional[QueryOptions] = None):
        return self.c.get("/v1/evaluations", q)

    def info(self, eval_id: str, q: Optional[QueryOptions] = None):
        return self.c.get(f"/v1/evaluation/{eval_id}", q)

    def allocations(self, eval_id: str, q: Optional[QueryOptions] = None):
        return self.c.get(f"/v1/evaluation/{eval_id}/allocations", q)


class AllocFS:
    """(reference: api/fs.go)"""

    def __init__(self, c: Client):
        self.c = c

    def list(self, alloc_id: str, path: str = "/"):
        return self.c.request("GET", f"/v1/client/fs/ls/{alloc_id}",
                              {"path": path})[0]

    def stat(self, alloc_id: str, path: str):
        return self.c.request("GET", f"/v1/client/fs/stat/{alloc_id}",
                              {"path": path})[0]

    def cat(self, alloc_id: str, path: str) -> str:
        return self.c.request("GET", f"/v1/client/fs/cat/{alloc_id}",
                              {"path": path})[0]

    def read_at(self, alloc_id: str, path: str, offset: int, limit: int) -> str:
        return self.c.request("GET", f"/v1/client/fs/readat/{alloc_id}",
                              {"path": path, "offset": str(offset),
                               "limit": str(limit)})[0]


class Agent:
    def __init__(self, c: Client):
        self.c = c

    def self(self):
        return self.c.get("/v1/agent/self")[0]

    def members(self):
        return self.c.get("/v1/agent/members")[0]

    def metrics(self):
        """Telemetry snapshot (gauges/counters/samples)."""
        return self.c.get("/v1/agent/metrics")[0]

    def join(self, addresses):
        """(reference: api/agent.go Join)"""
        qs = "&".join("address=" + urllib.parse.quote(a) for a in addresses)
        return self.c.request("PUT", f"/v1/agent/join?{qs}")[0]

    def force_leave(self, node: str):
        """(reference: api/agent.go ForceLeave)"""
        qs = "node=" + urllib.parse.quote(node)
        return self.c.request("PUT", f"/v1/agent/force-leave?{qs}")[0]

    def servers(self):
        return self.c.get("/v1/agent/servers")[0]

    # Fault-injection control (debug-gated; resilience/failpoints.py)
    def faults(self):
        return self.c.get("/v1/agent/debug/faults")[0]

    def arm_faults(self, spec: str):
        return self.c.put("/v1/agent/debug/faults", {"Spec": spec})[0]

    def disarm_faults(self):
        return self.c.delete("/v1/agent/debug/faults")[0]

    def sched_stats(self):
        """Scheduling-pipeline stage timers/counters (debug-gated)."""
        return self.c.get("/v1/agent/debug/sched-stats")[0]

    # Evaluation-lifecycle tracing (debug-gated; telemetry/trace.py)
    def traces(self, limit: Optional[int] = None, after: str = ""):
        """Status + summaries of retained traces. ``limit`` caps the
        page; ``after`` is the TraceID cursor from the previous page's
        ``NextAfter`` (present only when the listing was truncated)."""
        params: Dict[str, str] = {}
        if limit is not None:
            params["limit"] = str(limit)
        if after:
            params["after"] = after
        return self.c.request("GET", "/v1/agent/debug/trace",
                              params or None)[0]

    def trace(self, trace_id: str, chrome: bool = False):
        """One full trace; ``chrome=True`` returns Chrome trace-event
        JSON loadable in Perfetto."""
        params = {"id": trace_id}
        if chrome:
            params["format"] = "chrome"
        return self.c.request("GET", "/v1/agent/debug/trace", params)[0]

    def trace_export(self):
        """Chrome trace-event JSON of every retained trace."""
        return self.c.request("GET", "/v1/agent/debug/trace",
                              {"format": "chrome"})[0]

    def configure_trace(self, enabled=None, sample_ratio=None, ring=None):
        body = {}
        if enabled is not None:
            body["Enabled"] = bool(enabled)
        if sample_ratio is not None:
            body["SampleRatio"] = float(sample_ratio)
        if ring is not None:
            body["Ring"] = int(ring)
        return self.c.put("/v1/agent/debug/trace", body)[0]

    def clear_traces(self):
        return self.c.delete("/v1/agent/debug/trace")[0]


class Services:
    """Service registry queries (/v1/services, /v1/service/<name>)."""

    def __init__(self, c: Client):
        self.c = c

    def list(self, q: Optional[QueryOptions] = None):
        return self.c.get("/v1/services", q)

    def get(self, name: str, q: Optional[QueryOptions] = None):
        return self.c.get(f"/v1/service/{urllib.parse.quote(name)}", q)


class Regions:
    def __init__(self, c: Client):
        self.c = c

    def list(self):
        return self.c.get("/v1/regions")[0]


class System:
    def __init__(self, c: Client):
        self.c = c

    def garbage_collect(self):
        return self.c.put("/v1/system/gc")
