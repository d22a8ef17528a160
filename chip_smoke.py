"""Drive nomad_tpu_torch's placement and served paths on one CUDA card.

    python3 chip_smoke.py [--phases kernels,storm,served-identity,served,
                                    mesh,mesh-served-identity,mesh-served,
                                    system,placer,agent,cluster]
                          [--package-root DIR]

Builds the CUDA kernels of nomad_tpu_torch/csrc with nvcc (sm_90a), then:

  kernels  each kernel against its plain PyTorch version on the card, at the
           placement path's shapes: rows, n_feasible and usage must be
           identical and scores within 4e-6 absolute; kernel, plain and
           (where one PyTorch call computes the same function) library times.
           K2, K3 and K4a at the served storm's window (T = 1, 4,096 steps,
           a reset every 64, 50 valid of 64, a 4,096-candidate table; K4a's
           microseconds per step), at the per-eval storm's P = 64 and at
           varied and deep windows; K4a's edge cases (exact ties, distinct
           on and off, all-infeasible steps, key and demand changes mid-run,
           winners through padding runs, tables above the shared-memory
           budget or no multiple of the segment, 3 and 7 resource
           dimensions, 40 keys) and the select's at K2's and K8's shapes
           (exact ties, k = 1, k = n, several keys, a starved key), each bit
           for bit against the plain version; torch.topk as K2's yardstick.
           K4b at every refresh chunk size from a block on the card and
           from a pinned host block it reads in place (the main path), with
           a row past the table and repeated padding rows; K5 at three
           window shapes into a block on the card and into one pinned host
           block it writes in place (the main path); each bit for bit
           against its plain version. An empty kernel's time, the floor of
           a launch.
  storm    the slice at full width, through the entry points a user calls:
           a 10,000-node fleet in 64 computed classes (BASELINE config 3,
           16,384 table rows), 100 service evals of 50 placements, one batch
           job (forced down the scan route) and one distinct_hosts job, each
           through Harness + GenericScheduler with a seeded rng, then a
           destructive re-register of one job (evictions and placements in
           one plan). It runs through the kernels (timed, untraced), through
           the plain versions on the card, and through the kernels again
           under the device trace (busy share); the placements and the
           committed usage must be identical, every kernel must have launched
           in the kernel runs and no plain version may have run there.
  served-identity
           the served path's window at full width: a dev server with
           10,000 nodes, one pipelined worker driven by hand through a
           64-eval storm window (Count = 50: one fused launch over 4,096
           steps, K5's multi layout) and a mixed window (a distinct_hosts
           job and a two-group job: K5's stacked singles), once through the
           kernels and once inside `native.plain_versions()`, with the same
           tie-break noise. Both must commit the same placements and usage;
           K2, K3, K4a, K4b and K5 must launch in the kernel run and no
           plain version may run there.
  served   `bench.py`'s bench_server_e2e shape on the port: a dev server
           (`device="cuda"`, one pipelined worker, window 64, heartbeat TTLs
           parked), 10,000 nodes, warm-up storms, then three untraced
           timed storms of 600 evals x 50 placements each (evals/s,
           placements/s, p50 / p99 eval latency, the worker's stage timers,
           launches per kernel; the median rate) and a traced storm of the
           same shape (device busy share, device time by kernel), plus the
           worker's per-window node cache time (`t_nodecache_ms`) and the
           device time of the window's table snapshot; the host ms per
           window of the snapshot's refresh (`t_refresh_ms`) and of the
           drain plan (`t_drain_stack_ms`), and the traced storm's copies
           (host->device, device->host) and CUDA runtime calls that
           synchronize or copy. Then a probe of the dirty-row refresh on
           the served table (50 usage rows): its host ms on an idle stream
           and right behind a kernel of about 1 ms, and its copies and
           syncs traced. Every
           eval must
           complete through a fused window (no slow or fallback eval), no
           node may be over capacity, the device usage must equal the host
           mirror after quiesce and no plain version may run.
  mesh     the shard-local keyed mesh pipeline at bench_mesh_1m's shape
           (`bench.py:106-118`): 1,048,576 node rows, T = 1, one storm
           window of P = 1,024 steps with 800 valid placements (k = 1,024,
           B = 2,048), S = 8 logical shards of the card. Each of K6-K10
           against its plain version bit for bit on the chain's own stage
           inputs (kernel, plain and, for K6 and K8, library times); K6
           at 1, 255, 257 and 1,048,576 rows with 2, 5 and 7 resource
           dimensions; K7 and K8 over all shards in one call each against
           the per-shard plain versions laid end to end (K7: the chain's
           ring, 65,536-row rings at 1M and 16,384 rows, an empty ring;
           K8: the 1M-row window, mesh-served's 16,384 rows and the
           certificate-miss shape, and its S = 1 form on every shard),
           eight per-shard K8 calls against the one all-shard call by
           events and device-only, and K9 on synthetic packets (T = 3, S =
           1-8, B = 1, B a whole shard, B = 8,192, segments beyond shared
           memory); then 6 chained windows (1 cold, 5 warm: the ring holds
           16 windows) through `place_batch_keyed` on the mesh and on one
           device, bit for bit on `packed` and the materialized usage, with
           per-window times, the exchanged bytes and the launches per
           window (pinned: one K7 call and one K8 call per cold
           window); K2 on the whole 1,048,576-row table against its plain
           version and torch.topk; torch.topk and torch.sort as K8's and
           K9's yardsticks; K10 at the mesh-served storm's shape (a 16,384-row
           pool, a 65,536-row ring, 4,096 steps) and at edge cases (a
           failed certificate, a delta clamped at the ring's end, three
           keys, a ring of no round size, a one-row ring), bit for bit.
  mesh-served-identity
           the served path's window on the mesh at full width: the dev
           server of served-identity with its table on S = 8 logical
           shards, three 64-eval storm windows dispatched back to back (1
           cold, 2 warm: B = 2,048 rows per shard, k = 4,096, a 16,384-row
           pool, a 65,536-row ring, 4,096 steps per window), once through
           the kernels and once inside `native.plain_versions()`. Both must
           commit the same placements, usage and certificate flags; K2-K5
           and K6-K10 must launch in the kernel run and no plain version
           may run there. Then a fleet whose warm windows fail their
           certificate (2,000 nodes, shard 0's 256 rows half reserved,
           windows of 4 evals: B = 128 below a shard's 256 rows), driven
           through the worker's own drain and build stages, which nack a
           failed window and re-run it cold: kernels, plain versions and
           one device must commit the same placements and usage, and the
           kernel and plain runs raise the same flags, at least one 1.
  mesh-served
           the served storm of the `served` phase (10,000 nodes, window
           64, Count = 50, 600 evals) on a dev server whose table is on
           S = 8 logical shards of the card, held against the same storm
           on a one-device server (the same jobs and tie-break noise): the
           same (job, alloc name -> node) set and the same usage; every
           window on the mesh, at least one warm, no fallback, and K6-K10
           launched. Untraced evals/s, then a traced storm's idle share,
           copies and runtime calls.
  system   BASELINE config 4 on a dev server (`device="cuda"`, one
           pipelined worker, heartbeat TTLs parked) with the served fleet
           (10,000 nodes, 64 classes, 16,384 table rows): a warm-up system
           job (bench.py build_system_job: CPU 20, MemoryMB 16, DiskMB 150,
           no networks), then a storm of 23 more (bench.py C4_EVALS, one
           storm where the reference times two): evals/s, placements/s,
           eval latency p50 / p99, K4b's launches and chunk sizes. Every
           eval completes with no nack, each system job holds one alloc on
           every ready node, and K4b refreshes at the 16,384-row bucket
           with no plain version. Then, the live worker paused, one 64-eval
           service window driven by hand through the worker's stages reads
           the table after the storm (its `t_refresh_ms`: the mass
           refresh's cost); the device usage equals the host mirror bit for
           bit. The same run again with the window inside
           `native.plain_versions()`: the same placements and usage. Last a
           node registers, and every system job places on it.
  placer   bench.py bench_placer's shape on the port's PipelinedPlacer:
           10,000 nodes, 50 placements an eval, window min(600, 128), the
           same rng seeds (a warm-up of 129 evals, 600 timed evals: evals/s,
           placements/s; the single-eval p50 of 5); K4a once an eval, no
           plain version. 64 evals through the kernel and through the plain
           version: the same rows, feasible counts, score bits and chained
           usage. Then bench.py's placement-quality gate: 1,000 nodes, 40
           evals served through the device engine and through
           `scheduler_impl="cpu-reference"`; the device engine's mean
           bin-pack score is no lower than the cpu-reference's (within
           2e-3).
  agent    the dev agent end to end, as `python -m nomad_tpu_torch.cli agent
           -dev` starts it (server on the card, RPC endpoints, client
           runtime, HTTP API on a free port): config 3's fleet (10,000
           nodes, 64 classes, 16,384 rows) registered through the RPC
           dispatch (`Node.Register`); the CLI run in process against the
           agent's address: init, validate, plan, run, status, alloc-status
           and stop of example.nomad, whose raw_exec /bin/sleep alloc must
           run on the agent's own node through the port's client; a
           600-job HTTP storm of config 3 (PUT /v1/jobs, evals polled
           through GET /v1/evaluations): 30,000 placements within capacity,
           none on the agent's node, K2, K3, K4a, K5 and K4b launched and no
           plain version run; evals/s, placements/s, register round trip
           p50 / p99 and the worker stage timers of
           /v1/agent/debug/sched-stats, beside the same 600 jobs registered
           in process on the same agent and the served phase's rates; then
           `nomad plan` of one more job on the loaded fleet through the
           kernels and inside `native.plain_versions()`, which must answer
           identically (diff, annotations, FailedTGAllocs), and a plan with
           its scratch table's build, upload and run timed.
  cluster  Nomad's replicated deployment (bench.py bench_failover_storm's
           setup on the port): three `ClusterServer`s in this process,
           formed by gossip (bootstrap-expect 3), raft over loopback TCP
           (heartbeat 20 ms, elections 80-160 ms), each with its own raft
           log store (`make_log_store`: the native library when built,
           the Python store otherwise), QoS on (deadlines 10/30/120 s),
           one scheduler each, heartbeat TTLs parked and its own node
           table on the card; config 3's fleet (10,000 nodes, 64 classes,
           16,384 rows a table) registered through the leader's
           `Node.Register` from 8 client threads; a storm of 150 config-3
           jobs (Count 50, priorities 80/20/50) through random live
           servers (followers forward to the leader), the leader killed
           with `shutdown()` after the 100th, drained under a deadline.
           The leader places through its pipelined worker (K2, K3, K4a,
           K5, then K4b), each follower through its routed per-eval
           worker (K2, K3, K4a, one readback) on its own replica, and
           every server's table refreshes (K4b) on the commits it
           applies. Checks: every eval terminal, every job at exactly 50
           live allocs, no duplicate alloc, no node oversubscribed
           (`chaos.check_invariants` on the new leader's store); the
           survivors' replica digests with no divergence and a verified
           watermark on the follower; each survivor's device usage equal
           to its host mirror; routed workers completed evals; K2-K5 and
           K4b launched and no plain version ran; then one more job placed
           on the new leader's snapshot and table through the kernels and
           inside `native.plain_versions()`, identical. Prints the
           election, register, storm and kill-to-leader seconds, evals/s
           and placements/s through the kill, per-tier latency, evals per
           server's workers, launches, snapshots per server and each
           server's log store.

Last, every kernel's device-only time a call (torch.profiler's CUDA
activity) beside its event time and its host time a call, at the shapes
the phases gave it, and the library yardsticks (torch.topk for K2,
torch.sort(stable=True) of K3's rows, index_copy_ on the three tables for
K4b, torch.cat for K6, torch.topk for K8, torch.sort for K9) and the empty
kernel, and K4b at the 16,384-row bucket from a pinned block (the refresh
after a system storm) beside index_copy_: taken after every event time,
because a profiler session slows later launches.

--package-root DIR drives the nomad_tpu_torch package found in DIR (an
unpacked earlier commit, say) with this script's phases, so two commits'
kernels meet the same shapes in one run.

Prints the card's name and power limit, one `kernels` JSON line, and as the
last line {"ok": true, "device": {...}}. Any failed check raises, so the
script exits non-zero and prints no result. Needs one CUDA card; refuses to
run without one. Imports nothing of JAX or of the nomad_tpu package.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import logging
import os
import random
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SCORE_TOL = 4e-6        # absolute; see tests/test_torch_kernels.py
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
PCIE_BYTES_PER_S = 64e9     # H100 SXM host link, PCIe Gen5 x16, each way
N_NODES = 10_000
N_CLASSES = 64
PER_EVAL = 50
N_SERVICE_EVALS = 100
WINDOW = 64             # ServerConfig.scheduler_window of the served runs
N_SERVED_EVALS = 600    # timed storm of the served phase (30,000 placements)
N_SERVED_REPS = 3       # untraced timed storms; the median is reported
MESH_SHARDS = 8         # logical shards of the card (the reference's 8)
MESH_ROWS = 1 << 20     # bench_mesh_1m: MESH_NODES
MESH_P = 1024           # one storm window's steps
MESH_VALID = 800        # valid placements of the window
MESH_WINDOWS = 6        # 1 cold + 5 warm
MESH_REPS = 3           # timed chains; the median per window is reported
PARKED = dict(min_heartbeat_ttl=24 * 3600.0, heartbeat_grace=24 * 3600.0)
REPLACES = {
    "score_topk": "nomad_tpu/scheduler/kernels.py:415",
    "merge_candidates": "nomad_tpu/scheduler/kernels.py:444",
    "placement_chain": "nomad_tpu/scheduler/kernels.py:512",
    "scatter_refresh": "nomad_tpu/tensor/node_table.py:754",
    "compact_window": "nomad_tpu/scheduler/kernels.py:204",
    "mesh_pack": "nomad_tpu/scheduler/kernels.py:745",
    "apply_ring": "nomad_tpu/scheduler/kernels.py:758",
    "cold_packet": "nomad_tpu/scheduler/kernels.py:777",
    "pool_build": "nomad_tpu/scheduler/kernels.py:819",
    "warm_finish": "nomad_tpu/scheduler/kernels.py:838",
}
SOURCES = {
    "score_topk": "nomad_tpu_torch/csrc/keyed.cu",
    "merge_candidates": "nomad_tpu_torch/csrc/keyed.cu",
    "placement_chain": "nomad_tpu_torch/csrc/chain.cu",
    "scatter_refresh": "nomad_tpu_torch/csrc/refresh.cu",
    "compact_window": "nomad_tpu_torch/csrc/compact.cu",
    "mesh_pack": "nomad_tpu_torch/csrc/mesh.cu",
    "apply_ring": "nomad_tpu_torch/csrc/mesh.cu",
    "cold_packet": "nomad_tpu_torch/csrc/mesh.cu",
    "pool_build": "nomad_tpu_torch/csrc/mesh.cu",
    "warm_finish": "nomad_tpu_torch/csrc/mesh.cu",
}
# The kernels each path launches (the per-eval storm never compacts; only a
# mesh runs K6-K10).
STORM_KERNELS = ("score_topk", "merge_candidates", "placement_chain",
                 "scatter_refresh")
SERVED_KERNELS = STORM_KERNELS + ("compact_window",)
MESH_KERNELS = ("mesh_pack", "apply_ring", "cold_packet", "pool_build",
                "warm_finish")


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of fn over reps calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int):
    """Device-only time of fn per call, the device activities (kernels,
    copies, fills) the trace caught per call, and the device time a call
    by kernel name: torch.profiler's CUDA activity over reps calls after
    one warm-up call. Unlike time_ms it leaves out the host's time between
    launches. A trace can miss a run's first launches, so each name's time
    a call is its mean over the activities caught times the activities it
    has a call (at least one), not its sum over reps. (None, 0, {}) when
    the trace holds no device time."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_ms, count, by_name = 0.0, 0, {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us and ev.count:
            ms = us / ev.count * max(1, round(ev.count / reps)) / 1e3
            total_ms += ms
            count += ev.count
            name = ev.key.replace("(anonymous namespace)::", "").replace(
                "void ", "").split("(")[0].split("<")[0].split("::")[-1]
            name = name.strip()[:40]
            by_name[name] = by_name.get(name, 0.0) + ms
    if total_ms == 0:
        return None, 0, {}
    return total_ms, count / reps, by_name


# Device-only measurements, queued by the phases and taken last in the
# process (a torch.profiler session slows every launch after it): (what,
# events ms, fn, reps).
DEVICE_ONLY = []


def device_only_phase(torch):
    """For every queued call: its host time a call (back-to-back calls
    without a sync), then its device-only time a call (device_ms), beside
    its event time."""
    host = []
    for _, _, fn, reps in DEVICE_ONLY:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host.append((time.perf_counter() - t0) * 1e3 / reps)
        torch.cuda.synchronize()
    for (what, ev_ms, fn, reps), host_ms in zip(DEVICE_ONLY, host):
        dev_ms, acts, by_name = device_ms(torch, fn, reps)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        print(f"phase device-only {what}: {_fmt(ev_ms)} ms by events, "
              f"{_fmt(dev_ms)} ms on the device ({acts:g} device activities "
              f"a call: " + ", ".join(f"{k} {v:.4f}" for k, v in top)
              + f"), {host_ms:.4f} ms of host time a call", flush=True)
    DEVICE_ONLY.clear()


def bound(nbytes: float, ops: float, host_bytes: float = 0):
    """The least time for the work: bytes through device memory, bytes
    that cross PCIe (`host_bytes`: a kernel reading or writing pinned host
    memory in place) and operations, the largest of the three."""
    t_bytes = max(nbytes / HBM_BYTES_PER_S, host_bytes / PCIE_BYTES_PER_S) \
        * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------- kernels


def window_inputs(torch, dev, rng, n, t, uniform=False, zero_noise=False):
    """Node-side inputs of one window. uniform=True is the mock fleet the
    storm places on (identical nodes, reserved usage, noise-only ties);
    zero_noise=True leaves exact ties, which the row order decides."""
    if uniform:
        capacity = np.tile(np.array([4000, 8192, 102400, 150, 1000],
                                    np.float32), (n, 1))
        usage = np.tile(np.array([100, 256, 4096, 0, 1], np.float32), (n, 1))
        score_cap = np.tile(np.array([3900, 7936], np.float32), (n, 1))
        tg_masks = np.ones((t, n), bool)
        job_counts = np.zeros(n, np.int32)
        key_demands = np.tile(np.array([20, 32, 10, 0, 0], np.float32),
                              (t, 1))
        banned0 = np.zeros(n, bool)
    else:
        capacity = rng.uniform(1000, 4000, (n, 5)).astype(np.float32)
        score_cap = rng.uniform(800, 3800, (n, 2)).astype(np.float32)
        usage = rng.uniform(0, 500, (n, 5)).astype(np.float32)
        tg_masks = rng.random((t, n)) < 0.9
        job_counts = rng.integers(0, 3, n).astype(np.int32)
        key_demands = rng.uniform(10, 100, (t, 5)).astype(np.float32)
        banned0 = rng.random(n) < 0.05
    noise = (np.zeros(n, np.float32) if zero_noise
             else (rng.random(n) * 1e-3).astype(np.float32))
    arrs = dict(capacity=capacity, score_cap=score_cap, usage=usage,
                tg_masks=tg_masks, job_counts0=job_counts,
                key_demands=key_demands, noise=noise, banned0=banned0)
    return {k: torch.tensor(v, device=dev) for k, v in arrs.items()}


def step_inputs(torch, dev, rng, t, p, n_valid, reset_every=0):
    tg_ids = rng.integers(0, t, p).astype(np.int32)
    valid = np.zeros(p, bool)
    valid[:n_valid] = True
    reset = np.zeros(p, bool)
    if reset_every:
        reset[::reset_every] = True
    return {k: torch.tensor(v, device=dev)
            for k, v in (("tg_ids", tg_ids), ("valid", valid),
                         ("reset", reset))}


def served_steps(torch, dev, evals, per_eval=WINDOW, n_valid=PER_EVAL,
                 n_keys=1, run=16, rng=None):
    """dispatch_multi's steps for a window of `evals` storm evals: a reset
    at each eval's first step and n_valid valid steps of its per_eval. With
    n_keys > 1 the key changes every `run` steps (padding runs inside runs
    of one key)."""
    p = evals * per_eval
    valid = np.zeros(p, bool)
    reset = np.zeros(p, bool)
    for e in range(evals):
        valid[e * per_eval:e * per_eval + n_valid] = True
        reset[e * per_eval] = True
    tg_ids = (np.repeat(rng.integers(0, n_keys, -(-p // run)), run)[:p]
              if n_keys > 1 else np.zeros(p))
    return {k: torch.tensor(v, device=dev)
            for k, v in (("tg_ids", tg_ids.astype(np.int32)),
                         ("valid", valid), ("reset", reset))}


def resize_dims(torch, w, r, rng):
    """The window's inputs with r resource dimensions instead of 5: the first
    r columns, or extra random ones beyond 5 (the kernels' generic path)."""
    out = dict(w)
    for name in ("capacity", "usage", "key_demands"):
        x = w[name]
        if r <= x.shape[1]:
            out[name] = x[:, :r].contiguous()
        else:
            lo, hi = {"capacity": (1000, 4000), "usage": (0, 500),
                      "key_demands": (10, 100)}[name]
            extra = rng.uniform(lo, hi, (x.shape[0], r - x.shape[1]))
            out[name] = torch.cat([x, torch.tensor(
                extra.astype(np.float32), device=x.device)], dim=1)
    return out


def run_steps(torch, dev, rng, t, p, run=12, frac=1.0):
    """Runs of one key: the key changes mid-run, without a reset after the
    first step."""
    tg_ids = np.repeat(rng.integers(0, t, -(-p // run)), run)[:p]
    valid = np.zeros(p, bool)
    valid[:int(p * frac)] = True
    reset = np.zeros(p, bool)
    reset[0] = True
    return {k: torch.tensor(v, device=dev)
            for k, v in (("tg_ids", tg_ids.astype(np.int32)),
                         ("valid", valid), ("reset", reset))}


def chain_triggers(tg_ids, valid, reset, demands=None):
    """Steps on which K4a rescores its whole table (csrc/chain.cu): the
    first, a reset, a change of key, and a change of validity (replay) or
    of any demand bit (scan, demands given)."""
    t, v = tg_ids.cpu().numpy(), valid.cpu().numpy()
    rs = reset.cpu().numpy() if reset is not None else np.zeros(len(t), bool)
    trig = rs.copy()
    trig[0] = True
    trig[1:] |= t[1:] != t[:-1]
    if demands is None:
        trig[1:] |= v[1:] != v[:-1]
    else:
        bits = demands.cpu().numpy().view(np.uint32)
        trig[1:] |= (bits[1:] != bits[:-1]).any(axis=1)
    return int(trig.sum())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def compare_chain(torch, ref, got, valid, what):
    """packed [P, 3] and usage: rows and valid-step n_feasible exact,
    usage exact, scores within SCORE_TOL. Returns the max score diff."""
    rp, gp = ref[0].cpu().numpy(), got[0].cpu().numpy()
    v = valid.cpu().numpy()
    check(np.array_equal(rp[:, 0], gp[:, 0]), f"{what}: chosen rows differ")
    check(np.array_equal(rp[v, 2], gp[v, 2]), f"{what}: n_feasible differs")
    check(torch.equal(ref[1], got[1]), f"{what}: usage differs")
    fin = np.isfinite(rp[:, 1])
    check(np.array_equal(fin, np.isfinite(gp[:, 1])),
          f"{what}: infinite scores differ")
    err = float(np.abs(rp[fin, 1] - gp[fin, 1]).max()) if fin.any() else 0.0
    check(err <= SCORE_TOL, f"{what}: score diff {err} > {SCORE_TOL}")
    return err


def run_kernel_phases(torch, dev, n=16384, deep=4096):
    from nomad_tpu_torch import native
    from nomad_tpu_torch.scheduler import kernels as K
    from nomad_tpu_torch.tensor import node_table as NT

    rng = np.random.default_rng(20261017)
    table = {}   # kernel name -> main-path measurement

    def keyed_case(label, t, s, n_valid, uniform, reps, plain_reps,
                   main=False):
        p = s["tg_ids"].shape[0]
        w = window_inputs(torch, dev, rng, n, t, uniform)
        k_cand = K.keyed_cand_count(n_valid)
        args = (w["capacity"], w["score_cap"], w["usage"], w["tg_masks"],
                w["job_counts0"], w["key_demands"], w["noise"], 10.0, False,
                w["banned0"], k_cand)
        m_k, nf_k, c_k = K.score_topk(*args)
        m_p, nf_p, c_p = K.score_topk_plain(*args)
        fin = torch.isfinite(m_p)
        check(torch.equal(fin, torch.isfinite(m_k)),
              f"K2 {label}: masked rows differ")
        err2 = float((m_k[fin] - m_p[fin]).abs().max()) if fin.any() else 0.0
        check(err2 <= SCORE_TOL, f"K2 {label}: score diff {err2}")
        check(torch.equal(nf_k, nf_p), f"K2 {label}: nf0 differs")
        check(torch.equal(c_k, c_p), f"K2 {label}: top-K rows differ")
        r_k, keep_k = K.merge_candidates(c_k, m_k, k_cand)
        r_p, keep_p = K.merge_candidates_plain(c_p, m_p, k_cand)
        check(torch.equal(r_k, r_p) and torch.equal(keep_k, keep_p),
              f"K3 {label}: candidate table differs")
        chain_args = (w["capacity"], w["score_cap"], w["usage"],
                      w["tg_masks"], w["job_counts0"], w["key_demands"],
                      s["tg_ids"], s["valid"], w["noise"], 10.0, False,
                      w["banned0"])
        chain_kw = dict(reset=s["reset"], rows=r_k, keep=keep_k, masked0=m_k,
                        nf0=nf_k)
        got = K.placement_chain(*chain_args, **chain_kw)
        ref = K.placement_chain_plain(*chain_args, **chain_kw)
        err4 = compare_chain(torch, ref, got, s["valid"], f"K4a replay {label}")
        placed = int((got[0][:, 0] >= 0).sum())
        ms = {
            "score_topk": (time_ms(torch, lambda: K.score_topk(*args), reps),
                           time_ms(torch, lambda: K.score_topk_plain(*args),
                                   plain_reps)),
            "merge_candidates": (
                time_ms(torch, lambda: K.merge_candidates(c_k, m_k, k_cand),
                        reps),
                time_ms(torch, lambda: K.merge_candidates_plain(
                    c_p, m_p, k_cand), plain_reps)),
            "placement_chain": (
                time_ms(torch, lambda: K.placement_chain(*chain_args,
                                                         **chain_kw), reps),
                time_ms(torch, lambda: K.placement_chain_plain(
                    *chain_args, **chain_kw), plain_reps)),
        }
        n_trig = chain_triggers(s["tg_ids"], s["valid"], s["reset"])
        print(f"phase keyed {label}: T={t} N={n} P={p} n_valid={n_valid} "
              f"K={k_cand} table={r_k.numel()} placed={placed}: rows, nf0, "
              f"top-K, candidates, n_feasible and usage identical; max score "
              f"diff K2={err2} K4a={err4}; kernel/plain ms "
              + ", ".join(f"{k}={a:.4f}/{b:.4f}" for k, (a, b) in ms.items())
              + f"; K4a {1e3 * ms['placement_chain'][0] / p:.4f} us per step "
              f"({n_trig} full rescores, {p - n_trig} incremental steps)",
              flush=True)
        if main:
            kc = c_k.shape[1]
            c = r_k.numel()
            r = w["capacity"].shape[1]
            b2 = nbytes(w["capacity"], w["score_cap"], w["usage"],
                        w["tg_masks"], w["job_counts0"], w["key_demands"],
                        w["noise"], w["banned0"], m_k, nf_k, c_k)
            b3 = nbytes(c_k, r_k, keep_k)
            # The replay needs each candidate's row data (not the table),
            # the per-step inputs, and writes packed and the usage copy; its
            # work is one table pass per trigger and one entry per other
            # step.
            row_bytes = (2 * r + 2 + 1 + 1 + t + t) * 4
            b4 = (c * row_bytes + nbytes(s["tg_ids"], s["valid"], s["reset"],
                                         w["key_demands"], nf_k, got[0])
                  + 2 * nbytes(w["usage"]))
            ops4 = (n_trig * c + (p - n_trig)) * (3 * r + 20)
            # Library yardstick for K2's selection: torch.topk over the
            # masked scores (its tie order is not the contract: time only).
            topk_ms = time_ms(torch, lambda: torch.topk(m_k, kc, dim=1,
                                                        sorted=True), reps)
            # K3's: a stable sort of the candidate rows (the order K3
            # gives; time only, it makes no keep mask).
            flat = c_k.reshape(-1)
            sort_ms = time_ms(torch, lambda: torch.sort(flat, stable=True),
                              50)
            DEVICE_ONLY.extend([
                (f"score_topk at the {label} (T={t}, N={n}, K={k_cand})",
                 ms["score_topk"][0], lambda: K.score_topk(*args), 50),
                (f"torch.topk (k={kc}) of K2's masked scores at the {label}",
                 topk_ms, lambda: torch.topk(m_k, kc, dim=1, sorted=True),
                 50),
                (f"placement_chain at the {label} (P={p})",
                 ms["placement_chain"][0],
                 lambda: K.placement_chain(*chain_args, **chain_kw), 5),
                (f"merge_candidates at the {label} (T={t}, "
                 f"{c_k.numel()} candidates)", ms["merge_candidates"][0],
                 lambda: K.merge_candidates(c_k, m_k, k_cand), 50),
                (f"torch.sort(stable=True) of K3's {c_k.numel()} rows",
                 sort_ms, lambda: torch.sort(flat, stable=True), 50)])
            for name, nb, ops, err, lib in (
                    ("score_topk", b2, t * n * (3 * r + 20), err2, topk_ms),
                    ("merge_candidates", b3, c * np.log2(max(c, 2)), 0.0,
                     sort_ms),
                    ("placement_chain", b4, ops4, err4, None)):
                bms, by = bound(nb, ops)
                table[name] = dict(max_abs_err=err, ms=ms[name][0],
                                   plain_ms=ms[name][1], bound_ms=bms,
                                   bound_by=by, library_ms=lib)
            print(f"phase keyed {label}: bounds ms K2 "
                  f"{table['score_topk']['bound_ms']:.6f}, K3 "
                  f"{table['merge_candidates']['bound_ms']:.6f}, K4a "
                  f"{table['placement_chain']['bound_ms']:.6f} "
                  f"({table['placement_chain']['bound_by']}); torch.topk "
                  f"(k={kc}) {topk_ms:.4f} ms; torch.sort(stable=True) of "
                  f"the {c_k.numel()} candidate rows {sort_ms:.4f} ms",
                  flush=True)

    # The served storm's window (64 evals of one task group, 50 placements
    # padded to 64: K = 4,096, T = 1, 4,096 steps, a reset every 64) on the
    # storm's uniform fleet: these are the kernels table's numbers.
    keyed_case("served window (uniform fleet)", 1,
               served_steps(torch, dev, WINDOW), WINDOW * PER_EVAL, True, 5,
               1, main=True)
    keyed_case("per-eval storm (uniform fleet)", 1,
               step_inputs(torch, dev, rng, 1, 64, 50), 50, True, 50, 3)
    keyed_case("varied fleet", 3, step_inputs(torch, dev, rng, 3, 64, 64),
               64, False, 50, 3)
    keyed_case("varied fleet, deep window", 3,
               step_inputs(torch, dev, rng, 3, deep, deep - deep // 32),
               deep - deep // 32, False, 3, 1)

    # K3's per-key trim, which a single card's window never needs (it fires
    # when shards contribute more candidates than T * K): candidates of 8
    # row shards' own top-K, merged as the mesh merge would.
    w = window_inputs(torch, dev, rng, n, 2)
    m0, _, _ = K.score_topk_plain(w["capacity"], w["score_cap"], w["usage"],
                                  w["tg_masks"], w["job_counts0"],
                                  w["key_demands"], w["noise"], 10.0, False,
                                  w["banned0"], n)
    shard = n // 8
    cand = torch.cat([
        torch.sort(m0[:, i * shard:(i + 1) * shard], dim=1, descending=True,
                   stable=True).indices[:, :64].to(torch.int32) + i * shard
        for i in range(8)])
    r_k, keep_k = K.merge_candidates(cand, m0, 64)
    r_p, keep_p = K.merge_candidates_plain(cand, m0, 64)
    check(r_k.numel() == 2 * 64, "K3 trim: trim did not fire")
    check(torch.equal(r_k, r_p) and torch.equal(keep_k, keep_p),
          "K3 trim: candidate table differs")
    print(f"phase K3 trim: {cand.numel()} shard candidates -> "
          f"{r_k.numel()} kept rows identical", flush=True)

    # K4a scan mode (place_batch) and multi (place_batch_multi), and one
    # window forced down the scan route: scan and keyed agree exactly.
    for label, t, p, n_valid, every in (("scan", 3, 64, 64, 0),
                                        ("multi", 3, 256, 256, 64)):
        w = window_inputs(torch, dev, rng, n, t)
        s = step_inputs(torch, dev, rng, t, p, n_valid, every)
        demands = (w["key_demands"][s["tg_ids"].long()]
                   * s["valid"][:, None].float()).contiguous()
        args = (w["capacity"], w["score_cap"], w["usage"], w["tg_masks"],
                w["job_counts0"], demands, s["tg_ids"], s["valid"],
                w["noise"], 10.0, True, w["banned0"])
        kw = dict(reset=s["reset"]) if every else {}
        got = K.placement_chain(*args, **kw)
        ref = K.placement_chain_plain(*args, **kw)
        err = compare_chain(torch, ref, got, s["valid"], f"K4a {label}")
        keyed = K.place_batch_keyed(
            None, w["capacity"], w["score_cap"], w["usage"], w["tg_masks"],
            w["job_counts0"], w["key_demands"], s["tg_ids"], s["valid"],
            w["noise"], 10.0, True, w["banned0"], s["reset"], n_valid)
        compare_chain(torch, got, tuple(keyed), s["valid"],
                      f"{label} route vs keyed route")
        k_ms = time_ms(torch, lambda: K.placement_chain(*args, **kw), 20)
        p_ms = time_ms(torch, lambda: K.placement_chain_plain(*args, **kw), 2)
        print(f"phase K4a {label}: T={t} N={n} P={p}: identical to plain "
              f"(max score diff {err}) and to the keyed route; kernel/plain "
              f"ms {k_ms:.4f}/{p_ms:.4f}", flush=True)

    chain_edge_cases(torch, dev, K, rng)
    select_edge_cases(torch, dev, K, rng)

    # Since K4b and K5 work on pinned host memory in place (the package
    # has native.device_address), each runs both ways on a card: K4b from
    # a block on the card and from a pinned block (the main path), K5 into
    # a block on the card and into a pinned block (the main path); and
    # K4b's plain version drops rows past the table. An earlier package
    # (--package-root) takes device blocks only.
    pinned_api = hasattr(native, "device_address")
    pinned = pinned_api and dev.type == "cuda"

    # K4b at every refresh chunk size; library: index_copy_ on each table.
    # With pinned blocks, one row lies past the table (the kernel and the
    # plain version drop it) and the last quarter repeats the first row,
    # as a chunk's padding does.
    for size in NT._REFRESH_CHUNKS:
        tabs = [torch.tensor(rng.uniform(0, 1, shape).astype(np.float32),
                             device=dev)
                for shape in ((n, 5), (n, 2), (n, 5))]
        rows = rng.permutation(n)[:size].astype(np.float32)
        host_pk = np.concatenate(
            [rows[:, None],
             rng.uniform(0, 1, (len(rows), 12)).astype(np.float32)],
            axis=1)
        if pinned_api:
            host_pk[1, 0] = n + 3
            host_pk[-size // 4:] = host_pk[0]
        pk = torch.tensor(host_pk, device=dev)
        a = [x.clone() for x in tabs]
        b = [x.clone() for x in tabs]
        NT.scatter_refresh(*a, pk)
        NT.scatter_refresh_plain(*b, pk)
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"K4b chunk {size}: tables differ")
        in_table = pk[:, 0] < n
        idx = pk[in_table, 0].long()
        parts = (pk[in_table, 1:6].contiguous(),
                 pk[in_table, 6:8].contiguous(), pk[in_table, 8:].contiguous())

        def library(a=a, idx=idx, parts=parts):
            for tab, part in zip(a, parts):
                tab.index_copy_(0, idx, part)

        d_ms = time_ms(torch, lambda: NT.scatter_refresh(*a, pk), 50)
        p_ms = time_ms(torch, lambda: NT.scatter_refresh_plain(*b, pk), 20)
        l_ms = time_ms(torch, library, 50)
        k_ms, pin_note = d_ms, ""
        if pinned:
            pin = torch.empty(host_pk.shape, dtype=torch.float32,
                              pin_memory=True)
            pin.numpy()[:] = host_pk
            c = [x.clone() for x in tabs]
            NT.scatter_refresh(*c, pin)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(c, b)),
                  f"K4b chunk {size} from a pinned block: tables differ")
            k_ms = time_ms(torch, lambda: NT.scatter_refresh(*c, pin), 50)
            pin_note = (f" (device address "
                        f"{native.device_address(pin, dev):#x} of host "
                        f"pointer {pin.data_ptr():#x})")
        print(f"phase K4b chunk={size}: identical to plain"
              + (", one row past the table, a quarter repeated padding rows"
                 if pinned_api else "")
              + (f", from a device block and from a pinned block{pin_note}"
                 if pinned else "")
              + f"; kernel ms from a device block {d_ms:.4f}"
              + (f", from a pinned block {k_ms:.4f}" if pinned else "")
              + f"; plain/index_copy_ ms {p_ms:.4f}/{l_ms:.4f}", flush=True)
        if size == 128:
            # The storm's refresh after one 50-placement commit dirties at
            # most 50 rows: the 128-row bucket is its main-path shape. From
            # a pinned block the kernel reads the block over PCIe and
            # writes 12 floats a row to device memory.
            writes = size * 12 * 4
            bms, by = (bound(writes, 0, host_bytes=nbytes(pk)) if pinned
                       else bound(nbytes(pk) + writes, 0))
            table["scatter_refresh"] = dict(
                max_abs_err=0.0, ms=k_ms, plain_ms=p_ms, bound_ms=bms,
                bound_by=by, library_ms=l_ms)
            DEVICE_ONLY.extend([
                (f"scatter_refresh at {size} rows from a device block", d_ms,
                 lambda a=a, pk=pk: NT.scatter_refresh(*a, pk), 50),
                (f"index_copy_ x3 at {size} rows", l_ms, library, 50)])
            if pinned:
                DEVICE_ONLY.append((
                    f"scatter_refresh at {size} rows from a pinned block",
                    k_ms, lambda c=c, pin=pin: NT.scatter_refresh(*c, pin),
                    50))
        if size == NT._REFRESH_CHUNKS[-1] and pinned:
            # The first snapshot after a system storm refreshes every row
            # the storm's commits dirtied: one chunk of the largest bucket,
            # read from a pinned staging slot.
            DEVICE_ONLY.extend([
                (f"scatter_refresh at {size} rows from a pinned block", k_ms,
                 lambda c=c, pin=pin: NT.scatter_refresh(*c, pin), 50),
                (f"index_copy_ x3 at {size} rows", l_ms, library, 50)])

    # K5 at the served window's shapes: a 64-eval storm window of 64 padded
    # placements (the main path), a 16-eval window, and a 64-eval window of
    # 4,096-placement evals. All four outputs must be equal (scores bit for
    # bit), written on the card and (the main path) into a pinned host
    # block; no single PyTorch call computes the same function.
    for e, p in ((64, 64), (16, 64), (64, 4096)):
        args = compact_inputs(torch, dev, rng, e, p)
        got = K.compact_window(*args)
        ref = K.compact_window_plain(*args)
        _identical(torch, got, ref, f"K5 E={e} P={p}")
        d_ms = time_ms(torch, lambda: K.compact_window(*args), 200)
        p_ms = time_ms(torch, lambda: K.compact_window_plain(*args), 50)
        k_ms = d_ms
        if pinned:
            block = K.compact_block(e, p, dev)
            check(block.is_pinned(), f"K5 E={e} P={p}: block not pinned")
            into = K.compact_window(*args, out=block)
            torch.cuda.synchronize()
            _identical(torch, into, [r.cpu() for r in ref],
                       f"K5 E={e} P={p} into a pinned block")
            k_ms = time_ms(torch, lambda: K.compact_window(*args, out=block),
                           200)
            # It reads its inputs from device memory and writes its
            # outputs over PCIe.
            bms, by = bound(nbytes(*args), e * p * 2,
                            host_bytes=nbytes(*got))
        else:
            bms, by = bound(nbytes(*args) + nbytes(*got), e * p * 2)
        print(f"phase K5 E={e} P={p}: chosen, scores (bits), nf_last and ok "
              f"identical to plain"
              + (" on the card and into a pinned block" if pinned else "")
              + f"; kernel ms into a device block {d_ms:.4f}"
              + (f", into a pinned block {k_ms:.4f}" if pinned else "")
              + f"; plain ms {p_ms:.4f}; bound {bms:.6f} ms ({by})",
              flush=True)
        if (e, p) == (64, 64) and dev.type == "cuda":
            drain_probe(torch, K, args, pinned)
            table["compact_window"] = dict(
                max_abs_err=0.0, ms=k_ms, plain_ms=p_ms, bound_ms=bms,
                bound_by=by, library_ms=None)
            DEVICE_ONLY.append((
                f"compact_window at E={e} P={p} into a device block", d_ms,
                lambda args=args: K.compact_window(*args), 200))
            if pinned:
                DEVICE_ONLY.append((
                    f"compact_window at E={e} P={p} into a pinned block",
                    k_ms, lambda args=args, block=block: K.compact_window(
                        *args, out=block), 200))

    if pinned:
        # The launch floor: a kernel that does nothing, by events and (in
        # device_only_phase) on the device.
        lib, stream = native.library(), native.stream(dev)

        def empty():
            check(lib.nomad_empty(stream) == 0, "the empty kernel failed")

        e_ms = time_ms(torch, empty, 1000)
        print(f"phase launch floor: an empty kernel {e_ms:.4f} ms a launch "
              f"by events over 1000 back-to-back launches", flush=True)
        DEVICE_ONLY.append(("an empty kernel (the launch floor)", e_ms,
                            empty, 1000))
    return table


def drain_probe(torch, K, args, pinned: bool, reps: int = 200):
    """Host ms to issue K5's part of one window's drain plan, as the
    served worker issues it: the copy form (K5's outputs on the card, then
    a pinned tensor and a non-blocking copy home for each of the four,
    then one event; the worker's form before K5 wrote pinned memory) and,
    with `pinned`, the zero-copy form (one pinned block, K5 writing it in
    place, one event). Each plan is issued, timed, then waited for, as the
    worker's drain waits on each window's event."""
    dev = args[0].device

    def copy_form():
        outs = K.compact_window(*args)
        homes = []
        for t in outs:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            homes.append(h)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(dev))
        return homes, ready

    def pinned_form():
        block = K.compact_block(*args[1].shape, dev)
        outs = K.compact_window(*args, out=block)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(dev))
        return outs, ready

    forms = [("copies", copy_form)] + ([("pinned", pinned_form)]
                                       if pinned else [])
    out = {}
    for name, form in forms:
        form()[1].synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            _, ready = form()
            times.append((time.perf_counter() - t0) * 1e3)
            ready.synchronize()
        out[name] = float(np.median(times))
    e, p = args[1].shape
    print(f"phase K5 drain plan at E={e} P={p}: host ms to issue K5's part "
          f"of a window's drain plan, median of {reps}: "
          + ", ".join(f"{k} form {v:.4f}" for k, v in out.items()),
          flush=True)
    return out


def _identical(torch, got, ref, what):
    """Every output equal bit for bit (floats compared as their bits)."""
    for i, (a, b) in enumerate(zip(got, ref)):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"{what}: output {i} differs from the plain version")


def chain_edge_cases(torch, dev, K, rng):
    """K4a's redesign at its edges, each against the plain version bit for
    bit (replay: packed, usage, each step's argmax index, chained usage;
    scan: packed, usage): exact ties, distinct on and off, all-infeasible
    steps, a key or demand change mid-run, padding runs, a table above the
    shared-memory budget, tables that are no multiple of the 128-entry
    segment, resource dimensions other than 5 and more keys than the
    eligibility bits hold."""
    cases = []
    n = 16384
    # (label, rows, T, fleet kwargs, steps, distinct, mode, starve key 0)
    for distinct in (False, True):
        cases.append((f"exact ties (uniform fleet, no noise), distinct "
                      f"{distinct}", n, 1, dict(uniform=True, zero_noise=True),
                      served_steps(torch, dev, 8), distinct, "replay", False))
    cases += [
        ("distinct on, key changes mid-run", n, 3, {},
         run_steps(torch, dev, rng, 3, 512, frac=0.9), True, "replay", False),
        ("distinct off, key changes mid-run, scan", n, 3, {},
         run_steps(torch, dev, rng, 3, 256), False, "scan", False),
        ("all-infeasible steps (key 0 eligible nowhere)", n, 2, {},
         run_steps(torch, dev, rng, 2, 384, frac=0.9), False, "replay",
         True),
        ("all-infeasible steps, scan", n, 2, {},
         run_steps(torch, dev, rng, 2, 128), True, "scan", True),
        ("winners through padding runs (2 keys)", n, 2, {},
         served_steps(torch, dev, 8, n_keys=2, rng=rng), False, "replay",
         False),
        ("table above the shared-memory budget (replay, 8 keys)", n, 8, {},
         run_steps(torch, dev, rng, 8, 4096, run=256, frac=0.9), False,
         "replay", False),
        ("table above the shared-memory budget, no segment multiple (scan)",
         65536 + 77, 2, {}, run_steps(torch, dev, rng, 2, 96), True, "scan",
         False),
        ("table no segment multiple (scan)", 1000, 2, {},
         run_steps(torch, dev, rng, 2, 256), True, "scan", False),
    ]
    # The generic paths: resource dimensions other than the node table's
    # 5, and more keys than eligibility bits.
    for r_dims in (3, 7):
        cases.append((f"{r_dims} resource dimensions", n, 2, dict(r=r_dims),
                      served_steps(torch, dev, 8, n_keys=2, rng=rng), True,
                      "replay", False))
        cases.append((f"{r_dims} resource dimensions, scan", 4096, 2,
                      dict(r=r_dims), run_steps(torch, dev, rng, 2, 128),
                      False, "scan", False))
    cases.append(("40 keys (beyond the eligibility bits)", n, 40, {},
                  run_steps(torch, dev, rng, 40, 512, run=8, frac=0.9),
                  False, "replay", False))
    for label, rows, t, fleet, st, distinct, mode, starve in cases:
        fleet = dict(fleet)
        r_dims = fleet.pop("r", 5)
        w = window_inputs(torch, dev, rng, rows, t, **fleet)
        if r_dims != 5:
            w = resize_dims(torch, w, r_dims, rng)
        if starve:
            w["tg_masks"][0] = False
        p = st["tg_ids"].shape[0]
        if mode == "replay":
            n_valid = int(st["valid"].sum())
            k_cand = K.keyed_cand_count(n_valid)
            m0, nf0, cand = K.score_topk(
                w["capacity"], w["score_cap"], w["usage"], w["tg_masks"],
                w["job_counts0"], w["key_demands"], w["noise"], 10.0,
                distinct, w["banned0"], k_cand)
            sel, keep = K.merge_candidates(cand, m0, k_cand)
            args = (w["capacity"], w["score_cap"], w["usage"], w["tg_masks"],
                    w["job_counts0"], w["key_demands"], st["tg_ids"],
                    st["valid"], w["noise"], 10.0, distinct, w["banned0"])
            kw = dict(reset=st["reset"], rows=sel, keep=keep, masked0=m0,
                      nf0=nf0, winners=True)
            table = sel.numel()
            n_trig = chain_triggers(st["tg_ids"], st["valid"], st["reset"])
        else:
            demands = (w["key_demands"][st["tg_ids"].long()]
                       * st["valid"][:, None].float()).contiguous()
            args = (w["capacity"], w["score_cap"], w["usage"], w["tg_masks"],
                    w["job_counts0"], demands, st["tg_ids"], st["valid"],
                    w["noise"], 10.0, distinct, w["banned0"])
            kw = dict(reset=st["reset"])
            table = rows
            n_trig = chain_triggers(st["tg_ids"], st["valid"], st["reset"],
                                    demands)
        got = K.placement_chain(*args, **kw)
        ref = K.placement_chain_plain(*args, **kw)
        _identical(torch, got, ref, f"K4a {label}")
        placed = int((got[0][:, 0] >= 0).sum())
        print(f"phase K4a edge {label}: {mode}, table {table}, T={t}, "
              f"P={p}, {n_trig} full rescores, {placed} placed: identical "
              f"to plain bit for bit", flush=True)
    # A demand change under one key (scan mode reads a demand per step).
    w = window_inputs(torch, dev, rng, n, 1)
    st = run_steps(torch, dev, rng, 1, 192)
    demands = w["key_demands"][st["tg_ids"].long()].contiguous()
    demands[64:128] *= 1.5
    demands[128:] *= 0.5
    args = (w["capacity"], w["score_cap"], w["usage"], w["tg_masks"],
            w["job_counts0"], demands, st["tg_ids"], st["valid"], w["noise"],
            10.0, False, w["banned0"])
    _identical(torch, K.placement_chain(*args), K.placement_chain_plain(*args),
               "K4a demand change mid-run")
    n_trig = chain_triggers(st["tg_ids"], st["valid"], None, demands)
    check(n_trig == 3, f"K4a demand change: {n_trig} triggers, want 3")
    print(f"phase K4a edge demand change mid-run: scan, table {n}, P=192, "
          f"{n_trig} full rescores: identical to plain bit for bit",
          flush=True)


def select_edge_cases(torch, dev, K, rng):
    """The radix select at its edges, at K2's and K8's shapes, each against
    the plain versions' stable sort bit for bit: exact and noise-only ties,
    distinct on and off, k = 1 and k = n, several keys, a key with fewer
    feasible rows than k."""
    n = 16384
    for label, rows, t, k, fleet, distinct, starve in (
            ("exact ties", n, 1, 4096, dict(uniform=True, zero_noise=True),
             False, False),
            ("k = 1, 3 keys, distinct on", n, 3, 1, {}, True, False),
            ("3 keys, key 0 starved", n, 3, 64, {}, False, True),
            ("k = n, 2 keys", 4096, 2, 4096, {}, True, False),
            ("k = n, exact ties", 4096, 1, 4096,
             dict(uniform=True, zero_noise=True), False, False)):
        w = window_inputs(torch, dev, rng, rows, t, **fleet)
        if starve:
            w["tg_masks"][0] = False
            w["tg_masks"][0, [3, rows // 2]] = True
        args = (w["capacity"], w["score_cap"], w["usage"], w["tg_masks"],
                w["job_counts0"], w["key_demands"], w["noise"], 10.0,
                distinct, w["banned0"], k)
        _identical(torch, K.score_topk(*args), K.score_topk_plain(*args),
                   f"K2 select {label}")
        print(f"phase K2 select edge {label}: N={rows} T={t} k={k}: masked0 "
              f"(bits), nf0 and the ordered top-k identical to plain",
              flush=True)
    n_loc = MESH_ROWS // MESH_SHARDS
    for label, rows, t, b_buf, fleet, distinct in (
            ("exact ties", n_loc, 1, 2048,
             dict(uniform=True, zero_noise=True), False),
            ("noise-only ties, distinct on", n_loc, 1, 2048,
             dict(uniform=True), True),
            ("B = 1, 3 keys", n_loc, 3, 1, {}, True),
            ("B = n (8,192-row shard), 2 keys", 8192, 2, 8192, {}, False)):
        w = window_inputs(torch, dev, rng, rows, t, **fleet)
        tab = K.mesh_pack(w["capacity"], w["score_cap"], w["job_counts0"],
                          w["noise"], w["banned0"])
        args = (tab, w["usage"], w["tg_masks"], w["key_demands"], 10.0,
                distinct, 5 * rows, b_buf)
        _identical(torch, K.cold_packet(*args), K.cold_packet_plain(*args),
                   f"K8 select {label}")
        print(f"phase K8 select edge {label}: n_loc={rows} T={t} B={b_buf}: "
              f"packet, nf0 and top-B values identical to plain", flush=True)


def compact_inputs(torch, dev, rng, e, p):
    """packed3 [E, P, 3] as a window leaves it (rows, -1 where no row was
    found, -inf scores there), valid with a ragged tail per eval, last_idx
    at each eval's last valid step."""
    n_valid = rng.integers(1, p + 1, e)
    valid = np.arange(p)[None, :] < n_valid[:, None]
    rows = rng.integers(0, 16384, (e, p)).astype(np.float32)
    rows[(rng.random((e, p)) < 0.05) | ~valid] = -1.0
    scores = rng.uniform(0, 18, (e, p)).astype(np.float32)
    scores[rows < 0] = -np.inf
    nf = rng.integers(0, 16384, (e, p)).astype(np.float32)
    packed3 = np.stack([rows, scores, nf], axis=-1)
    last = (n_valid - 1).astype(np.int32)
    return (torch.tensor(packed3, device=dev), torch.tensor(valid, device=dev),
            torch.tensor(last, device=dev))


# --------------------------------------------------------------- storm


def build_nodes(n=None):
    """The fleet of BASELINE config 3: N_NODES (10,000) mock nodes, or n,
    in 64 computed classes (Meta.rack = r{i % 64})."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import compute_node_class

    nodes = []
    for i in range(N_NODES if n is None else n):
        node = mock.node()
        node.Meta["rack"] = f"r{i % N_CLASSES}"
        compute_node_class(node)
        nodes.append(node)
    return nodes


def make_job(kind: str = "service"):
    """One job of BASELINE config 3 (bench.py build_job): one task group of
    Count = 50, CPU 20, MemoryMB 32, DiskMB 10, no networks, and the
    `${attr.arch} = x86` constraint. kind "batch" makes it a batch job,
    "distinct" adds distinct_hosts, "two-groups" adds a second group."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import Constraint

    j = mock.job()
    j.Constraints.append(
        Constraint(LTarget="${attr.arch}", RTarget="x86", Operand="="))
    if kind == "batch":
        j.Type = "batch"
    if kind == "distinct":
        j.Constraints.append(Constraint(Operand="distinct_hosts"))
    tg = j.TaskGroups[0]
    tg.Count = PER_EVAL
    task = tg.Tasks[0]
    task.Resources.CPU = 20
    task.Resources.MemoryMB = 32
    task.Resources.DiskMB = 10
    task.Resources.Networks = []
    task.Services = []
    if task.LogConfig is not None:
        task.LogConfig.MaxFiles = 1
        task.LogConfig.MaxFileSizeMB = 1
    if kind == "two-groups":
        second = tg.copy()
        second.Name = f"{tg.Name}1"
        second.Tasks[0].Resources.CPU = 30
        j.TaskGroups.append(second)
    return j


def build_workload():
    """The fleet and jobs of the per-eval storm, built once so every storm
    run sees the same objects (copied per run)."""
    nodes = build_nodes()
    jobs = ([(make_job("service"), False) for _ in range(N_SERVICE_EVALS)]
            + [(make_job("batch"), True), (make_job("distinct"), False)])
    return nodes, jobs


def _live_placements(h):
    return {(a.JobID, a.Name): a.NodeID for a in h.state.allocs()
            if not a.terminal_status()}


def _nodes_by_job(live):
    out = {}
    for (job_id, _), node_id in live.items():
        out.setdefault(job_id, []).append(node_id)
    return {k: sorted(v) for k, v in out.items()}


def run_storm(torch, nodes, jobs, seed: int, plain: bool, trace=False,
              device="cuda"):
    """One storm on a fresh Harness: every job's register eval in order,
    the batch job's forced down the scan route, then a destructive
    re-register of the first job (a new CPU ask: evictions and placements
    in one plan, so the dispatch overlays the evictions on a copy of the
    device usage). plain=True runs every stage's plain version on the
    card; trace=True records device activity with torch.profiler."""
    from nomad_tpu_torch import native
    from nomad_tpu_torch.scheduler import GenericScheduler, Harness
    from nomad_tpu_torch.scheduler import stack as stack_mod
    from nomad_tpu_torch.structs import Evaluation
    from nomad_tpu_torch.structs.structs import EvalTriggerJobRegister

    h = Harness(device=device)
    for node in nodes:
        h.upsert("node", node.copy())
    jobs = [(j.copy(), batch) for j, batch in jobs]
    for j, _ in jobs:
        h.upsert("job", j)
    h.tindex.nt.device_arrays()   # initial upload, outside the timed storm
    rng = random.Random(seed)
    logger = logging.getLogger("chip_smoke")
    sync = torch.cuda.synchronize if h.tindex.nt.device.type == "cuda" \
        else (lambda: None)

    def counts():   # stage runs of either kind: kernel launches + plain calls
        return {k: native.LAUNCHES[k] + native.PLAIN_CALLS[k]
                for k in native.KERNELS}

    scan_job = N_SERVICE_EVALS   # the batch job
    update_job = jobs[0][0].ID

    def process(eval_id, j, batch):
        ev = Evaluation(ID=eval_id, Priority=j.Priority, Type=j.Type,
                        TriggeredBy=EvalTriggerJobRegister, JobID=j.ID)
        GenericScheduler(h.state.snapshot(), h, h.tindex, logger,
                         batch=batch, rng=rng).process(ev)

    sync()
    trace_ctx = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
        if trace else contextlib.nullcontext())
    plain_ctx = native.plain_versions() if plain else contextlib.nullcontext()
    native.reset_counts()
    with plain_ctx, trace_ctx as prof:
        t0 = time.monotonic()
        for i, (j, batch) in enumerate(jobs):
            if i != scan_job:
                process(f"eval-{i:04d}", j, batch)
                continue
            before = counts()
            budget = stack_mod.KEYED_CAND_BUDGET
            stack_mod.KEYED_CAND_BUDGET = 0
            try:
                process(f"eval-{i:04d}", j, batch)
            finally:
                stack_mod.KEYED_CAND_BUDGET = budget
            scan_counts = {k: v - before[k] for k, v in counts().items()}
        updated = h.state.job_by_id(update_job).copy()
        updated.TaskGroups[0].Tasks[0].Resources.CPU *= 2
        h.upsert("job", updated)
        process("eval-update", updated, False)
        d = h.tindex.nt.device_arrays()
        sync()
        wall = time.monotonic() - t0
    device_ms = {}
    if prof is not None:
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0)
            if us:
                device_ms[ev.key] = us / 1e3
    launches, plain_calls = dict(native.LAUNCHES), dict(native.PLAIN_CALLS)
    placed = sum(len(allocs) for plan in h.plans
                 for allocs in plan.NodeAllocation.values())
    evicted = sum(len(allocs) for plan in h.plans[-1:]
                  for allocs in plan.NodeUpdate.values())
    return dict(live=_live_placements(h), placed=placed, evicted=evicted,
                n_evals=len(h.evals), usage_host=h.tindex.nt.usage.copy(),
                usage_dev=d["usage"].cpu().numpy(), wall=wall,
                launches=launches, plain_calls=plain_calls,
                scan_counts=scan_counts, device_ms=device_ms,
                statuses=[e.Status for e in h.evals],
                capacity=h.tindex.nt.capacity.copy(), update_job=update_job)


def storm_phase(torch, gpu: str, device="cuda"):
    """Three storms on the same workload in one call: kernels (the timed
    main-path run, whose launch counts the kernels line reports), plain
    versions, and kernels again under the device trace for the busy share."""
    seed = 1017
    t0 = time.monotonic()
    nodes, jobs = build_workload()
    print(f"phase storm: built {len(nodes)} nodes and {len(jobs)} jobs in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    kern = run_storm(torch, nodes, jobs, seed, plain=False, device=device)
    plain = run_storm(torch, nodes, jobs, seed, plain=True, device=device)
    traced = run_storm(torch, nodes, jobs, seed, plain=False,
                       trace=device == "cuda", device=device)
    want_live = len(jobs) * PER_EVAL
    want_placed = want_live + PER_EVAL
    runs = ((kern, "kernel"), (plain, "plain"), (traced, "traced kernel"))
    for run, name in runs:
        check(len(run["live"]) == want_live,
              f"storm {name} run: {len(run['live'])} live allocs, want "
              f"{want_live}")
        check(run["placed"] == want_placed,
              f"storm {name} run placed {run['placed']} of {want_placed}")
        check(run["evicted"] == PER_EVAL,
              f"storm {name} run: the update evicted {run['evicted']} of "
              f"{PER_EVAL}")
        check(all(s == "complete" for s in run["statuses"]),
              f"storm {name} run: eval statuses {set(run['statuses'])}")
        check(np.array_equal(run["usage_host"], run["usage_dev"]),
              f"storm {name} run: device usage differs from the host mirror")
        check(bool((run["usage_host"] <= run["capacity"]).all()),
              f"storm {name} run: a node is over capacity")
        # The forced eval went down the scan route: K4a alone, no K2/K3.
        sc = run["scan_counts"]
        check(sc["placement_chain"] > 0 and sc["score_topk"] == 0
              and sc["merge_candidates"] == 0,
              f"storm {name} run: forced scan eval ran {sc}")
        # Which alloc name of the updated job lands where follows the
        # store's iteration over its old allocs, keyed by random alloc IDs;
        # the nodes it holds may not differ, and no other alloc may move.
        other = {k: v for k, v in run["live"].items()
                 if k[0] != run["update_job"]}
        ref_other = {k: v for k, v in kern["live"].items()
                     if k[0] != kern["update_job"]}
        check(other == ref_other,
              f"storm: {name} and kernel runs placed differently")
        check(_nodes_by_job(run["live"]) == _nodes_by_job(kern["live"]),
              f"storm: {name} and kernel runs hold different nodes per job")
        check(np.array_equal(run["usage_host"], kern["usage_host"]),
              f"storm: committed usage differs between {name} and kernel "
              f"runs")
    for run, name in ((kern, "kernel"), (traced, "traced kernel")):
        for k in STORM_KERNELS:
            check(run["launches"][k] > 0,
                  f"storm {name} run: kernel {k} never launched")
        check(not any(run["plain_calls"].values()),
              f"storm {name} run: plain versions ran: {run['plain_calls']}")
    check(not any(plain["launches"].values()),
          f"storm: kernels launched in the plain run: {plain['launches']}")
    distinct_job = jobs[-1][0].ID
    hosts = [n for (j, _), n in kern["live"].items() if j == distinct_job]
    check(len(set(hosts)) == len(hosts), "storm: distinct_hosts violated")
    n_evals = kern["n_evals"]
    for run, name in runs:
        print(f"phase storm ({name} run) on {gpu}: {n_evals} evals, "
              f"{want_placed} placements, {PER_EVAL} evictions in "
              f"{run['wall']:.3f} s: {n_evals / run['wall']:.1f} evals/s, "
              f"{want_placed / run['wall']:.1f} placements/s", flush=True)
    busy = sum(traced["device_ms"].values())
    top = sorted(traced["device_ms"].items(), key=lambda kv: -kv[1])[:8]
    if busy > 0:
        print(f"phase storm (traced kernel run) on {gpu}: device busy "
              f"{busy:.3f} ms of {traced['wall'] * 1e3:.1f} ms wall, idle "
              f"share {1 - busy / (traced['wall'] * 1e3):.4f}; device ms by "
              f"kernel: "
              + "; ".join(f"{k[:60]}={v:.3f}" for k, v in top), flush=True)
    else:
        print("phase storm (traced kernel run): device busy share not "
              "measured: the trace held no device time", flush=True)
    print(f"phase storm: kernel, plain and traced runs hold the same {want_live}"
          f" allocs on the same nodes with identical committed usage; the "
          f"batch eval went down the scan route ({kern['scan_counts']}); "
          f"main-path launches {kern['launches']}", flush=True)
    return kern["launches"]


# ------------------------------------------------------- served path


def _fixed_noise(n_rows, rng):
    """The served runs' tie-break noise: one seeded vector instead of the
    worker's unseeded refresh, so two runs place identically."""
    return (np.random.default_rng(20261017).random(n_rows)
            * 1e-3).astype(np.float32)


def _sync(torch, device):
    if device == "cuda":
        torch.cuda.synchronize()


def _new_server(torch, nodes, num_schedulers, device, mesh=None):
    from nomad_tpu_torch.server import Server, ServerConfig

    srv = Server(ServerConfig(num_schedulers=num_schedulers,
                              scheduler_window=WINDOW, device=device,
                              **PARKED))
    if mesh is not None:
        srv.tindex.nt.set_mesh(mesh)
    srv.establish_leadership()
    for node in nodes:
        srv.node_register(node.copy())
    srv.tindex.nt.device_arrays()   # initial upload, outside the runs
    _sync(torch, device)
    return srv


def _usage_checks(torch, srv, what):
    nt = srv.tindex.nt
    dev_usage = nt.device_arrays()["usage"].cpu().numpy()
    check(np.array_equal(dev_usage, nt.usage),
          f"{what}: device usage differs from the host mirror")
    check(bool((nt.usage <= nt.capacity).all()),
          f"{what}: a node is over capacity")
    return nt.usage.copy()


def run_served_identity(torch, nodes, windows, plain: bool, device,
                        mesh=None):
    """One dev server, one pipelined worker driven by hand through the
    given windows (each a list of jobs registered together), finishing each
    window as the worker's build stage does. plain=True runs inside
    native.plain_versions(). With a mesh on the server's table, every
    window is dispatched before the first one drains, as the worker keeps
    windows in flight, so each chains on its predecessor's MeshChain."""
    from nomad_tpu_torch import native
    from nomad_tpu_torch.server.pipelined_worker import (
        _MESH_FLAGS, PipelinedWorker)

    srv = _new_server(torch, nodes, num_schedulers=0, device=device,
                      mesh=mesh)
    try:
        w = PipelinedWorker(srv.raft, srv.eval_broker, srv.plan_queue,
                            srv.blocked_evals, srv.tindex,
                            ["service", "batch", "system"], window=WINDOW)
        layouts, flags = [], []
        plain_ctx = (native.plain_versions() if plain
                     else contextlib.nullcontext())

        def finish(work):
            work.packed = w._drain_window(work)
            w._finish_fast(work)
            for ev, token in work.slow:
                w._process_slow(ev, token)
            layouts.append(sorted({
                ent[0] if ent[0] == "host" else
                ent[1][0] if ent[1][0] == "multi" else
                f"stack-{ent[1][1]}" for ent in work.drain.layout}))
            fl = work.drain.fetches.get(_MESH_FLAGS)
            flags.append(fl[0].numpy().tolist() if fl is not None else [])
            # The build stage's window end: settle, and on a drained
            # pipeline prefetch the dirty-row refresh (K4b).
            w._arbiter.mark_settled(work.chain_seq)
            if w._arbiter.finish_window():
                srv.tindex.nt.device_arrays()

        native.reset_counts()
        with plain_ctx:
            t0 = time.monotonic()
            in_flight = []
            for jobs in windows:
                for j in jobs:
                    srv.job_register(j.copy())
                batch = w._dequeue_window()
                check(len(batch) == len(jobs),
                      f"served-identity: window of {len(batch)} evals, want "
                      f"{len(jobs)}")
                batch.sort(key=lambda pair: pair[0].JobID)
                work = w._dispatch_window(batch)
                check(work is not None and len(work.fast) == len(jobs),
                      "served-identity: not every eval took the fast path")
                in_flight.append(work)
                if mesh is None:
                    finish(in_flight.pop())
            for work in in_flight:
                finish(work)
            _sync(torch, device)
            wall = time.monotonic() - t0
        launches, plain_calls = dict(native.LAUNCHES), dict(native.PLAIN_CALLS)
        live = {(a.JobID, a.Name): a.NodeID for a in srv.state.allocs()
                if not a.terminal_status()}
        statuses = {e.Status for e in srv.state.evals()}
        usage = _usage_checks(torch, srv, "served-identity")
        return dict(live=live, statuses=statuses, usage=usage, wall=wall,
                    launches=launches, plain_calls=plain_calls,
                    stats=dict(w.stats), layouts=layouts, flags=flags)
    finally:
        srv.shutdown()


def served_identity_phase(torch, gpu: str, device="cuda"):
    from nomad_tpu_torch import native
    from nomad_tpu_torch.scheduler import stack as stack_mod

    nodes = build_nodes()
    windows = [[make_job() for _ in range(WINDOW)],
               [make_job("distinct"), make_job("two-groups")]]
    want = sum(len(j.TaskGroups) for win in windows for j in win) * PER_EVAL
    noise_fn = stack_mod.make_noise_vec
    stack_mod.make_noise_vec = _fixed_noise
    try:
        kern = run_served_identity(torch, nodes, windows, False, device)
        plain = run_served_identity(torch, nodes, windows, True, device)
    finally:
        stack_mod.make_noise_vec = noise_fn
    for run, name in ((kern, "kernel"), (plain, "plain")):
        check(len(run["live"]) == want,
              f"served-identity {name} run: {len(run['live'])} live allocs, "
              f"want {want}")
        check(run["statuses"] == {"complete"},
              f"served-identity {name} run: eval statuses {run['statuses']}")
        check(run["stats"]["multi"] == 1 and run["stats"]["fallback"] == 0,
              f"served-identity {name} run: worker stats {run['stats']}")
        # The storm window compacts as one fused parent, the mixed window
        # as two stacks of singles (64 and 128 padded placements).
        check(run["layouts"] == [["multi"], ["stack-128", "stack-64"]],
              f"served-identity {name} run: drain layouts {run['layouts']}")
    check(kern["live"] == plain["live"],
          "served-identity: kernel and plain runs placed differently")
    check(np.array_equal(kern["usage"], plain["usage"]),
          "served-identity: committed usage differs between kernel and "
          "plain runs")
    print(f"phase served-identity on {gpu}: {len(windows[0])}-eval storm "
          f"window + mixed window, {want} placements; kernel and plain runs "
          f"hold the same allocs on the same nodes with identical usage; "
          f"wall kernel/plain {kern['wall']:.3f}/{plain['wall']:.3f} s; "
          f"drain layouts {kern['layouts']}; launches {kern['launches']}",
          flush=True)
    for k in SERVED_KERNELS:
        check(kern["launches"][k] > 0,
              f"served-identity kernel run: kernel {k} never launched")
    check(not any(kern["plain_calls"].values()),
          f"served-identity kernel run: plain versions ran: "
          f"{kern['plain_calls']}")
    check(not any(plain["launches"].values()),
          f"served-identity plain run: kernels launched: {plain['launches']}")


MESH_IDENTITY_WINDOWS = 3   # storm windows of the mesh-served-identity


def mesh_served_identity_phase(torch, gpu: str, dev):
    """The served path's storm windows on S = MESH_SHARDS logical shards
    at full width, once through the kernels and once inside
    `native.plain_versions()`: the first window cold, the rest warm, each
    window's stages (K6-K10 with K2, K3, K4a and K5) at the shapes the
    mesh-served storm gives them."""
    from nomad_tpu_torch.parallel import scheduling_mesh
    from nomad_tpu_torch.scheduler import stack as stack_mod

    nodes = build_nodes()
    windows = [[make_job() for _ in range(WINDOW)]
               for _ in range(MESH_IDENTITY_WINDOWS)]
    want = WINDOW * MESH_IDENTITY_WINDOWS * PER_EVAL
    mesh = scheduling_mesh([dev] * MESH_SHARDS)
    noise_fn = stack_mod.make_noise_vec
    stack_mod.make_noise_vec = _fixed_noise
    try:
        kern = run_served_identity(torch, nodes, windows, False, "cuda", mesh)
        plain = run_served_identity(torch, nodes, windows, True, "cuda", mesh)
    finally:
        stack_mod.make_noise_vec = noise_fn
    for run, name in ((kern, "kernel"), (plain, "plain")):
        st = run["stats"]
        check(len(run["live"]) == want,
              f"mesh-served-identity {name} run: {len(run['live'])} live "
              f"allocs, want {want}")
        check(run["statuses"] == {"complete"},
              f"mesh-served-identity {name} run: eval statuses "
              f"{run['statuses']}")
        check(st["mesh_windows"] == MESH_IDENTITY_WINDOWS
              and st["mesh_warm"] == MESH_IDENTITY_WINDOWS - 1
              and st["mesh_cert_miss"] == 0 and st["fallback"] == 0
              and st["mesh_shards"] == MESH_SHARDS,
              f"mesh-served-identity {name} run: worker stats {st}")
        check(run["layouts"] == [["multi"]] * MESH_IDENTITY_WINDOWS,
              f"mesh-served-identity {name} run: drain layouts "
              f"{run['layouts']}")
    check(kern["live"] == plain["live"],
          "mesh-served-identity: kernel and plain runs placed differently")
    check(np.array_equal(kern["usage"], plain["usage"]),
          "mesh-served-identity: committed usage differs between kernel "
          "and plain runs")
    # Cold windows carry no flag; each warm window one, held at 0.
    want_flags = [[]] + [[0.0]] * (MESH_IDENTITY_WINDOWS - 1)
    check(kern["flags"] == plain["flags"] == want_flags,
          f"mesh-served-identity: certificate flags kernel {kern['flags']}, "
          f"plain {plain['flags']}, want {want_flags}")
    for k in ("score_topk", "merge_candidates", "placement_chain",
              "compact_window") + MESH_KERNELS:
        check(kern["launches"][k] > 0,
              f"mesh-served-identity kernel run: kernel {k} never launched")
    check(not any(kern["plain_calls"].values()),
          f"mesh-served-identity kernel run: plain versions ran: "
          f"{kern['plain_calls']}")
    check(not any(plain["launches"].values()),
          f"mesh-served-identity plain run: kernels launched: "
          f"{plain['launches']}")
    print(f"phase mesh-served-identity on {gpu}: {MESH_IDENTITY_WINDOWS} "
          f"{WINDOW}-eval storm windows (1 cold, "
          f"{MESH_IDENTITY_WINDOWS - 1} warm) on {MESH_SHARDS} logical "
          f"shards, {want} placements; kernel and plain runs hold the same "
          f"allocs on the same nodes with identical usage and certificate "
          f"flags {kern['flags']}; wall kernel/plain {kern['wall']:.3f}/"
          f"{plain['wall']:.3f} s; launches {kern['launches']}; plain calls "
          f"{plain['plain_calls']}", flush=True)
    cert_miss_case(torch, gpu, mesh)


# The certificate-miss case of mesh-served-identity: a fleet of 2,000 nodes
# (2,048 rows, 256 a logical shard) whose first 256 nodes, shard 0's rows,
# are half reserved and so score above every other row; windows of 4 evals
# of 16 placements (k = 64, B = 128: the pool is a true subset of every
# shard) whose CPU 1,500 fills a hot node with one placement. A cold window
# puts shard 0's 128th score as tau, with 127 pool rows above it, and fills
# 64 of them; the warm window after it finds 63 < k above tau and the pool
# short of the table's feasible rows: its certificate fails.
CERT_NODES = 2000
CERT_HOT = 256
CERT_WINDOW = 4
CERT_PER_EVAL = 16
CERT_WINDOWS = 6


def cert_workload():
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import compute_node_class

    nodes = []
    for i in range(CERT_NODES):
        node = mock.node()
        if i < CERT_HOT:
            node.Reserved.CPU = 2100
        compute_node_class(node)
        nodes.append(node)
    jobs = []
    for _ in range(CERT_WINDOW * CERT_WINDOWS):
        job = make_job()
        job.TaskGroups[0].Count = CERT_PER_EVAL
        job.TaskGroups[0].Tasks[0].Resources.CPU = 1500
        jobs.append(job)
    return nodes, jobs


def run_cert_miss(torch, nodes, jobs, plain: bool, mesh=None):
    """A dev server and a pipelined worker driven through the worker's own
    drain and build stages (`_drain_loop`, `_build_loop`), CERT_WINDOW
    evals a window. On a mesh two windows are dispatched back to back (the
    first cold: the pipeline had drained; the second warm), so a warm
    window's failed certificate fails its drain, and the build stage nacks
    its evals and taints the chain, as a live worker does; the broker hands
    them out again in their order, and they lead the next pair, cold. Each
    eval is nacked at most once, and every committed window is exact, so
    the placements equal one device's window by window."""
    from nomad_tpu_torch import native
    from nomad_tpu_torch.server.pipelined_worker import (
        _MESH_FLAGS, PipelinedWorker)

    srv = _new_server(torch, nodes, num_schedulers=0, device="cuda",
                      mesh=mesh)
    log = logging.getLogger("nomad.worker.pipelined")
    level = log.level
    try:
        w = PipelinedWorker(srv.raft, srv.eval_broker, srv.plan_queue,
                            srv.blocked_evals, srv.tindex,
                            ["service", "batch", "system"],
                            window=CERT_WINDOW)
        plain_ctx = (native.plain_versions() if plain
                     else contextlib.nullcontext())
        depth = 1 if mesh is None else 2
        flags, n_windows, nacked = [], 0, 0
        # The drain failure of a missed certificate is logged with its
        # traceback by the worker; it is this case's expected path.
        log.setLevel(logging.CRITICAL)
        native.reset_counts()
        with plain_ctx:
            for j in jobs:
                srv.job_register(j.copy())
            for _ in range(4 * CERT_WINDOWS):
                works = []
                while (len(works) < depth
                       and srv.eval_broker.stats.TotalReady > 0):
                    batch = w._dequeue_window()
                    batch.sort(key=lambda pair: pair[0].JobID)
                    n_windows += 1
                    work = w._dispatch_window(batch)
                    check(work is not None and len(work.fast) == len(batch),
                          "cert-miss: not every eval took the fast path")
                    works.append(work)
                if not works:
                    break
                stages = [threading.Thread(target=w._drain_loop),
                          threading.Thread(target=w._build_loop)]
                for th in stages:
                    th.start()
                for work in works + [None]:
                    w._drain_q.put(work)
                for th in stages:
                    th.join(timeout=300)
                check(not any(th.is_alive() for th in stages),
                      "cert-miss: the worker's stages never finished")
                for work in works:
                    fl = work.drain.fetches.get(_MESH_FLAGS)
                    flags.append(fl[0].numpy().tolist() if fl is not None
                                 else [])
                    nacked += len(work.fast) if work.failed else 0
            _sync(torch, "cuda")
        launches, plain_calls = dict(native.LAUNCHES), dict(native.PLAIN_CALLS)
        live = {(a.JobID, a.Name): a.NodeID for a in srv.state.allocs()
                if not a.terminal_status()}
        statuses = {e.Status for e in srv.state.evals()}
        usage = _usage_checks(torch, srv, "cert-miss")
        return dict(live=live, statuses=statuses, usage=usage, flags=flags,
                    windows=n_windows, nacked=nacked, stats=dict(w.stats),
                    launches=launches, plain_calls=plain_calls)
    finally:
        log.setLevel(level)
        srv.shutdown()


def cert_miss_case(torch, gpu: str, mesh):
    """The certificate-miss case on the mesh, kernels and plain versions,
    against one device."""
    from nomad_tpu_torch.scheduler import stack as stack_mod

    nodes, jobs = cert_workload()
    noise_fn = stack_mod.make_noise_vec
    stack_mod.make_noise_vec = _fixed_noise
    try:
        kern = run_cert_miss(torch, nodes, jobs, False, mesh)
        plain = run_cert_miss(torch, nodes, jobs, True, mesh)
        one = run_cert_miss(torch, nodes, jobs, False)
    finally:
        stack_mod.make_noise_vec = noise_fn
    want = len(jobs) * CERT_PER_EVAL
    for run, name in ((kern, "kernel"), (plain, "plain"), (one, "one device")):
        check(len(run["live"]) == want and run["statuses"] == {"complete"},
              f"cert-miss {name} run: {len(run['live'])} live allocs, want "
              f"{want}; eval statuses {run['statuses']}")
    misses = kern["stats"]["mesh_cert_miss"]
    check(misses > 0 and kern["flags"] == plain["flags"]
          and misses == sum(f == [1.0] for f in kern["flags"])
          and plain["stats"]["mesh_cert_miss"] == misses,
          f"cert-miss: flags kernel {kern['flags']}, plain {plain['flags']}, "
          f"misses {misses}")
    check(any(f == [0.0] for f in kern["flags"]),
          f"cert-miss: no warm window held its certificate {kern['flags']}")
    check(kern["live"] == plain["live"] == one["live"],
          "cert-miss: kernel, plain and one-device runs placed differently")
    check(np.array_equal(kern["usage"], plain["usage"])
          and np.array_equal(kern["usage"], one["usage"]),
          "cert-miss: committed usage differs between the runs")
    print(f"phase mesh-served-identity cert-miss on {gpu}: {len(jobs)} evals "
          f"in windows of {CERT_WINDOW} on a {CERT_NODES}-node fleet "
          f"({CERT_HOT} hot rows), {MESH_SHARDS} logical shards; "
          f"{kern['windows']} windows dispatched, certificate misses "
          f"{misses} ({kern['nacked']} evals nacked and re-run cold); flags "
          f"{kern['flags']}; kernel, plain and one-device runs hold the same "
          f"{want} allocs on the same nodes with identical usage; launches "
          f"{kern['launches']}", flush=True)
    check(kern["launches"]["warm_finish"] > 0
          and not any(kern["plain_calls"].values())
          and not any(plain["launches"].values()),
          f"cert-miss: kernel launches {kern['launches']}, plain calls "
          f"{kern['plain_calls']}; plain run launches {plain['launches']}")


def _storm_runner(srv, job_fn=make_job):
    """bench.py's _make_storm_runner on the port: register `count` jobs
    made by `job_fn`, poll (bounded) until every eval completes, record each
    eval's latency from its register call to the poll that saw it
    complete."""
    def run(count, latencies=None, poll=0.02):
        t_submit, eval_ids = {}, []
        for _ in range(count):
            eid = srv.job_register(job_fn())[0]
            t_submit[eid] = time.monotonic()
            eval_ids.append(eid)
        deadline = time.monotonic() + 300
        pending = set(eval_ids)
        while pending and time.monotonic() < deadline:
            now = time.monotonic()
            done = {eid for eid in pending
                    if (e := srv.state.eval_by_id(eid)) is not None
                    and e.Status == "complete"}
            if latencies is not None:
                latencies.extend(now - t_submit[eid] for eid in done)
            pending -= done
            if pending:
                time.sleep(poll)
        check(not pending, f"served: {len(pending)} of {count} evals never "
              f"completed")
        return eval_ids
    return run


def trace_counts(prof) -> dict:
    """From a torch.profiler session with CUDA activity: the host->device
    and device->host copies on the card (memcpy activities), and the CUDA
    runtime calls that synchronize a stream or an event or start a copy.
    `runtime` counts every runtime call traced: 0 means the trace holds no
    runtime calls, and the call counts are not measured."""
    out = dict(memcpy_htod=0, memcpy_dtoh=0, cudaStreamSynchronize=0,
               cudaEventSynchronize=0, cudaMemcpy=0, runtime=0)
    for ev in prof.key_averages():
        key, count = ev.key, ev.count
        if key.startswith("Memcpy") and "HtoD" in key:
            out["memcpy_htod"] += count
        elif key.startswith("Memcpy") and "DtoH" in key:
            out["memcpy_dtoh"] += count
        if key.startswith("cuda"):
            out["runtime"] += count
            if key.startswith("cudaMemcpy"):
                out["cudaMemcpy"] += count
            elif key in out:
                out[key] += count
    return out


def refresh_probe(torch, nt, gpu: str, rows_dirty: int = 50,
                  reps: int = 100):
    """The dirty-row refresh as a commit of one 50-placement eval leaves it
    (50 usage rows: the 128-row bucket) on a served table: host ms a
    refresh on an idle stream, host ms a refresh issued right behind a
    long kernel (a refresh that waits for the stream takes the kernel's
    time), and, under the profiler, the copies and syncs a refresh
    issues. The deltas are zeros: the rows turn dirty, the table keeps its
    values."""
    from nomad_tpu_torch import native

    live = np.array(sorted(nt.row_of.values()), dtype=np.int64)
    rows = np.sort(np.random.default_rng(5).choice(live, rows_dirty,
                                                   replace=False))
    zero = np.zeros((rows_dirty, 5), dtype=np.float32)

    def dirty():
        check(nt.apply_row_usage_deltas(rows, zero, nt.row_epoch),
              "refresh probe: the row epoch moved")

    def timed_refresh(out):
        dirty()
        t0 = time.perf_counter()
        nt.device_arrays()
        out.append((time.perf_counter() - t0) * 1e3)

    dirty()
    nt.device_arrays()
    torch.cuda.synchronize()
    idle, behind = [], []
    for _ in range(reps):
        timed_refresh(idle)
        torch.cuda.synchronize()
    sleep_ms = time_ms(torch, lambda: torch.cuda._sleep(2_000_000), 5)
    for _ in range(20):
        torch.cuda._sleep(2_000_000)
        timed_refresh(behind)
        torch.cuda.synchronize()
    native.reset_counts()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            dirty()
            nt.device_arrays()
        torch.cuda.synchronize()
    per = {k: v / reps for k, v in trace_counts(prof).items()}
    launches = native.LAUNCHES["scatter_refresh"]
    print(f"phase refresh probe on {gpu}: {rows_dirty} dirty usage rows a "
          f"refresh: host ms a refresh on an idle stream median "
          f"{np.median(idle):.4f} (p90 {np.percentile(idle, 90):.4f}); "
          f"issued behind a {sleep_ms:.3f} ms kernel median "
          f"{np.median(behind):.4f} (p90 {np.percentile(behind, 90):.4f}); "
          f"a refresh traced: {json.dumps(per)} (K4b launches "
          f"{launches / reps:g})", flush=True)
    check(launches == reps, f"refresh probe: {launches} K4b launches for "
          f"{reps} refreshes")
    return per


def served_phase(torch, gpu: str, device="cuda"):
    """The served storm: untraced and timed, then traced on the same shape.
    Returns the untraced storm's launches per kernel."""
    from nomad_tpu_torch import native

    nodes = build_nodes()
    t0 = time.monotonic()
    srv = _new_server(torch, nodes, num_schedulers=1, device=device)
    print(f"phase served: {len(nodes)} nodes registered on a dev server in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    try:
        worker = srv.workers[0]
        run = _storm_runner(srv)
        # Warm-up: small storms (first launches, the refresh after a
        # commit), every refresh bucket, then one full-depth storm window.
        run(3)
        run(3)
        srv.tindex.nt.warm_device()
        run(2 * WINDOW)
        check(worker.quiesce(60), "served: warm-up never quiesced")
        results = {}
        runs = [(f"untraced {i + 1}", False) for i in range(N_SERVED_REPS)]
        for label, traced in runs + [("traced", True)]:
            worker.reset_stats()
            gc.collect()
            native.reset_counts()
            lats = []
            _sync(torch, device)
            trace_ctx = (torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
                if traced and device == "cuda" else contextlib.nullcontext())
            with trace_ctx as prof:
                t0 = time.monotonic()
                eval_ids = run(N_SERVED_EVALS, latencies=lats)
                _sync(torch, device)
                wall = time.monotonic() - t0
            check(worker.quiesce(60), f"served {label}: never quiesced")
            placed = sum(1 for eid in eval_ids
                         for _ in srv.state.allocs_by_eval(eid))
            check(placed == N_SERVED_EVALS * PER_EVAL,
                  f"served {label}: {placed} placements, want "
                  f"{N_SERVED_EVALS * PER_EVAL}")
            device_ms, counts = {}, None
            if prof is not None:
                for ev in prof.key_averages():
                    us = getattr(ev, "self_device_time_total", None)
                    if us is None:
                        us = getattr(ev, "self_cuda_time_total", 0)
                    if us:
                        device_ms[ev.key] = us / 1e3
                counts = trace_counts(prof)
            results[label] = dict(
                wall=wall, lats=lats, placed=placed, stats=dict(worker.stats),
                launches=dict(native.LAUNCHES),
                plain_calls=dict(native.PLAIN_CALLS), device_ms=device_ms,
                counts=counts)
        _usage_checks(torch, srv, "served")
        if device == "cuda":
            refresh_probe(torch, srv.tindex.nt, gpu)
            _usage_checks(torch, srv, "served after the refresh probe")
        # The window's table snapshot (three clones under the table lock).
        nt = srv.tindex.nt
        clone_ms = time_ms(torch, nt.device_snapshot, 200)
        # Usage is cloned per snapshot; capacity and score_cap are shared
        # between snapshots until their rows change.
        clone_bytes = nbytes(nt.device_arrays()["usage"])
    finally:
        srv.shutdown()
    for label, res in results.items():
        st = res["stats"]
        lat_ms = np.asarray(res["lats"]) * 1e3
        n = N_SERVED_EVALS
        timers = {k: round(v / n, 4) for k, v in st.items()
                  if k.startswith("t_") and v}
        per_window = {k: round(st[k] / st["windows"], 4)
                      for k in ("t_refresh_ms", "t_drain_stack_ms",
                                "t_drain_fetch_ms")}
        print(f"phase served ({label} storm) on {gpu}: {n} evals, "
              f"{res['placed']} placements in {res['wall']:.3f} s: "
              f"{n / res['wall']:.1f} evals/s, "
              f"{res['placed'] / res['wall']:.1f} placements/s; eval latency "
              f"p50 {np.percentile(lat_ms, 50):.1f} ms, p99 "
              f"{np.percentile(lat_ms, 99):.1f} ms; windows {st['windows']}, "
              f"multi {st['multi']}, fast {st['fast']}, slow {st['slow']}, "
              f"fallback {st['fallback']}, rebases {st['rebases']}; stage ms "
              f"per eval {json.dumps(timers)}; host ms per window "
              f"{json.dumps(per_window)}; launches {res['launches']}"
              + (f"; traced copies and runtime calls a storm "
                 f"{json.dumps(res['counts'])}" if res["counts"] else ""),
              flush=True)
    rates = sorted(N_SERVED_EVALS / results[label]["wall"]
                   for label, _ in runs)
    cache_ms = ["%.3f" % (results[label]["stats"]["t_nodecache_ms"]
                          / results[label]["stats"]["windows"])
                for label, _ in runs]
    SERVED_RATES[:] = rates
    print(f"phase served: untraced storm rates {['%.1f' % r for r in rates]}"
          f" evals/s, median {rates[(len(rates) - 1) // 2]:.1f}; the "
          f"worker's per-window node cache (t_nodecache_ms / windows) over "
          f"{len(nodes)} nodes {cache_ms} ms of host time", flush=True)
    traced = results["traced"]
    busy = sum(traced["device_ms"].values())
    top = sorted(traced["device_ms"].items(), key=lambda kv: -kv[1])[:10]
    if busy > 0:
        k4a = sum(v for k, v in traced["device_ms"].items()
                  if "k4a_chain" in k)
        wall_ms = traced["wall"] * 1e3
        print(f"phase served (traced storm) on {gpu}: device busy "
              f"{busy:.3f} ms of {wall_ms:.1f} ms wall, idle share "
              f"{1 - busy / wall_ms:.4f}; K4a {k4a:.3f} ms = "
              f"{k4a / wall_ms:.4f} of wall, {k4a / busy:.4f} of device "
              f"busy; device ms by entry: "
              + "; ".join(f"{k[:60]}={v:.3f}" for k, v in top), flush=True)
    else:
        print("phase served (traced storm): device busy share not measured: "
              "the trace held no device time", flush=True)
    print(f"phase served: window table snapshot (the usage clone, "
          f"{clone_bytes} bytes) {clone_ms:.4f} ms on {gpu}", flush=True)
    for label, res in results.items():
        st = res["stats"]
        # The worker reroutes an eval whose window launch or fast dispatch
        # raised to the per-eval path and carries on: every eval must have
        # gone through a fused window instead, each window one chain
        # launch. (A storm may open with a lone-eval window: the worker
        # lingers FILL_TIMEOUT = 2 ms for a second eval, and a window of
        # one is dispatched alone, not fused; `multi` counts fused ones.)
        check(st["fast"] == N_SERVED_EVALS and st["slow"] == 0
              and st["fallback"] == 0
              and res["launches"]["placement_chain"] == st["windows"]
              and st["multi"] >= st["windows"] - 1,
              f"served {label}: not every eval went through a fused window: "
              f"fast {st['fast']}, slow {st['slow']}, fallback "
              f"{st['fallback']}, multi {st['multi']}, windows "
              f"{st['windows']}, chain launches "
              f"{res['launches']['placement_chain']}")
        for k in SERVED_KERNELS:
            check(res["launches"][k] > 0,
                  f"served {label}: kernel {k} never launched")
        check(not any(res["plain_calls"].values()),
              f"served {label}: plain versions ran: {res['plain_calls']}")
    return results["untraced 1"]["launches"]


# ------------------------------------------------------------ system, placer

SYSTEM_EVALS = 23       # bench.py C4_EVALS: one storm of config 4
QUALITY_NODES = 1000    # bench.py PARITY_NODES
QUALITY_EVALS = 40      # bench.py PARITY_EVALS
PLACER_EVALS = 600      # bench.py's n_evals: N_PLACEMENTS // PER_EVAL
PLACER_IDENTITY_EVALS = 64  # kernels against plain versions, 2 windows
PLACER_IDENTITY_WINDOW = 32


def build_system_job():
    """BASELINE config 4's job (bench.py build_system_job): one alloc per
    eligible node, CPU 20, MemoryMB 16, DiskMB 150, no networks, the full
    feasibility chain (driver and implicit constraints)."""
    from nomad_tpu_torch import mock

    job = mock.system_job()
    task = job.TaskGroups[0].Tasks[0]
    task.Resources.CPU = 20
    task.Resources.MemoryMB = 16
    task.Resources.DiskMB = 150
    task.Resources.Networks = []
    task.Services = []
    if task.LogConfig is not None:
        task.LogConfig.MaxFiles = 1
        task.LogConfig.MaxFileSizeMB = 1
    return job


def _watch_refresh(nt):
    """Record every dirty-row refresh chunk of `nt` as (rows of its bucket,
    host ms of the pack and the launch) in the returned list."""
    calls = []
    refresh = nt._refresh

    def watched(d, chunk, size):
        t0 = time.perf_counter()
        refresh(d, chunk, size)
        calls.append((size, (time.perf_counter() - t0) * 1e3))

    nt._refresh = watched
    return calls


def _count_nacks(srv):
    """Count the broker's nacks in the returned one-item list."""
    nacks = [0]
    nack = srv.eval_broker.nack

    def counted(eval_id, token):
        nacks[0] += 1
        return nack(eval_id, token)

    srv.eval_broker.nack = counted
    return nacks


def run_system(torch, nodes, sys_jobs, svc_jobs, plain_window: bool,
               device, newcomer=None):
    """One dev server with one live pipelined worker: a warm-up system job,
    then a storm of the other system jobs (timed, through the live worker);
    then, with the live worker paused, one service window of `svc_jobs`
    driven by hand as the worker's own stages run it (inside
    native.plain_versions() when plain_window): its table snapshot pays the
    refresh of the rows the storm's last commit dirtied. Then, given a
    newcomer, the node registers and the live worker places every system
    job on it."""
    from nomad_tpu_torch import native
    from nomad_tpu_torch.server.pipelined_worker import PipelinedWorker
    from nomad_tpu_torch.server.worker import DEQUEUE_TIMEOUT

    srv = _new_server(torch, nodes, num_schedulers=1, device=device)
    out = {}
    try:
        worker = srv.workers[0]
        nt = srv.tindex.nt
        nacks = _count_nacks(srv)
        nt.warm_device()
        jobs = iter(sys_jobs)
        run = _storm_runner(srv, lambda: next(jobs).copy())
        run(1)
        check(worker.quiesce(60), "system: warm-up never quiesced")
        refreshes = _watch_refresh(nt)
        worker.reset_stats()
        gc.collect()
        native.reset_counts()
        lats = []
        t0 = time.monotonic()
        run(len(sys_jobs) - 1, latencies=lats)
        wall = time.monotonic() - t0
        check(worker.quiesce(60), "system: the storm never quiesced")
        _sync(torch, device)
        with nt._lock:
            dirty = len(nt._dirty_rows | nt._usage_dirty)
        out["storm"] = dict(
            wall=wall, lats=lats, launches=dict(native.LAUNCHES),
            plain_calls=dict(native.PLAIN_CALLS),
            refreshes=list(refreshes), stats=dict(worker.stats),
            dirty_after=dirty,
            failed=[e.ID for e in srv.state.evals()
                    if e.Status != "complete"])

        worker.set_pause(True)
        time.sleep(DEQUEUE_TIMEOUT + 0.2)   # a parked dequeue returns
        w = PipelinedWorker(srv.raft, srv.eval_broker, srv.plan_queue,
                            srv.blocked_evals, srv.tindex,
                            ["service", "batch", "system"],
                            window=len(svc_jobs))
        del refreshes[:]
        native.reset_counts()
        plain_ctx = (native.plain_versions() if plain_window
                     else contextlib.nullcontext())
        with plain_ctx:
            for j in svc_jobs:
                srv.job_register(j.copy())
            batch = w._dequeue_window()
            check(len(batch) == len(svc_jobs),
                  f"system: service window of {len(batch)} evals, want "
                  f"{len(svc_jobs)}")
            batch.sort(key=lambda pair: pair[0].JobID)
            work = w._dispatch_window(batch)
            check(work is not None and len(work.fast) == len(svc_jobs),
                  "system: not every service eval took the fast path")
            work.packed = w._drain_window(work)
            w._finish_fast(work)
            w._arbiter.mark_settled(work.chain_seq)
            w._arbiter.finish_window()
            _sync(torch, device)
            launches = dict(native.LAUNCHES)
            plain_calls = dict(native.PLAIN_CALLS)
            usage = _usage_checks(torch, srv, "system: after the window")
        svc_ids = {j.ID for j in svc_jobs}
        out["window"] = dict(
            stats=dict(w.stats), launches=launches, plain_calls=plain_calls,
            refreshes=list(refreshes), usage=usage,
            live={(a.JobID, a.Name): a.NodeID for a in srv.state.allocs()
                  if a.JobID in svc_ids and not a.terminal_status()})

        ready = {n.ID for n in srv.state.nodes() if n.Status == "ready"}
        per_job = {}
        for j in sys_jobs:
            held = [a.NodeID for a in srv.state.allocs_by_job(j.ID)
                    if not a.terminal_status()]
            per_job[j.ID] = (len(held), set(held) == ready)
        out["per_job"] = per_job
        out["ready"] = len(ready)

        if newcomer is not None:
            worker.set_pause(False)
            t0 = time.monotonic()
            srv.node_register(newcomer.copy())
            deadline = time.monotonic() + 300
            while time.monotonic() < deadline:
                evs = [e for e in srv.state.evals()
                       if e.NodeID == newcomer.ID]
                if (len(evs) == len(sys_jobs)
                        and all(e.Status == "complete" for e in evs)):
                    break
                time.sleep(0.02)
            out["newcomer"] = dict(
                wall=time.monotonic() - t0,
                evals=[e.Status for e in srv.state.evals()
                       if e.NodeID == newcomer.ID],
                placed=sorted(a.JobID for a in
                              srv.state.allocs_by_node(newcomer.ID)
                              if not a.terminal_status()))
            check(worker.quiesce(60), "system: newcomer never quiesced")
            _usage_checks(torch, srv, "system: after the newcomer")
        out["nacks"] = nacks[0]
    finally:
        srv.shutdown()
    return out


def system_phase(torch, gpu: str, device="cuda"):
    """BASELINE config 4 on the port's dev server. Returns the storm's
    launches per kernel (the system path's)."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.scheduler import stack as stack_mod
    from nomad_tpu_torch.structs import compute_node_class
    from nomad_tpu_torch.tensor.node_table import _REFRESH_CHUNKS

    nodes = build_nodes()
    sys_jobs = [build_system_job() for _ in range(SYSTEM_EVALS + 1)]
    svc_jobs = [make_job() for _ in range(WINDOW)]
    newcomer = mock.node()
    newcomer.Meta["rack"] = "r0"
    compute_node_class(newcomer)
    noise_fn = stack_mod.make_noise_vec
    stack_mod.make_noise_vec = _fixed_noise
    try:
        kern = run_system(torch, nodes, sys_jobs, svc_jobs, False, device,
                          newcomer)
        plain = run_system(torch, nodes, sys_jobs, svc_jobs, True, device)
    finally:
        stack_mod.make_noise_vec = noise_fn
    storm, win = kern["storm"], kern["window"]
    n = SYSTEM_EVALS
    lat_ms = np.asarray(storm["lats"]) * 1e3
    placed = n * kern["ready"]
    sizes = sorted({size for size, _ in storm["refreshes"]})
    big = _REFRESH_CHUNKS[-1]
    st = win["stats"]
    same = kern["window"]["live"] == plain["window"]["live"]
    print(f"phase system on {gpu}: {n} system evals on {kern['ready']} "
          f"ready nodes in {storm['wall']:.3f} s: {n / storm['wall']:.2f} "
          f"evals/s, {placed / storm['wall']:.1f} placements/s; eval "
          f"latency p50 {np.percentile(lat_ms, 50):.1f} ms, p99 "
          f"{np.percentile(lat_ms, 99):.1f} ms; K4b launches "
          f"{storm['launches']['scatter_refresh']} at chunk sizes "
          f"{[size for size, _ in storm['refreshes']]}, host ms each "
          f"{[round(ms, 4) for _, ms in storm['refreshes']]}; "
          f"{storm['dirty_after']} rows dirty after the storm; worker "
          f"windows {storm['stats']['windows']}, slow "
          f"{storm['stats']['slow']}; nacks {kern['nacks']}", flush=True)
    print(f"phase system: the next {WINDOW}-eval service window: "
          f"t_refresh_ms {st['t_refresh_ms']:.4f} (K4b chunks and host ms "
          f"{[(size, round(ms, 4)) for size, ms in win['refreshes']]}), "
          f"t_dispatch_ms {st['t_dispatch_ms']:.4f}; launches "
          f"{win['launches']}; kernel and plain runs "
          f"{'identical' if same else 'DIFFERENT'}", flush=True)
    nc = kern["newcomer"]
    print(f"phase system: a node registers: {len(nc['evals'])} system "
          f"evals, {len(nc['placed'])} allocs on it in {nc['wall']:.3f} s",
          flush=True)
    for run, name in ((kern, "kernel"), (plain, "plain")):
        check(not run["storm"]["failed"] and run["nacks"] == 0,
              f"system {name} run: evals not complete "
              f"{run['storm']['failed'][:5]}, nacks {run['nacks']}")
        check(all(cnt == run["ready"] and every
                  for cnt, every in run["per_job"].values()),
              f"system {name} run: a system job is not on exactly every "
              f"ready node: {list(run['per_job'].values())[:5]}")
        check(len(run["window"]["live"]) == WINDOW * PER_EVAL,
              f"system {name} run: {len(run['window']['live'])} service "
              f"placements, want {WINDOW * PER_EVAL}")
    check(kern["ready"] == len(nodes), f"system: {kern['ready']} ready nodes")
    check(storm["launches"]["scatter_refresh"] == len(storm["refreshes"])
          and big in sizes,
          f"system: K4b launches {storm['launches']['scatter_refresh']} at "
          f"chunk sizes {sizes}: none at the {big}-row bucket")
    check(not any(storm["plain_calls"].values())
          and not any(win["plain_calls"].values()),
          f"system kernel run: plain versions ran: {storm['plain_calls']}, "
          f"{win['plain_calls']}")
    check(not any(plain["window"]["launches"].values()),
          f"system plain run: kernels launched in the window: "
          f"{plain['window']['launches']}")
    for k in SERVED_KERNELS:
        check(win["launches"][k] > 0,
              f"system: the service window never launched {k}")
    check(same, "system: the service window placed differently through the "
          "kernels and the plain versions")
    check(np.array_equal(kern["window"]["usage"], plain["window"]["usage"]),
          "system: usage differs between the kernel and plain runs")
    check(len(nc["evals"]) == len(sys_jobs)
          and set(nc["evals"]) == {"complete"}
          and nc["placed"] == sorted(j.ID for j in sys_jobs),
          f"system: the newcomer's evals {nc['evals']}, allocs on it "
          f"{len(nc['placed'])}, want one per system job")
    return storm["launches"]


def run_placer(torch, tindex, nodes, job_fn, n_evals, seed, window,
               plain=False):
    """bench_placer's loop on the port: build each job and submit it to a
    PipelinedPlacer (K4a once an eval, usage chained on the card), then
    flush. Returns (placer, results, seconds)."""
    from nomad_tpu_torch import native
    from nomad_tpu_torch.scheduler.pipeline import EvalRequest, PipelinedPlacer

    ctx = native.plain_versions() if plain else contextlib.nullcontext()
    with ctx:
        placer = PipelinedPlacer(tindex, nodes, rng=random.Random(seed),
                                 window=window)
        t0 = time.perf_counter()
        for _ in range(n_evals):
            job = job_fn()
            placer.submit(EvalRequest(job=job,
                                      tgs=[job.TaskGroups[0]] * PER_EVAL))
        results = placer.flush()
        wall = time.perf_counter() - t0
    return placer, results, wall


def quality_gate(torch, gpu: str, device="cuda"):
    """bench.py bench_placement_parity on the port: the same storm served
    through the device engine (the pipelined worker) and the cpu-reference
    engine (the per-eval worker); the committed placements' mean bin-pack
    score of the device engine must be no lower than the cpu-reference's,
    within the reference's tolerance (2e-3: the noise adds <= 1e-3)."""
    from nomad_tpu_torch.server import Server, ServerConfig

    out = {}
    for impl in ("device", "cpu-reference"):
        nodes = build_nodes(QUALITY_NODES)
        srv = Server(ServerConfig(num_schedulers=1,
                                  pipelined_scheduling=impl == "device",
                                  scheduler_impl=impl, device=device,
                                  **PARKED))
        srv.establish_leadership()
        try:
            for node in nodes:
                srv.node_register(node)
            t0 = time.monotonic()
            eval_ids = _storm_runner(srv)(QUALITY_EVALS)
            wall = time.monotonic() - t0
            allocs = [a for eid in eval_ids
                      for a in srv.state.allocs_by_eval(eid)]
            scores = [float(a.Metrics.Scores[f"{a.NodeID}.binpack"])
                      for a in allocs if a.Metrics is not None
                      and f"{a.NodeID}.binpack" in a.Metrics.Scores]
            out[impl] = dict(placed=len(allocs), scored=len(scores),
                             mean=float(np.mean(scores)) if scores else None,
                             evals_s=QUALITY_EVALS / wall)
        finally:
            srv.shutdown()
    dev, cpu = out["device"], out["cpu-reference"]
    want = QUALITY_EVALS * PER_EVAL
    delta = (dev["mean"] - cpu["mean"]
             if dev["mean"] is not None and cpu["mean"] is not None
             else None)
    print(f"phase placer quality on {gpu}: {QUALITY_NODES} nodes, "
          f"{QUALITY_EVALS} evals: device engine {json.dumps(dev)}, "
          f"cpu-reference engine {json.dumps(cpu)}, mean score delta "
          f"{delta}", flush=True)
    check(dev["placed"] == cpu["placed"] == want
          and dev["scored"] == cpu["scored"] == want,
          f"placer quality: placed {dev['placed']} / {cpu['placed']}, "
          f"scored {dev['scored']} / {cpu['scored']}, want {want}")
    check(delta is not None and delta >= -2e-3,
          f"placer quality: the device engine's mean score is lower than "
          f"the cpu-reference's by {delta}")


def placer_phase(torch, gpu: str, device="cuda"):
    """bench_placer's shape on the port's PipelinedPlacer, its kernel
    against its plain version, and the placement-quality gate. Returns the
    timed run's launches per kernel (the placer path's)."""
    from nomad_tpu_torch import native
    from nomad_tpu_torch.tensor import TensorIndex

    nodes = build_nodes()
    tindex = TensorIndex(device=device)
    for node in nodes:
        tindex.nt.upsert_node(node)
    window = min(max(PLACER_EVALS, 1), 128)
    run_placer(torch, tindex, nodes, make_job, window + 1, 1, window)
    _sync(torch, device)
    gc.collect()
    native.reset_counts()
    _, results, wall = run_placer(torch, tindex, nodes, make_job,
                                  PLACER_EVALS, 42, window)
    launches = dict(native.LAUNCHES)
    plain_calls = dict(native.PLAIN_CALLS)
    placed = sum(int((r.chosen_rows >= 0).sum()) for r in results)
    # Synchronous single-eval latency: submit and flush one eval at a time
    # on one placer (bench_placer's p50 figure).
    from nomad_tpu_torch.scheduler.pipeline import EvalRequest, PipelinedPlacer

    lat_placer = PipelinedPlacer(tindex, nodes, rng=random.Random(7))
    lats = []
    for _ in range(5):
        job = make_job()
        t0 = time.perf_counter()
        lat_placer.submit(EvalRequest(job=job,
                                      tgs=[job.TaskGroups[0]] * PER_EVAL))
        lat_placer.flush()
        lats.append(time.perf_counter() - t0)
    print(f"phase placer on {gpu}: {PLACER_EVALS} evals x {PER_EVAL} on "
          f"{len(nodes)} nodes, window {window}: {placed} placed in "
          f"{wall:.3f} s: {PLACER_EVALS / wall:.1f} evals/s, "
          f"{placed / wall:.1f} placements/s; single-eval p50 "
          f"{np.percentile(lats, 50) * 1e3:.3f} ms; launches {launches}",
          flush=True)
    check(len(results) == PLACER_EVALS
          and placed == PLACER_EVALS * PER_EVAL,
          f"placer: {len(results)} results, {placed} placed")
    check(launches["placement_chain"] == PLACER_EVALS
          and not any(plain_calls.values()),
          f"placer: K4a launches {launches['placement_chain']} for "
          f"{PLACER_EVALS} evals; plain calls {plain_calls}")

    # Kernels against plain versions: the same jobs, seed and table.
    jobs = [make_job() for _ in range(PLACER_IDENTITY_EVALS)]
    runs = {}
    for plain in (False, True):
        it = iter(jobs)
        runs[plain] = run_placer(
            torch, tindex, nodes, lambda: next(it), len(jobs), 42,
            PLACER_IDENTITY_WINDOW, plain=plain)
    usage = {}
    for plain in (False, True):
        runs[plain][0].sync_usage_to_host()
        usage[plain] = tindex.nt.usage.copy()
    dev_usage = tindex.nt.device_arrays()["usage"].cpu().numpy()
    kern, ref = runs[False][1], runs[True][1]
    same = (len(kern) == len(ref) == len(jobs) and all(
        np.array_equal(k.chosen_rows, r.chosen_rows)
        and np.array_equal(k.n_feasible, r.n_feasible)
        and np.array_equal(k.scores.view(np.uint32),
                           r.scores.view(np.uint32))
        for k, r in zip(kern, ref)))
    print(f"phase placer identity on {gpu}: {len(jobs)} evals in windows "
          f"of {PLACER_IDENTITY_WINDOW}: kernel and plain chains "
          f"{'identical' if same else 'DIFFERENT'} (rows, n_feasible, score "
          f"bits); wall kernel/plain {runs[False][2]:.3f}/"
          f"{runs[True][2]:.3f} s", flush=True)
    check(same, "placer: the kernel's chain differs from the plain version")
    check(np.array_equal(usage[False], usage[True]),
          "placer: chained usage differs between kernel and plain runs")
    check(np.array_equal(dev_usage, tindex.nt.usage),
          "placer: device usage differs from the host mirror after sync")
    quality_gate(torch, gpu, device)
    return launches


# ---------------------------------------------------------------- agent

AGENT_JOBS = 600        # the HTTP storm: config 3's 600 jobs of Count 50
AGENT_WARMUP = (3, 3, 64)   # HTTP warm-up storms before the timed one
# Exit codes of the CLI lifecycle: `plan` exits 1 when the job would change
# the cluster, as `nomad plan` does.
CLI_CODES = (("init", 0), ("validate", 0), ("plan", 1), ("run", 0),
             ("status", 0), ("alloc-status", 0), ("stop", 0))
SERVED_RATES = []       # the served phase's untraced storm rates, if it ran
NO_METADATA = {"fingerprint.env_aws.url": "http://127.0.0.1:1/",
               "fingerprint.env_gce.url": "http://127.0.0.1:1/"}


def _pctl(values, q):
    return float(np.percentile(np.asarray(values) * 1e3, q))


def _http_storm(api, count):
    """Register `count` jobs through the HTTP API (PUT /v1/jobs, one at a
    time) and poll GET /v1/evaluations until every eval is complete. Returns
    the eval ids, each register's round trip and each eval's latency from
    its register call to the poll that saw it complete, and the wall."""
    t_submit, rtts = {}, []
    t0 = time.monotonic()
    for _ in range(count):
        job = make_job()
        t = time.monotonic()
        eid, _ = api.jobs.register(job)
        rtts.append(time.monotonic() - t)
        t_submit[eid] = t
    pending, lats = set(t_submit), []
    deadline = time.monotonic() + 300
    while pending and time.monotonic() < deadline:
        evals, _ = api.evaluations.list()
        now = time.monotonic()
        done = {e["ID"] for e in evals
                if e["ID"] in pending and e["Status"] == "complete"}
        lats.extend(now - t_submit[eid] for eid in done)
        pending -= done
        if pending:
            time.sleep(0.05)
    wall = time.monotonic() - t0
    check(not pending, f"agent: {len(pending)} of {count} evals never "
          f"completed through HTTP")
    return list(t_submit), rtts, lats, wall


def _quiesce(srv, what):
    for w in srv.workers:
        check(w.quiesce(60), f"{what}: a worker never quiesced")


def _placed(srv, eval_ids):
    return [a for eid in eval_ids for a in srv.state.allocs_by_eval(eid)]


def _cli_lifecycle(agent, api, addr, workdir):
    """init, validate, plan, run, status, alloc-status and stop of
    `example.nomad` (raw_exec /bin/sleep) through the CLI's own entry point
    in this process; the alloc must reach `running` on the agent's node."""
    import io

    from nomad_tpu_torch.cli import main as cli_main

    node_id = agent.client.node.ID
    here = os.getcwd()
    os.chdir(workdir)
    codes, out = {}, io.StringIO()
    try:
        def cli(name, *argv, address=True):
            with contextlib.redirect_stdout(out):
                codes[name] = cli_main([name] + (["-address", addr]
                                                 if address else [])
                                       + list(argv))
        cli("init", address=False)
        cli("validate", "example.nomad", address=False)
        cli("plan", "example.nomad")
        cli("run", "example.nomad")
        allocs, _ = api.jobs.allocations("example")
        check(len(allocs) == 1, f"agent cli: {len(allocs)} allocs of "
              f"example, want 1")
        alloc_id = allocs[0]["ID"]
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            alloc, _ = api.allocations.info(alloc_id)
            if alloc["ClientStatus"] == "running":
                break
            time.sleep(0.1)
        cli("status")
        cli("alloc-status", alloc_id)
        cli("stop", "example")
    finally:
        os.chdir(here)
    lines = out.getvalue().splitlines()
    print(f"phase agent cli: exit codes {codes}; example's alloc "
          f"{alloc_id[:8]} {alloc['ClientStatus']} on node "
          f"{alloc['NodeID'][:8]} (the agent's node {node_id[:8]}); "
          + " | ".join(ln.strip() for ln in lines
                       if ln.startswith(("==>", "Job validation",
                                         "- All tasks", "Example job",
                                         "Client Status")))[:900],
          flush=True)
    check(codes == dict(CLI_CODES), f"agent cli: exit codes {codes}, want "
          f"{dict(CLI_CODES)}")
    check(alloc["ClientStatus"] == "running" and alloc["NodeID"] == node_id,
          f"agent cli: example's alloc is {alloc['ClientStatus']} on "
          f"{alloc['NodeID']}, want running on the agent's node {node_id}")


def _plan_response(resp):
    """A plan response as plain data, with what differs between any two
    plans masked: the created evals (random ids, kept as their number),
    and in a failed group's metric its host timer and the values of its
    node scores (they carry tie-break jitter drawn afresh for every plan;
    the scored nodes stay)."""
    from nomad_tpu_torch.structs import to_dict

    out = to_dict(resp)
    out["CreatedEvals"] = len(out["CreatedEvals"] or [])
    for metric in (out["FailedTGAllocs"] or {}).values():
        metric["AllocationTime"] = 0
        metric["Scores"] = sorted(metric["Scores"])
    return out


def _timed_plan(torch, api, job, device):
    """One `nomad plan` over HTTP with the scratch Harness's steps timed on
    the host: the request, its decode and the scratch store and table build,
    the table's upload (a sync after it) and the scheduler's run (a sync
    after it). The plan's one keyed placement (K2 -> K3 -> K4a) is kept
    with its inputs, so its device-only time can be taken last in the
    process. Returns the response, the times and the replay."""
    from nomad_tpu_torch.scheduler import kernels, testing

    marks, process = {}, testing.Harness.process
    keyed, calls = kernels.place_batch_keyed, []

    def timed_process(self, name, ev):
        marks["built"] = time.perf_counter()
        marks["rows"] = self.tindex.nt.n_rows
        self.tindex.nt.device_arrays()
        _sync(torch, device)
        marks["uploaded"] = time.perf_counter()
        process(self, name, ev)
        _sync(torch, device)
        marks["done"] = time.perf_counter()

    def kept_keyed(*args, **kwargs):
        calls.append((args, kwargs))
        return keyed(*args, **kwargs)

    testing.Harness.process = timed_process
    kernels.place_batch_keyed = kept_keyed
    try:
        t0 = time.perf_counter()
        resp, _ = api.jobs.plan(job)
        wall = time.perf_counter() - t0
    finally:
        testing.Harness.process = process
        kernels.place_batch_keyed = keyed
    check(len(calls) == 1, f"agent plan: {len(calls)} keyed placements, "
          f"want 1")
    args, kwargs = calls[0]
    times = dict(
        wall_ms=round(wall * 1e3, 3),
        build_ms=round((marks["built"] - t0) * 1e3, 3),
        upload_ms=round((marks["uploaded"] - marks["built"]) * 1e3, 3),
        schedule_ms=round((marks["done"] - marks["uploaded"]) * 1e3, 3),
        rows=marks["rows"])
    return resp, times, lambda: keyed(*args, **kwargs)


def agent_phase(torch, gpu: str, device="cuda", n_nodes=None):
    """The dev agent end to end: server, RPC endpoints, client runtime and
    HTTP API in one process; config 3's fleet registered through the RPC
    dispatch; the CLI lifecycle of example.nomad; a 600-job HTTP storm and
    the same storm registered in process; `nomad plan` on the loaded fleet
    through the kernels and through the plain versions. Returns the HTTP
    storm's launches per kernel."""
    import shutil
    import tempfile

    from nomad_tpu_torch import native
    from nomad_tpu_torch.agent import Agent, AgentConfig
    from nomad_tpu_torch.api import Client
    from nomad_tpu_torch.structs import to_dict

    workdir = tempfile.mkdtemp(prefix="agent_phase_")
    cfg = AgentConfig.dev()
    cfg.http_port = 0
    cfg.device = device
    cfg.data_dir = os.path.join(workdir, "data")
    # The client's cloud fingerprints ask a metadata service at a
    # link-local address; point them at a closed port on this host.
    cfg.options.update(NO_METADATA)
    agent = Agent(cfg)
    try:
        agent.start()
        srv = agent.server
        # 10,000 nodes that never heartbeat: park their TTLs first.
        srv.heartbeats.min_ttl = PARKED["min_heartbeat_ttl"]
        srv.heartbeats.grace = PARKED["heartbeat_grace"]
        addr = f"http://{cfg.bind_addr}:{agent.http.port}"
        api = Client(address=addr)
        nodes = build_nodes(n_nodes)
        elections = [0]     # registers retried on another leader
        t0 = time.monotonic()
        for node in nodes:
            agent.rpc("Node.Register", {"Node": to_dict(node)})
        srv.tindex.nt.device_arrays()
        _sync(torch, device)
        print(f"phase agent on {gpu}: {len(nodes)} nodes registered through "
              f"the RPC dispatch in {time.monotonic() - t0:.1f} s; table rows "
              f"{srv.tindex.nt.n_rows} on {srv.tindex.nt.device}; HTTP at "
              f"{addr}", flush=True)
        check(srv.tindex.nt.device.type == device,
              f"agent: the server's table is on {srv.tindex.nt.device}")

        _cli_lifecycle(agent, api, addr, workdir)

        for count in AGENT_WARMUP[:2]:
            _http_storm(api, count)
        srv.tindex.nt.warm_device()
        _http_storm(api, AGENT_WARMUP[2])
        _quiesce(srv, "agent warm-up")

        storms = {}

        def storm(label):
            for w in srv.workers:
                w.reset_stats()
            gc.collect()
            native.reset_counts()
            _sync(torch, device)
            if label == "http":
                eval_ids, rtts, lats, wall = _http_storm(api, AGENT_JOBS)
                stats = api.agent.sched_stats()
            else:
                lats, rtts = [], []
                t0 = time.monotonic()
                eval_ids = _storm_runner(srv)(AGENT_JOBS, latencies=lats)
                _sync(torch, device)
                wall = time.monotonic() - t0
                stats = None
            _quiesce(srv, f"agent {label} storm")
            storms[label] = dict(
                eval_ids=eval_ids, rtts=rtts, lats=lats, wall=wall,
                stats=stats, launches=dict(native.LAUNCHES),
                plain_calls=dict(native.PLAIN_CALLS),
                placed=_placed(srv, eval_ids))

        storm("http")
        usage = _usage_checks(torch, srv, "agent")

        # `nomad plan` of one more config-3 job on the fleet the HTTP storm
        # loaded, through the kernels (its scratch table's steps timed) and
        # through the plain versions.
        job = make_job()
        plans, plan_launches = {}, {}
        for plain in (False, True):
            native.reset_counts()
            t0 = time.perf_counter()
            if plain:
                with native.plain_versions():
                    resp, _ = api.jobs.plan(job)
            else:
                resp, timed, replay = _timed_plan(torch, api, job, device)
            plans[plain] = (_plan_response(resp), time.perf_counter() - t0)
            plan_launches[plain] = (dict(native.LAUNCHES),
                                    dict(native.PLAIN_CALLS))
        same = plans[False][0] == plans[True][0]
        failed = plans[False][0]["FailedTGAllocs"]
        desired = plans[False][0]["Annotations"]["DesiredTGUpdates"]
        print(f"phase agent plan on {gpu}: one job (Count {PER_EVAL}) on "
              f"{len(nodes)} nodes and {len(srv.state.allocs())} allocs: "
              f"kernel and plain responses "
              f"{'identical' if same else 'DIFFERENT'} (diff, annotations "
              f"{desired}, FailedTGAllocs {failed}); HTTP ms kernels/plain "
              f"{plans[False][1] * 1e3:.1f}/{plans[True][1] * 1e3:.1f}; "
              f"launches {plan_launches[False][0]}; the kernel plan's host "
              f"steps {json.dumps(timed)}", flush=True)
        if device == "cuda":
            DEVICE_ONLY.append((
                f"plan's keyed placement (K2 -> K3 -> K4a) at "
                f"{timed['rows']} rows", time_ms(torch, replay, 50), replay,
                50))
        _quiesce(srv, "agent plan")
        check(np.array_equal(usage, srv.tindex.nt.usage),
              "agent: a plan changed the live table's usage")

        storm("in-process")
        _usage_checks(torch, srv, "agent after the in-process storm")
        node_id = agent.client.node.ID
        for label, st in storms.items():
            n = AGENT_JOBS
            placed = len(st["placed"])
            line = (f"phase agent ({label} storm) on {gpu}: {n} evals, "
                    f"{placed} placements in {st['wall']:.3f} s: "
                    f"{n / st['wall']:.1f} evals/s, "
                    f"{placed / st['wall']:.1f} placements/s; eval latency "
                    f"p50 {_pctl(st['lats'], 50):.1f} ms, p99 "
                    f"{_pctl(st['lats'], 99):.1f} ms")
            if st["rtts"]:
                line += (f"; register round trip p50 "
                         f"{_pctl(st['rtts'], 50):.3f} ms, p99 "
                         f"{_pctl(st['rtts'], 99):.3f} ms")
            print(line + f"; launches {st['launches']}", flush=True)
        totals = storms["http"]["stats"]["Totals"]
        timers = {k: round(v / AGENT_JOBS, 4) for k, v in totals.items()
                  if k.startswith("t_") and isinstance(v, (int, float))
                  and v}
        flows = {k: totals.get(k) for k in ("windows", "multi", "fast",
                                            "slow", "fallback", "rebases")}
        print(f"phase agent (http storm) on {gpu}: "
              f"/v1/agent/debug/sched-stats over "
              f"{len(storms['http']['stats']['Workers'])} workers: {flows}; "
              f"stage ms per eval {json.dumps(timers)}", flush=True)
        rates = {k: AGENT_JOBS / v["wall"] for k, v in storms.items()}
        print(f"phase agent on {gpu}: evals/s over HTTP {rates['http']:.1f}, "
              f"registered in process on the same agent afterwards "
              f"{rates['in-process']:.1f} (ratio "
              f"{rates['http'] / rates['in-process']:.3f}); the served "
              f"phase's untraced storms (one worker, window {WINDOW}) "
              + (f"{['%.1f' % r for r in SERVED_RATES]}" if SERVED_RATES
                 else "not run"), flush=True)
    finally:
        agent.shutdown()
        shutil.rmtree(workdir, ignore_errors=True)

    for label, st in storms.items():
        check(len(st["placed"]) == AGENT_JOBS * PER_EVAL,
              f"agent {label}: {len(st['placed'])} placements, want "
              f"{AGENT_JOBS * PER_EVAL}")
        on_agent = sum(1 for a in st["placed"] if a.NodeID == node_id)
        check(on_agent == 0, f"agent {label}: {on_agent} storm allocs on the "
              f"agent's own node")
        check(not any(st["plain_calls"].values()),
              f"agent {label}: plain versions ran: {st['plain_calls']}")
        for k in SERVED_KERNELS:
            check(st["launches"][k] > 0,
                  f"agent {label}: kernel {k} never launched")
    check(same, "agent: `nomad plan` through the kernels differs from the "
          "plain versions")
    check(not failed and desired[job.TaskGroups[0].Name]["Place"]
          == PER_EVAL, f"agent plan: {desired}, failed {failed}")
    kern, plain = plan_launches[False], plan_launches[True]
    check(all(kern[0][k] > 0 for k in STORM_KERNELS[:3])
          and not any(kern[1].values()),
          f"agent plan: kernel run launches {kern[0]}, plain calls {kern[1]}")
    check(not any(plain[0].values()) and plain[1]["placement_chain"] > 0,
          f"agent plan: plain run launches {plain[0]}, plain calls {plain[1]}")
    return storms["http"]["launches"]


# ------------------------------------------------------------- cluster

CLUSTER_JOBS = 150          # the storm's jobs of config 3 (Count 50 each);
#                             cut from 300, whose storm took 45-79 s of a
#                             phase over its 90 s on an H100 80GB HBM3 at
#                             700 W (the fleet's registers through raft
#                             took 46-89 s of the rest; PERF.md §5)
CLUSTER_KILL_AT = 100       # jobs registered before the leader is killed
CLUSTER_TIERS = (80, 20, 50)    # bench_failover_storm's priorities
CLUSTER_REGISTER_THREADS = 8      # client threads registering the fleet
CLUSTER_RAFT = dict(heartbeat_interval=0.02, election_timeout_min=0.08,
                    election_timeout_max=0.16, apply_timeout=5.0)
CLUSTER_DEADLINES_S = (10.0, 30.0, 120.0)   # QoS deadlines per tier


CLUSTER_RETRY_S = 60.0      # how long a client retries one RPC through
#                             elections (three servers in one interpreter
#                             re-elect under load: 20 ms heartbeats)


def _cluster_rpc(live, method, args, delay=0.1):
    """One RPC through a randomly chosen live server's endpoints (a
    follower forwards to the leader), retried through elections as an
    API client's retry loop does (bench.py bench_failover_storm's rpc,
    with a deadline in place of its 80 attempts)."""
    last, deadline = None, time.monotonic() + CLUSTER_RETRY_S
    while time.monotonic() < deadline:
        targets = [cs for cs in live if cs.endpoints is not None]
        random.shuffle(targets)
        for cs in targets:
            try:
                return cs.endpoints.handle(method, dict(args))
            except Exception as e:  # an election or a dead link: retry
                last = e
        time.sleep(delay)
    raise last if last is not None else RuntimeError("no live server")


def _cluster_leader(live):
    for cs in live:
        srv = cs.server
        if srv is not None and srv.is_leader() and srv._leader:
            return cs
    return None


def _wait_leader(live, timeout=30.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        leader = _cluster_leader(live)
        if leader is not None:
            return leader, time.monotonic() - t0
        time.sleep(0.005)
    check(False, f"cluster: no leader within {timeout} s")


class _PlanOnly:
    """A Planner that records the plan and commits nothing: a placement on
    a snapshot that leaves the store and the table as they are."""

    def __init__(self, index):
        self.index, self.plans = index, []

    def submit_plan(self, plan):
        from nomad_tpu_torch.structs import PlanResult

        self.plans.append(plan)
        return PlanResult(NodeUpdate=plan.NodeUpdate,
                          NodeAllocation=plan.NodeAllocation,
                          AllocIndex=self.index), None

    def update_eval(self, ev):
        pass

    def create_eval(self, ev):
        pass

    def reblock_eval(self, ev):
        pass


class _WithJob:
    """A state snapshot that also holds one unregistered job."""

    def __init__(self, snap, job):
        self._snap, self._job = snap, job

    def job_by_id(self, job_id):
        return self._job if job_id == self._job.ID else \
            self._snap.job_by_id(job_id)

    def __getattr__(self, name):
        return getattr(self._snap, name)


def _snapshot_placement(torch, srv, job, plain: bool):
    """One placement of `job` on the server's live snapshot and table, its
    plan recorded and not committed: the keyed placement's outputs (rows,
    scores, feasible counts, usage after) and the plan's node per alloc
    name, with a fixed tie-break seed."""
    from nomad_tpu_torch import native
    from nomad_tpu_torch.scheduler import GenericScheduler, kernels
    from nomad_tpu_torch.structs import Evaluation
    from nomad_tpu_torch.structs.structs import EvalTriggerJobRegister

    snap = srv.state.snapshot()
    planner = _PlanOnly(snap.latest_index() + 1)
    keyed, outs = kernels.place_batch_keyed, []

    def kept(*args, **kwargs):
        out = keyed(*args, **kwargs)
        outs.append(out)
        return out

    ev = Evaluation(ID=f"cluster-identity-{int(plain)}",
                    Priority=job.Priority, Type=job.Type,
                    TriggeredBy=EvalTriggerJobRegister, JobID=job.ID)
    kernels.place_batch_keyed = kept
    ctx = native.plain_versions() if plain else contextlib.nullcontext()
    try:
        with ctx:
            GenericScheduler(_WithJob(snap, job), planner, srv.tindex,
                             logging.getLogger("chip_smoke"),
                             batch=False, rng=random.Random(7)).process(ev)
            _sync(torch, srv.tindex.nt.device.type)
    finally:
        kernels.place_batch_keyed = keyed
    placed = sorted((a.Name, a.NodeID) for plan in planner.plans
                    for allocs in plan.NodeAllocation.values()
                    for a in allocs)
    return outs, placed


def cluster_phase(torch, gpu: str, device="cuda", n_nodes=None,
                  n_jobs=None):
    """Nomad's replicated deployment on the card: three `ClusterServer`s in
    this process (raft over loopback TCP, gossip bootstrap-expect 3, QoS
    on, each on its own raft log store and its own node table on
    `device`), config 3's fleet registered through `Node.Register`, a
    storm of config-3 jobs registered through random live servers with
    the leader killed after the 100th, then the checks. Returns the
    storm's launches per kernel (all three servers: the counters are
    process-wide)."""
    import shutil
    import tempfile

    from nomad_tpu_torch import native
    from nomad_tpu_torch.gossip import GossipConfig
    from nomad_tpu_torch.qos import QoSConfig
    from nomad_tpu_torch.raft import RaftConfig
    from nomad_tpu_torch.raft.native_log import make_log_store
    from nomad_tpu_torch.resilience import chaos
    from nomad_tpu_torch.rpc.cluster import ClusterServer
    from nomad_tpu_torch.server import ServerConfig
    from nomad_tpu_torch.structs import to_dict
    from nomad_tpu_torch.structs.structs import (EvalStatusCancelled,
                                                 EvalStatusComplete,
                                                 EvalStatusFailed)
    from nomad_tpu_torch.telemetry import metrics

    terminal = (EvalStatusComplete, EvalStatusFailed, EvalStatusCancelled)
    tier_name = {80: "high", 20: "low", 50: "normal"}
    n_jobs = CLUSTER_JOBS if n_jobs is None else n_jobs
    kill_at = min(CLUSTER_KILL_AT, 2 * n_jobs // 3)
    workdir = tempfile.mkdtemp(prefix="cluster_phase_")
    stores, snapshots, acks, servers = {}, {}, {}, []

    # The digest counters of every replica, over the whole phase.
    digest_counts = {"folds": 0, "exchanged": 0, "diverged": 0}
    incr = metrics.incr_counter

    def counting_incr(key, *args, **kwargs):
        key = tuple(key)
        if key[:3] == ("nomad", "fsm", "digest") and key[3] in digest_counts:
            digest_counts[key[3]] += 1
        return incr(key, *args, **kwargs)

    def boot(name, join=None):
        cs = ClusterServer(ServerConfig(
            node_id="", num_schedulers=1, bootstrap_expect=3,
            scheduler_window=8, device=device,
            qos=QoSConfig(enabled=True, deadlines_s=CLUSTER_DEADLINES_S),
            **PARKED))
        store = make_log_store(os.path.join(workdir, name))
        stores[name] = type(store).__name__
        snapshots[name] = 0
        for method in ("store_snapshot", "store_snapshot_chunks"):
            def persisted(*args, _fn=getattr(store, method), **kwargs):
                out = _fn(*args, **kwargs)
                snapshots[name] += 1
                return out
            setattr(store, method, persisted)
        cs.connect([], log_store=store,
                   raft_config=RaftConfig(**CLUSTER_RAFT))
        cs.start()
        acks[name] = [0]
        for w in cs.server.remote_workers:
            def acked(eval_id, token, _fn=w._send_ack, _n=acks[name]):
                _n[0] += 1
                return _fn(eval_id, token)
            w._send_ack = acked
        cs.enable_gossip(name, join=join,
                         gossip_config=GossipConfig.fast())
        cs.name = name
        servers.append(cs)
        return cs

    def gaddr(cs):
        ml = cs.membership.memberlist
        return f"{ml.addr}:{ml.port}"

    # Three servers in one interpreter share its collector: a full pass
    # over the process's heap (the earlier phases' objects, then the
    # fleet's three replicas) stopped every thread for up to 400 ms on
    # the H100's host, past the 80-160 ms election timeout, and the
    # followers re-elected through the fleet's registration (1,278
    # registers retried). So the phase freezes what exists and runs with
    # the cyclic collector off (reference counting still frees), and
    # restores both at its end. Each server of a real deployment has its
    # own process and heap.
    gc.collect()
    gc.freeze()
    gc.disable()
    gc_pauses = {}  # generation -> [count, total ms, max ms] over the phase
    gc_t0 = [0.0]

    def gc_timer(phase, info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
            return
        ms = (time.perf_counter() - gc_t0[0]) * 1e3
        rec = gc_pauses.setdefault(info["generation"], [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += ms
        rec[2] = max(rec[2], ms)

    gc.callbacks.append(gc_timer)
    metrics.incr_counter = counting_incr
    try:
        t0 = time.monotonic()
        first = boot("c0")
        boot("c1", join=[gaddr(first)])
        boot("c2", join=[gaddr(first)])
        live = list(servers)
        addrs = sorted(cs.addr for cs in live)
        deadline = time.monotonic() + 30
        while True:     # one leader with all three servers as raft peers
            leader, _ = _wait_leader(live)
            if sorted(leader.server.raft.peers) == addrs:
                break
            check(time.monotonic() < deadline,
                  "cluster: the raft configuration never held 3 servers")
            time.sleep(0.005)
        t_elect = time.monotonic() - t0
        tables = {cs.name: cs.server.tindex.nt.device for cs in servers}
        print(f"phase cluster on {gpu}: 3 servers formed by gossip "
              f"(bootstrap-expect 3), leader {leader.name} elected "
              f"{t_elect:.3f} s after the first boot; raft log stores "
              f"{stores} under {workdir} (an fsync there "
              f"{_fsync_ms(workdir):.3f} ms); node tables on {tables}",
              flush=True)
        check(all(d.type == device for d in tables.values()),
              f"cluster: a server's table is off {device}: {tables}")

        nodes = build_nodes(n_nodes)
        elections = [0]     # registers retried on another leader
        t0 = time.monotonic()

        errors = []

        def register(part):
            # A client that knows the leader sends to it (a follower would
            # forward every register over one more RPC hop), and through
            # an election it finds the new one.
            target = leader
            for node in part:
                args = {"Node": to_dict(node)}
                deadline = time.monotonic() + CLUSTER_RETRY_S
                while True:
                    try:
                        target.endpoints.handle("Node.Register", dict(args))
                        break
                    except Exception as e:  # the leader changed: find it
                        if time.monotonic() > deadline:
                            errors.append(e)
                            return
                        time.sleep(0.05)
                        target, _ = _wait_leader(live)
                        elections[0] += 1

        threads = [threading.Thread(
            target=register, name=f"cluster-register-{i}",
            args=(nodes[i::CLUSTER_REGISTER_THREADS],))
            for i in range(CLUSTER_REGISTER_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        t_register = time.monotonic() - t0
        check(not errors, f"cluster: {len(errors)} register threads failed "
              f"through {CLUSTER_RETRY_S} s of elections: {errors[:1]}")
        check(_wait_all_nodes(live, len(nodes)),
              "cluster: a replica is missing registered nodes")
        for cs in live:
            cs.server.tindex.nt.device_arrays()
        _sync(torch, device)
        print(f"phase cluster on {gpu}: {len(nodes)} nodes registered "
              f"through the leader's Node.Register from "
              f"{CLUSTER_REGISTER_THREADS} client threads in {t_register:.3f} s "
              f"({len(nodes) / t_register:.1f} registers/s; "
              f"{elections[0]} retried through a leader change; the "
              f"collector's pauses {_gc_summary(gc_pauses)}); table rows "
              f"{[cs.server.tindex.nt.n_rows for cs in live]}", flush=True)

        # The storm: jobs through random live servers, the leader killed
        # after the kill_at-th; every eval's register-to-terminal latency
        # read off whichever server leads.
        jobs, submit_t, tier_of, lat = [], {}, {}, {}
        stop = threading.Event()

        def watcher():
            while True:
                ldr = _cluster_leader(live)
                if ldr is not None:
                    now = time.monotonic()
                    for eid in [e for e in list(tier_of) if e not in lat]:
                        ev = ldr.server.state.eval_by_id(eid)
                        if ev is not None and ev.Status in terminal:
                            lat[eid] = now - submit_t[eid]
                if stop.is_set():
                    return
                time.sleep(0.01)

        native.reset_counts()
        killed_stats, t_recover, t_submitted = None, None, None
        wt = threading.Thread(target=watcher, name="cluster-watch",
                              daemon=True)
        wt.start()
        t0 = time.monotonic()
        for i in range(n_jobs):
            if i == kill_at:
                victim = _cluster_leader(live)
                check(victim is not None, "cluster: no leader to kill")
                killed_stats = (victim.name, _worker_stats(victim.server))
                live.remove(victim)
                tk = time.monotonic()
                victim.shutdown()
                _wait_leader(live)
                t_recover = time.monotonic() - tk
            job = make_job()
            job.Priority = CLUSTER_TIERS[i % len(CLUSTER_TIERS)]
            jobs.append(job)
            resp = _cluster_rpc(live, "Job.Register", {"Job": to_dict(job)})
            submit_t[resp["EvalID"]] = time.monotonic()
            tier_of[resp["EvalID"]] = job.Priority
            time.sleep(0.005)
        t_submitted = time.monotonic() - t0
        deadline = time.monotonic() + 60
        while len(lat) < len(tier_of) and time.monotonic() < deadline:
            time.sleep(0.02)
        wall = time.monotonic() - t0
        stop.set()
        wt.join(10)
        check(len(lat) == len(tier_of), f"cluster: {len(tier_of) - len(lat)} "
              f"of {len(tier_of)} evals not terminal within the deadline")
        leader, _ = _wait_leader(live)
        for w in leader.server.workers:
            check(w.quiesce(60), "cluster: the leader's worker never "
                  "quiesced")
        _sync(torch, device)
        launches, plain_calls = dict(native.LAUNCHES), \
            dict(native.PLAIN_CALLS)

        state = leader.server.state
        eval_ids = list(tier_of)
        placed = sum(1 for job in jobs for a in state.allocs_by_job(job.ID)
                     if not a.terminal_status())
        problems = chaos.check_invariants(state, jobs, PER_EVAL, eval_ids)
        by_tier = {}
        for eid, prio in tier_of.items():
            by_tier.setdefault(tier_name[prio], []).append(lat[eid])
        print(f"phase cluster on {gpu}: storm of {n_jobs} jobs (Count "
              f"{PER_EVAL}, priorities {CLUSTER_TIERS}) through random live "
              f"servers in {wall:.3f} s (the last register at "
              f"{t_submitted:.3f} s): {n_jobs / wall:.1f} evals/s, "
              f"{placed / wall:.1f} placements/s through the kill; leader "
              f"{killed_stats[0]} killed after job {kill_at}, a new leader "
              f"{leader.name} in {t_recover:.3f} s; eval latency by tier "
              + "; ".join(f"{t} p50 {_pctl(v, 50):.1f} ms p99 "
                          f"{_pctl(v, 99):.1f} ms (n={len(v)})"
                          for t, v in sorted(by_tier.items()))
              + f"; invariant violations {len(problems)}", flush=True)
        for p in problems[:10]:
            print(f"  cluster invariant: {p}", flush=True)

        # Per-server work, from the stats of every pipelined worker each
        # server ran in any term as leader.
        done = dict([killed_stats] + [(cs.name, _worker_stats(cs.server))
                                      for cs in live])
        routed = {name: n[0] for name, n in acks.items()}
        followers = [cs for cs in live if cs is not leader]
        digests = {cs.name: cs.server.fsm.digest.stats() for cs in live}
        print(f"phase cluster on {gpu}: the pipelined workers while "
              f"leading {done}; evals acked by the routed per-eval "
              f"workers {routed}; launches (all servers) {launches}; "
              f"snapshots persisted {snapshots}; digests "
              + "; ".join(f"{n}: folds {d['Folds']} exchanged "
                          f"{d['Exchanged']} diverged {d['Diverged']} "
                          f"verified to {d['VerifiedIndex']}"
                          for n, d in digests.items())
              + f"; digest counters over the phase {digest_counts}; the "
              f"collector's pauses so far (generation: count, total ms, "
              f"max ms) {_gc_summary(gc_pauses)}", flush=True)

        for cs in live:
            _usage_checks(torch, cs.server, f"cluster {cs.name}")

        # One more job placed on the new leader's snapshot and table with
        # every worker quiet, through the kernels and the plain versions.
        check(leader.server.eval_broker.stats.TotalUnacked == 0
              and leader.server.eval_broker.stats.TotalReady == 0,
              "cluster: the broker is not quiet")
        job = make_job()
        usage0 = _usage_checks(torch, leader.server, "cluster identity")
        native.reset_counts()
        k_outs, k_placed = _snapshot_placement(torch, leader.server, job,
                                               False)
        ident_launches = dict(native.LAUNCHES)
        p_outs, p_placed = _snapshot_placement(torch, leader.server, job,
                                               True)
        same = (len(k_outs) == len(p_outs) == 1 and k_placed == p_placed
                and all(_bits_equal(torch, a, b)
                        for a, b in zip(k_outs[0], p_outs[0])))
        print(f"phase cluster identity on {gpu}: one job (Count "
              f"{PER_EVAL}) on leader {leader.name}'s snapshot: "
              f"{len(k_placed)} placements, kernels and plain versions "
              f"{'identical' if same else 'DIFFERENT'} (rows, scores, "
              f"feasible counts, usage after, node per alloc); launches "
              f"{ident_launches}", flush=True)
        check(np.array_equal(usage0, leader.server.tindex.nt.usage),
              "cluster: the identity placement changed the live usage")
    finally:
        gc.callbacks.remove(gc_timer)
        gc.enable()
        gc.unfreeze()
        metrics.incr_counter = incr
        for cs in servers:
            cs.shutdown()
        _sync(torch, device)
        shutil.rmtree(workdir, ignore_errors=True)

    check(not problems, f"cluster: invariants violated: {problems[:5]}")
    check(placed == n_jobs * PER_EVAL, f"cluster: {placed} live allocs, "
          f"want {n_jobs * PER_EVAL}")
    for name, d in digests.items():
        check(d["Diverged"] == 0 and d["Synced"],
              f"cluster {name}: digest {d}")
    check(digest_counts["diverged"] == 0, f"cluster: digest counters "
          f"{digest_counts}")
    check(all(digests[cs.name]["VerifiedIndex"] > 0
              and digests[cs.name]["Exchanged"] > 0 for cs in followers),
          f"cluster: a follower verified no digest: {digests}")
    check(sum(routed.values()) > 0,
          f"cluster: no routed worker completed an eval: {routed}")
    check(not any(plain_calls.values()),
          f"cluster: plain versions ran in the storm: {plain_calls}")
    for k in SERVED_KERNELS:
        check(launches[k] > 0, f"cluster: kernel {k} never launched")
    check(len(k_placed) == PER_EVAL, f"cluster identity: {len(k_placed)} "
          f"placements, want {PER_EVAL}")
    check(same, "cluster identity: kernels and plain versions differ")
    check(all(ident_launches[k] > 0 for k in STORM_KERNELS[:3]),
          f"cluster identity: launches {ident_launches}")
    return launches


def _gc_summary(pauses) -> dict:
    return {g: [n, round(total, 1), round(top, 1)]
            for g, (n, total, top) in sorted(pauses.items())}


def _worker_stats(srv) -> dict:
    """Counters summed over every pipelined worker the server ran, in this
    and earlier terms as leader (a lost term retires its workers)."""
    keys = ("windows", "fast", "slow", "fallback", "stale", "rebases")
    out = dict.fromkeys(keys, 0)
    for w in srv.workers + srv._retired_workers:
        stats = getattr(w, "stats", {})
        for k in keys:
            out[k] += stats.get(k, 0)
    return out


def _fsync_ms(directory, n=64) -> float:
    """Median ms of a 256-byte append and fsync in `directory`, the cost
    the raft leader pays per command it appends."""
    path = os.path.join(directory, "fsync-probe")
    times = []
    with open(path, "ab") as fh:
        for _ in range(n):
            t0 = time.perf_counter()
            fh.write(b"x" * 256)
            fh.flush()
            os.fsync(fh.fileno())
            times.append(time.perf_counter() - t0)
    os.unlink(path)
    return float(np.median(times) * 1e3)


def _wait_all_nodes(live, n, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(len(cs.server.state.nodes()) == n for cs in live):
            return True
        time.sleep(0.05)
    return False


# ---------------------------------------------------------------- mesh


def _bits_equal(torch, a, b) -> bool:
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _max_err(torch, outs_a, outs_b) -> float:
    """Largest absolute difference over the finite float outputs."""
    err = 0.0
    for a, b in zip(outs_a, outs_b):
        if a.dtype == torch.float32:
            fin = torch.isfinite(a) & torch.isfinite(b)
            if fin.any():
                err = max(err, float((a[fin] - b[fin]).abs().max()))
    return err


def _fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def ring_case(torch, dev, cap, n, seed):
    """A full pending ring [cap, 6] over n rows, made from a seed: rows
    drawn from all n (repeats, so later entries must win), every shard's
    first and last rows near its end, and a fifth of the entries -1."""
    rng = np.random.default_rng(seed)
    ring = np.empty((cap, 6), np.float32)
    ring[:, 0] = rng.integers(0, n, cap)
    ring[:, 1:] = rng.uniform(0, 500, (cap, 5))
    n_loc = n // MESH_SHARDS
    edges = np.array([[q * n_loc, q * n_loc + n_loc - 1]
                      for q in range(MESH_SHARDS)]).reshape(-1)
    ring[-2 * len(edges):-len(edges), 0] = edges
    ring[rng.random(cap) < 0.2, 0] = -1.0
    return torch.tensor(ring, device=dev)


# K9's packet shapes on the card: (S, T, B, rows a shard, rows repeated
# across shards).
POOL_CASES = [(8, 3, 48, 64, False), (1, 1, 64, 256, False),
              (2, 2, 128, 512, False), (4, 1, 256, 1024, False),
              (8, 2, 1, 16, False), (4, 3, 256, 256, False),
              (2, 3, 100, 300, False), (4, 2, 96, 200, True),
              (8, 1, 2048, 2048, False), (8, 1, 2048, 131072, False),
              (2, 1, 8192, 8192, False), (2, 3, 16384, 16384, False),
              (2, 1, 32768, 65536, False)]


def pool_packets(torch, dev, s, t, b, n_loc, overlap, r=5):
    """Exchanged packets as the cold stage lays them, made from a seed: per
    shard and key a segment of B distinct rows of the shard in no row
    order (the keys of one shard share rows), each packet row's columns
    distinct. overlap=True draws every shard's rows from one range.
    Returns pool_build's arguments on dev."""
    rng = np.random.default_rng(s * 1000 + t * 100 + b)
    w = 6 + 2 * r + t
    cand = rng.uniform(0, 100, (s * t * b, w)).astype(np.float32)
    for sh in range(s):
        base = 0 if overlap else sh * n_loc
        for q in range(t):
            cand[(sh * t + q) * b:(sh * t + q + 1) * b, 0] = \
                base + rng.choice(n_loc, b, replace=False)
    cand[:, 3 + 2 * r] = rng.integers(0, 4, len(cand))
    cand[:, 4 + 2 * r] = rng.random(len(cand)) < 0.2
    cand[:, 6 + 2 * r:] = rng.random((len(cand), t)) < 0.7
    vals = -np.sort(-rng.uniform(-5, 5, (s, t, b)), axis=2).astype(np.float32)
    nf = rng.integers(0, n_loc + 1, (s, t)).astype(np.int32)
    kd = rng.uniform(5, 40, (t, r)).astype(np.float32)
    return tuple(torch.tensor(a, device=dev) for a in (cand, nf, vals, kd))


# K10's cases: (seed, pool rows C, keys T, steps P, ring rows, ring_n,
# distinct, flag). The first is the mesh-served storm's shape.
WARM_FINISH_CASES = [(101, 16384, 1, 4096, 65536, 8192, False, 0),
                     (102, 16384, 1, 4096, 65536, 65500, False, 1),
                     (103, 5003, 3, 777, 12437, -5, True, 1),
                     (104, 1, 2, 1, 1, 0, False, 0)]


def warm_finish_case(torch, dev, seed, c, t, p, ring_rows, ring_n, distinct,
                     flag, r=5):
    """warm_finish's arguments made from a seed: a pool of c rows (global
    rows ascending, as K9 lays them), t keys, p steps of which a tenth found
    no row, a full ring, the delta at ring_n. flag=0 certifies every key
    (tau below the scores); flag=1 fails the last key's certificate (tau
    above every score of the pool, n_fin below nf0)."""
    rng = np.random.default_rng(seed)
    masked0 = rng.uniform(0, 18, (t, c)).astype(np.float32)
    masked0[rng.random((t, c)) < 0.3] = -np.inf
    tau = np.full(t, 0.5, np.float32)
    k_sel = min(4096, c)
    n_fin = rng.integers(0, c + 1, t).astype(np.int32)
    nf0 = (n_fin + rng.integers(1, 1000, t)).astype(np.int32)
    # A key too few of whose scores beat tau is certified by its pool
    # holding every feasible row.
    short = (masked0 > tau[:, None]).sum(axis=1) < k_sel
    nf0[short] = n_fin[short]
    if flag:
        tau[-1] = 18.0
        nf0[-1] = n_fin[-1] + 1
    loc = rng.integers(0, c, p).astype(np.float32)
    loc[rng.random(p) < 0.1] = -1.0
    packed_loc = np.stack([loc, rng.uniform(0, 18, p).astype(np.float32),
                           rng.integers(0, c, p).astype(np.float32)], axis=1)
    n_sel = max(1, min(c, 4096))
    win = rng.integers(0, n_sel, p).astype(np.int32)
    c_use = rng.uniform(0, 4000, (n_sel, r)).astype(np.float32)
    pool_rows = np.sort(rng.choice(max(4 * c, 16), c, replace=False)).astype(
        np.int32)
    cap = rng.uniform(1000, 4000, (c, r)).astype(np.float32)
    use2 = rng.uniform(0, 4000, (c, r)).astype(np.float32)
    elig = rng.random((t, c)) < 0.8
    ban = rng.random(c) < 0.1
    kd = rng.uniform(5, 40, (t, r)).astype(np.float32)
    ring = rng.uniform(0, 500, (ring_rows, r + 1)).astype(np.float32)
    ring[:, 0] = rng.integers(-1, 4 * c, ring_rows)
    tt = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    return (tt(masked0), tt(n_fin), tt(packed_loc), tt(win), tt(c_use),
            tt(pool_rows), tt(cap), tt(use2), tt(elig), tt(ban), tt(kd),
            bool(distinct), tt(tau), tt(nf0), tt(ring), int(ring_n), k_sel)


def mesh_inputs(torch, dev):
    """bench_mesh_1m's data (bench.py _mesh_child, seed 1): MESH_ROWS rows,
    one key, P = MESH_P steps with MESH_VALID valid, a reset every 64."""
    rng = np.random.default_rng(1)
    n, p, t = MESH_ROWS, MESH_P, 1
    arrs = {
        "capacity": rng.uniform(1000, 4000, (n, 5)).astype(np.float32),
        "score_cap": rng.uniform(800, 3800, (n, 2)).astype(np.float32),
        "usage": rng.uniform(0, 200, (n, 5)).astype(np.float32),
        "job_counts": np.zeros(n, np.int32),
        "noise": (rng.random(n) * 1e-3).astype(np.float32),
        "banned0": np.zeros(n, bool),
    }
    arrs["tg_masks"] = rng.random((t, n)) < 0.9
    arrs["key_demands"] = rng.uniform(5, 40, (t, 5)).astype(np.float32)
    arrs["tg_ids"] = rng.integers(0, t, p).astype(np.int32)
    valid = np.zeros(p, bool)
    valid[:MESH_VALID] = True
    reset = np.zeros(p, bool)
    reset[::64] = True
    arrs["valid"], arrs["reset"] = valid, reset
    return {k: torch.tensor(v, device=dev) for k, v in arrs.items()}


def mesh_phase(torch, gpu: str, dev, pin_launches=True):
    """K6-K10 against their plain versions on the 1M-row chain's own stage
    inputs, then the 6-window mesh chain against the single-device keyed
    path. Returns the kernels table entries of K6-K10. pin_launches holds
    the launches per window to this checkout's design (off when another
    commit's package is driven)."""
    from nomad_tpu_torch import native
    from nomad_tpu_torch.parallel import place_batch_sharded, scheduling_mesh
    from nomad_tpu_torch.scheduler import kernels as K

    d = mesh_inputs(torch, dev)
    mesh = scheduling_mesh([dev] * MESH_SHARDS)
    k_cand = K.keyed_cand_count(MESH_VALID)
    prog = K._mesh_keyed_program(mesh, k_cand)
    n, r = d["capacity"].shape
    t = d["key_demands"].shape[0]
    n_loc = n // MESH_SHARDS
    b_buf = min(2 * k_cand, n_loc)
    table = {}

    def window(m, usage):
        return K.place_batch_keyed(
            m, d["capacity"], d["score_cap"], usage, d["tg_masks"],
            d["job_counts"], d["key_demands"], d["tg_ids"], d["valid"],
            d["noise"], 10.0, False, d["banned0"], d["reset"], MESH_VALID)

    # The chain once, kernels, keeping each window's result: the stages'
    # inputs below are this chain's own.
    native.reset_counts()
    K.mesh_stats_drain()
    chain, usage, per_window = [], d["usage"], []
    for _ in range(MESH_WINDOWS):
        before = dict(native.LAUNCHES)
        res = window(mesh, usage)
        torch.cuda.synchronize()
        per_window.append({k: native.LAUNCHES[k] - before[k]
                           for k in native.KERNELS
                           if native.LAUNCHES[k] != before[k]})
        chain.append(res)
        usage = res.usage_after
    stats = K.mesh_stats_drain()
    if pin_launches:
        # One K7 call and one K8 call per cold window cover all shards.
        cold = {"mesh_pack": 1, "apply_ring": 1, "cold_packet": 1,
                "pool_build": 1, "score_topk": 1, "merge_candidates": 1,
                "placement_chain": 1, "warm_finish": 1}
        warm = {"score_topk": 1, "merge_candidates": 1, "placement_chain": 1,
                "warm_finish": 1}
        check(per_window == [cold] + [warm] * (MESH_WINDOWS - 1),
              f"mesh: launches per window {per_window}")
    check(stats["windows"] == MESH_WINDOWS
          and stats["warm_windows"] == MESH_WINDOWS - 1,
          f"mesh: windows {stats}")
    per_exchange = stats["candidate_bytes"]
    check(per_exchange == 1_179_680,
          f"mesh: exchanged {per_exchange} bytes, want 1,179,680")
    last = chain[-1].usage_after

    def stage(name, kernel, plain, args, reps, plain_reps, nb, ops,
              library=None):
        got, ref = kernel(*args), plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        check(all(_bits_equal(torch, a, b) for a, b in zip(got, ref)),
              f"mesh {name}: kernel and plain version differ")
        ms = time_ms(torch, lambda: kernel(*args), reps)
        p_ms = time_ms(torch, lambda: plain(*args), plain_reps)
        l_ms = time_ms(torch, library, reps) if library is not None else None
        bms, by = bound(nb, ops)
        table[name] = dict(max_abs_err=_max_err(torch, got, ref), ms=ms,
                           plain_ms=p_ms, bound_ms=bms, bound_by=by,
                           library_ms=l_ms)
        print(f"phase mesh {name}: identical to plain bit for bit; kernel/"
              f"plain ms {ms:.4f}/{p_ms:.4f}"
              + (f", library {l_ms:.4f}" if l_ms is not None else "")
              + f"; bound {bms:.6f} ms ({by})", flush=True)
        return got

    # K6 on the whole table; library: one torch.cat of the cast columns.
    pack = (d["capacity"], d["score_cap"], d["job_counts"], d["noise"],
            d["banned0"])
    cols = [d["capacity"], d["score_cap"],
            d["job_counts"].to(torch.float32)[:, None], d["noise"][:, None],
            d["banned0"].to(torch.float32)[:, None]]
    packed_table = stage(
        "mesh_pack", K.mesh_pack, K.mesh_pack_plain, pack, 50, 20,
        n * (4 * r + 8 + 4 + 4 + 1) + n * (r + 5) * 4, 0,
        library=lambda: torch.cat(cols, dim=1))[0]
    DEVICE_ONLY.extend([
        (f"mesh_pack at {n} rows", table["mesh_pack"]["ms"],
         lambda: K.mesh_pack(*pack), 50),
        (f"torch.cat of mesh_pack's cast columns at {n} rows",
         table["mesh_pack"]["library_ms"], lambda: torch.cat(cols, dim=1),
         50)])
    # K6 at row counts around its 256-row tile and at 2, 5 and 7 resource
    # dimensions, and with a score_cap at an odd float offset (read as two
    # floats, not a float2).
    pack_cases = [(rows_k6, r_k6) for rows_k6 in (1, 255, 257, n)
                  for r_k6 in (2, 5, 7)]
    for rows_k6, r_k6 in pack_cases:
        rng6 = np.random.default_rng(rows_k6 + r_k6)
        args = tuple(torch.tensor(a, device=dev) for a in (
            rng6.uniform(1e3, 4e3, (rows_k6, r_k6)).astype(np.float32),
            rng6.uniform(8e2, 4e3, (rows_k6, 2)).astype(np.float32),
            rng6.integers(0, 9, rows_k6).astype(np.int32),
            (rng6.random(rows_k6) * 1e-3).astype(np.float32),
            rng6.random(rows_k6) < 0.3))
        check(_bits_equal(torch, K.mesh_pack(*args), K.mesh_pack_plain(*args)),
              f"mesh mesh_pack at {rows_k6} rows, R={r_k6}: kernel and plain "
              f"differ")
        if rows_k6 == 257:
            odd = torch.empty(2 * rows_k6 + 1, device=dev)[1:].view(rows_k6, 2)
            odd.copy_(args[1])
            args = (args[0], odd) + args[2:]
            check(_bits_equal(torch, K.mesh_pack(*args),
                              K.mesh_pack_plain(*args)),
                  f"mesh mesh_pack at {rows_k6} rows, R={r_k6}, score_cap "
                  f"at an odd offset: kernel and plain differ")
    print(f"phase mesh mesh_pack: identical to plain bit for bit at (rows, "
          f"R) {pack_cases} and with a score_cap at an odd float offset",
          flush=True)
    # K7 over every shard's rows in one call (row_base 0, as a_cold and
    # apply_fn call it) against the per-shard plain versions laid end to
    # end: the final chain's ring (5 windows of winners), then 65,536-row
    # rings (mesh-served's) at 1M and at 16,384 rows, and an empty one;
    # each through the program's apply_fn twice (its scratch must come
    # back to -1) and through the wrapper with a scratch of its own. The
    # per-shard form (ROADMAP A7) against its plain version per shard.
    ring, ring_rows = last.ring, last.ring.shape[0]
    for s in range(MESH_SHARDS):
        use_s = last.usage[s * n_loc:(s + 1) * n_loc]
        check(_bits_equal(torch, K.apply_ring(use_s, ring, s * n_loc),
                          K.apply_ring_plain(use_s, ring, s * n_loc)),
              f"mesh apply_ring shard {s}: kernel and plain differ")
    for what, use, rg in (
            ("the chain's ring", last.usage, ring),
            ("a 65,536-row ring", last.usage,
             ring_case(torch, dev, 65536, n, 71)),
            ("a 65,536-row ring over 16,384 rows", last.usage[:16384],
             ring_case(torch, dev, 65536, 16384, 72)),
            ("an empty ring", last.usage[:16384],
             torch.full((1024, r + 1), -1.0, device=dev))):
        rows_s = use.shape[0] // MESH_SHARDS
        per = torch.cat([K.apply_ring_plain(use[q * rows_s:(q + 1) * rows_s],
                                            rg, q * rows_s)
                         for q in range(MESH_SHARDS)])
        check(all(_bits_equal(torch, got, per) for got in (
            prog.apply_fn(use, rg), prog.apply_fn(use, rg),
            K.apply_ring(use, rg, 0))),
              f"mesh apply_ring over all shards, {what}: kernel and the "
              f"per-shard plain versions differ")
    # Timed as a cold window applies it: the program's apply_fn (one call
    # here, one per shard in a package that calls K7 per shard).
    stage("apply_ring", prog.apply_fn,
          lambda u, rg: K.apply_ring_plain(u, rg, 0), (last.usage, ring),
          50, 10, 2 * n * r * 4 + ring_rows * (r + 1) * 4, 0)
    DEVICE_ONLY.append((f"apply_ring over {n} rows, ring {ring_rows} rows, "
                        f"as a cold window applies it",
                        table["apply_ring"]["ms"],
                        lambda: prog.apply_fn(last.usage, ring), 50))
    # K8. The per-shard form (the entry at S = 1 with a row_base) on every
    # shard of the cold window's input (the start usage) against the
    # per-shard plain version.
    mask_s = [d["tg_masks"][:, s * n_loc:(s + 1) * n_loc]
              for s in range(MESH_SHARDS)]
    k8_shards = [(packed_table[s * n_loc:(s + 1) * n_loc],
                  d["usage"][s * n_loc:(s + 1) * n_loc], mask_s[s],
                  d["key_demands"], 10.0, False, s * n_loc, b_buf)
                 for s in range(MESH_SHARDS)]
    for s, args in enumerate(k8_shards):
        check(all(_bits_equal(torch, a, b) for a, b in zip(
            K.cold_packet(*args), K.cold_packet_plain(*args))),
              f"mesh cold_packet shard {s}: kernel and plain differ")
    w = 6 + 2 * r + t
    # The all-shard call (absent from a package of the per-shard design)
    # against the per-shard plain versions laid end to end: at the 1M-row
    # window, at mesh-served's 16,384 rows (B = 2,048 = a whole shard) and
    # at the certificate-miss shape (256 rows a shard, B = 128, four keys,
    # distinct on); each twice through one select scratch, which the
    # first call must leave fit for the second.
    all_shard = getattr(K, "cold_packets", None)
    k8_all = (packed_table, d["usage"], d["tg_masks"], d["key_demands"],
              10.0, False, MESH_SHARDS, b_buf)
    if all_shard is not None:
        k8_work = K.cold_select_work(dev, MESH_SHARDS, t)
        cold_cases = [("the 1M-row window", k8_all, k8_work)]
        for label, rows_k8, t_k8, b_k8, distinct in (
                ("mesh-served's 16,384 rows", 16384, 1, 2048, False),
                ("the certificate-miss shape", 2048, 4, 128, True)):
            wk = window_inputs(torch, dev, np.random.default_rng(rows_k8),
                               rows_k8, t_k8)
            tab = K.mesh_pack(wk["capacity"], wk["score_cap"],
                              wk["job_counts0"], wk["noise"], wk["banned0"])
            cold_cases.append((label, (tab, wk["usage"], wk["tg_masks"],
                                       wk["key_demands"], 10.0, distinct,
                                       MESH_SHARDS, b_k8),
                               K.cold_select_work(dev, MESH_SHARDS, t_k8)))
        for label, args, work in cold_cases:
            want = K.cold_packets_plain(*args)
            for _ in range(2):
                check(all(_bits_equal(torch, a, b) for a, b in zip(
                    all_shard(*args, work=work), want)),
                      f"mesh cold_packet over all shards at {label}: kernel "
                      f"and the per-shard plain versions differ")
        print(f"phase mesh cold_packet: one call over all {MESH_SHARDS} "
              f"shards identical to the per-shard plain versions laid end "
              f"to end bit for bit at "
              + ", ".join(label for label, _, _ in cold_cases)
              + "; the per-shard form identical to its plain version on "
              f"every shard", flush=True)
        # The kernels line's row: the call a cold window makes. Library
        # yardstick: torch.topk of every segment's masked scores, [S*T,
        # n_loc] (its tie order is not the contract: time only).
        masked_all = K.score_topk_plain(
            d["capacity"], d["score_cap"], d["usage"], d["tg_masks"],
            d["job_counts"], d["key_demands"], d["noise"], 10.0, False,
            d["banned0"], b_buf)[0].view(t * MESH_SHARDS, n_loc)
        stage("cold_packet", lambda *a: all_shard(*a, work=k8_work),
              K.cold_packets_plain, k8_all, 20, 3,
              n * ((r + 5) * 4 + r * 4 + t)
              + MESH_SHARDS * t * (b_buf * (w + 1) * 4 + 4),
              t * n * (3 * r + 20),
              library=lambda: torch.topk(masked_all, b_buf, dim=1,
                                         sorted=True))
    else:
        # A package of the per-shard design: its row is one shard's call.
        masked_s0 = K.score_topk_plain(
            d["capacity"][:n_loc], d["score_cap"][:n_loc],
            d["usage"][:n_loc], mask_s[0].contiguous(),
            d["job_counts"][:n_loc], d["key_demands"], d["noise"][:n_loc],
            10.0, False, d["banned0"][:n_loc], b_buf)[0]
        stage("cold_packet", K.cold_packet, K.cold_packet_plain,
              k8_shards[0], 20, 5,
              n_loc * ((r + 5) * 4 + r * 4 + t) + t * b_buf * (w + 1) * 4
              + t * 4, t * n_loc * (3 * r + 20),
              library=lambda: torch.topk(masked_s0, b_buf, dim=1,
                                         sorted=True))

    # K8 as a cold window issues it: one call per shard (the per-shard
    # design) against one call over all shards, by events here and
    # device-only last; and the whole cold stage (K7, K8, the exchange),
    # which both designs run.
    def k8_per_shard():
        for a in k8_shards:
            K.cold_packet(*a)

    def cold_stage():
        pkts, _, nfs, vals = prog.a_cold(
            packed_table, d["usage"], d["tg_masks"], d["key_demands"], 10.0,
            False, prog.ring_zero(r))
        return prog.exchange(pkts, nfs, vals)

    per_shard_ms = time_ms(torch, k8_per_shard, 20)
    cold_stage_ms = time_ms(torch, cold_stage, 20)
    all_ms = (time_ms(torch, lambda: all_shard(*k8_all, work=k8_work), 20)
              if all_shard is not None else None)
    print(f"phase mesh cold_packet at {n} rows: {MESH_SHARDS} per-shard "
          f"calls {per_shard_ms:.4f} ms by events, one call over all shards "
          f"{_fmt(all_ms)} ms; the cold stage (K7, K8, the exchange) "
          f"{cold_stage_ms:.4f} ms", flush=True)
    DEVICE_ONLY.extend([
        (f"cold_packet a shard ({n_loc} rows, B={b_buf})",
         time_ms(torch, lambda: K.cold_packet(*k8_shards[0]), 20),
         lambda: K.cold_packet(*k8_shards[0]), 20),
        (f"cold_packet per shard, {MESH_SHARDS} calls ({n} rows)",
         per_shard_ms, k8_per_shard, 20),
        (f"the cold stage (K7, K8, the exchange) at {n} rows",
         cold_stage_ms, cold_stage, 20)])
    if all_shard is not None:
        DEVICE_ONLY.extend([
            (f"cold_packet over all {MESH_SHARDS} shards, one call ({n} "
             f"rows, B={b_buf})", all_ms,
             lambda: all_shard(*k8_all, work=k8_work), 20),
            (f"torch.topk of the {MESH_SHARDS} shards' scores "
             f"[{t * MESH_SHARDS}, {n_loc}], k={b_buf}",
             table["cold_packet"]["library_ms"],
             lambda: torch.topk(masked_all, b_buf, dim=1, sorted=True), 20)])
    else:
        DEVICE_ONLY.append((
            f"torch.topk of a shard's {n_loc} scores, k={b_buf}",
            table["cold_packet"]["library_ms"],
            lambda: torch.topk(masked_s0, b_buf, dim=1, sorted=True), 20))
    # K9 against its plain version on synthetic packets: T = 3 keys
    # sharing a shard's rows, S = 1, 2, 4, 8, B = 1, B = a whole shard, B
    # no power of two, rows repeated across shards, B = 8,192 (k = 4,096),
    # T * B keys beyond 227 KB, a segment beyond the shared-memory sort,
    # and mesh-served's 16,384 rows (B = 2,048 = a whole shard).
    for case in POOL_CASES:
        args = pool_packets(torch, dev, *case)
        check(all(_bits_equal(torch, a, b) for a, b in zip(
            K.pool_build(*args), K.pool_build_plain(*args))),
              f"mesh pool_build {case}: kernel and plain differ")
    print(f"phase mesh pool_build: identical to plain bit for bit on "
          f"{len(POOL_CASES)} packet shapes (S, T, B, rows a shard, "
          f"overlap) {POOL_CASES}", flush=True)
    # K9 on the cold window's exchange.
    pkts, _, nfs, vals = prog.a_cold(packed_table, d["usage"], d["tg_masks"],
                                     d["key_demands"], 10.0, False,
                                     prog.ring_zero(r))
    ex = prog.exchange(pkts, nfs, vals)
    c = ex[0].shape[0]
    # Library yardstick for K9's sort: torch.sort of its packed (row,
    # position) keys.
    pool_keys = ((ex[0][:, 0].to(torch.int64) << 32)
                 | torch.arange(c, device=dev))
    pool = stage("pool_build", K.pool_build, K.pool_build_plain,
                 (*ex, d["key_demands"]), 20, 5,
                 nbytes(*ex) + c * (r * 4 + 1 + 4 + r * 4 + 8 + 4 + 1 + 4
                                    + t), c * np.log2(c) ** 2 / 2,
                 library=lambda: torch.sort(pool_keys))
    DEVICE_ONLY.extend([
        (f"pool_build at {c} packet rows", table["pool_build"]["ms"],
         lambda: K.pool_build(*ex, d["key_demands"]), 20),
        (f"torch.sort of pool_build's {c} keys",
         table["pool_build"]["library_ms"], lambda: torch.sort(pool_keys),
         20)])
    pool = K.PoolState(*pool)
    # K10 on the last window's warm step: its K2, K3 and K4a outputs.
    prev = chain[-2].usage_after
    masked0, n_fin, cand = K.score_topk(
        prev.pool.cap, prev.pool.sc, prev.pool_use, prev.pool.elig,
        prev.pool.cnt, d["key_demands"], prev.pool.noise, 10.0, False,
        prev.pool.ban, k_cand)
    sel, keep = K.merge_candidates(cand, masked0, k_cand)
    sel_p, keep_p = K.merge_candidates_plain(cand, masked0, k_cand)
    check(torch.equal(sel, sel_p) and torch.equal(keep, keep_p),
          f"mesh merge_candidates over the {masked0.shape[1]}-row pool: "
          f"kernel and plain differ")
    packed_loc, pool_use2, win, c_use = K.placement_chain(
        prev.pool.cap, prev.pool.sc, prev.pool_use, prev.pool.elig,
        prev.pool.cnt, d["key_demands"], d["tg_ids"], d["valid"],
        prev.pool.noise, 10.0, False, prev.pool.ban, reset=d["reset"],
        rows=sel, keep=keep, masked0=masked0, nf0=prev.nf0, winners=True)
    fin_args = (masked0, n_fin, packed_loc, win, c_use, prev.pool.rows,
                prev.pool.cap, pool_use2, prev.pool.elig, prev.pool.ban,
                d["key_demands"], False, prev.pool.tau, prev.nf0, prev.ring,
                prev.ring_n, min(k_cand, prev.pool.rows.shape[0]))
    fin = stage("warm_finish", K.warm_finish, K.warm_finish_plain, fin_args,
                50, 10, nbytes(masked0, n_fin, packed_loc, win, c_use,
                               prev.pool.rows, prev.pool.cap, pool_use2,
                               prev.pool.elig, prev.pool.ban, prev.pool.tau,
                               prev.nf0, prev.ring)
                + nbytes(packed_loc, prev.nf0, prev.ring) + 4,
                t * pool_use2.numel() * 2)
    check(_bits_equal(torch, fin[0], chain[-1].packed)
          and _bits_equal(torch, fin[2], last.ring),
          "mesh warm_finish: the standalone stage differs from the chain")
    DEVICE_ONLY.append((
        f"warm_finish at the 1M-row chain's warm step (pool "
        f"{masked0.shape[1]} rows, ring {prev.ring.shape[0]} rows, P="
        f"{packed_loc.shape[0]})", table["warm_finish"]["ms"],
        lambda: K.warm_finish(*fin_args), 50))
    # K10 at the mesh-served storm's shape (a 16,384-row pool, a
    # 65,536-row ring, 4,096 steps) and at edge shapes, on inputs made
    # from a seed: a certified window, a failed certificate with the delta
    # clamped at the ring's end, three keys with one uncertified, a pool
    # and a ring of no round size, distinct_hosts on, a one-row ring. The
    # served shape's numbers are the kernels line's.
    for case in WARM_FINISH_CASES:
        args = warm_finish_case(torch, dev, *case)
        got, ref = K.warm_finish(*args), K.warm_finish_plain(*args)
        check(all(_bits_equal(torch, a, b) for a, b in zip(got, ref)),
              f"mesh warm_finish {case}: kernel and plain differ")
        check(float(got[3]) == float(case[-1]),
              f"mesh warm_finish {case}: flag {float(got[3])}")
    print(f"phase mesh warm_finish: identical to plain bit for bit on "
          f"{len(WARM_FINISH_CASES)} cases (seed, C, T, P, ring rows, "
          f"ring_n, distinct, flag) {WARM_FINISH_CASES}", flush=True)
    served_fin = warm_finish_case(torch, dev, *WARM_FINISH_CASES[0])
    stage("warm_finish", K.warm_finish, K.warm_finish_plain, served_fin, 50,
          10, nbytes(*[a for a in served_fin if isinstance(a, torch.Tensor)])
          + nbytes(*K.warm_finish_plain(*served_fin)),
          served_fin[0].numel() * (1 + 2 * r))
    DEVICE_ONLY.append((
        "warm_finish at the mesh-served shape (pool 16384 rows, ring 65536 "
        "rows, P=4096)", table["warm_finish"]["ms"],
        lambda: K.warm_finish(*served_fin), 50))
    check(pool.rows.shape[0] == MESH_SHARDS * t * b_buf,
          f"mesh: pool of {pool.rows.shape[0]} rows")

    # The chain against the single-device keyed path, and the timings.
    one, u_one = [], d["usage"]
    for _ in range(MESH_WINDOWS):
        res = window(None, u_one)
        one.append(res)
        u_one = res.usage_after
    for i, (a, b) in enumerate(zip(one, chain)):
        check(_bits_equal(torch, a.packed, b.packed),
              f"mesh window {i}: packed differs from the single device")
    check(_bits_equal(torch, u_one, last.materialize()),
          "mesh: materialized usage differs from the single device")
    placed = [int((x.packed[:, 0] >= 0).sum()) for x in chain]
    check(all(x == MESH_VALID for x in placed),
          f"mesh: placed {placed} per window, want {MESH_VALID}")

    # K2 on the single device's whole table (the window's first launch):
    # kernel, plain and torch.topk of its masked scores.
    k2_args = (d["capacity"], d["score_cap"], d["usage"], d["tg_masks"],
               d["job_counts"], d["key_demands"], d["noise"], 10.0, False,
               d["banned0"], k_cand)
    k2_got = K.score_topk(*k2_args)
    _identical(torch, k2_got, K.score_topk_plain(*k2_args),
               f"K2 at {n} rows")
    k2_ms = time_ms(torch, lambda: K.score_topk(*k2_args), 20)
    k2_plain = time_ms(torch, lambda: K.score_topk_plain(*k2_args), 3)
    k2_topk = time_ms(torch, lambda: torch.topk(k2_got[0], k_cand, dim=1,
                                                sorted=True), 20)
    k2_bound, k2_by = bound(nbytes(*[a for a in k2_args
                                     if isinstance(a, torch.Tensor)])
                            + nbytes(*k2_got), t * n * (3 * r + 20))
    print(f"phase mesh K2 at {n} rows, T={t}, k={k_cand}: identical to plain "
          f"bit for bit; kernel/plain ms {k2_ms:.4f}/{k2_plain:.4f}, "
          f"torch.topk {k2_topk:.4f}; bound {k2_bound:.6f} ms ({k2_by})",
          flush=True)

    def timed_chain(m):
        times = []
        for _ in range(MESH_REPS):
            u, rep = d["usage"], []
            for _ in range(MESH_WINDOWS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                res = window(m, u)
                end.record()
                end.synchronize()
                rep.append(start.elapsed_time(end))
                u = res.usage_after
            times.append(rep)
        return [float(np.median([rep[i] for rep in times]))
                for i in range(MESH_WINDOWS)]

    # Row 12: the scan over node-sharded inputs (place_batch_sharded) at
    # the served table's size, against K4a's plain scan on the same rows.
    w16 = window_inputs(torch, dev, np.random.default_rng(12), 16384, 1)
    s16 = step_inputs(torch, dev, np.random.default_rng(13), 1, 64, 50)
    dem = (w16["key_demands"][s16["tg_ids"].long()]
           * s16["valid"][:, None].float()).contiguous()
    sh_args = (w16["capacity"], w16["score_cap"], w16["usage"],
               w16["tg_masks"], w16["job_counts0"], dem, s16["tg_ids"],
               s16["valid"], w16["noise"], 10.0, False, w16["banned0"])
    got = tuple(place_batch_sharded(mesh, *sh_args))
    ref = K.placement_chain_plain(*sh_args)
    check(all(_bits_equal(torch, a, b) for a, b in zip(got, ref)),
          "mesh place_batch_sharded: differs from K4a's plain scan")
    sh_ms = time_ms(torch, lambda: place_batch_sharded(mesh, *sh_args), 20)
    DEVICE_ONLY.append(("place_batch_sharded at 16384 rows, P=64", sh_ms,
                        lambda: place_batch_sharded(mesh, *sh_args), 20))
    sh_plain = time_ms(torch, lambda: K.placement_chain_plain(*sh_args), 2)
    # Inputs once, packed and the usage copy out; P steps of one pass over
    # the table.
    sh_bound, sh_by = bound(nbytes(*[a for a in sh_args
                                     if isinstance(a, torch.Tensor)])
                            + nbytes(*got), 64 * 16384 * (3 * 5 + 20))
    print(f"phase mesh place_batch_sharded: 16384 rows on {MESH_SHARDS} "
          f"logical shards, P=64: identical to the plain scan bit for bit; "
          f"kernel/plain ms {sh_ms:.4f}/{sh_plain:.4f}; bound "
          f"{sh_bound:.6f} ms ({sh_by})", flush=True)

    timed_chain(mesh)   # warm-up of the timed path
    t_mesh, t_one, t_mesh2 = timed_chain(mesh), timed_chain(None), \
        timed_chain(mesh)
    K.mesh_stats_drain()
    print(f"phase mesh on {gpu}: {n} rows on {MESH_SHARDS} logical shards, "
          f"T={t}, P={MESH_P}, {MESH_VALID} valid, k={k_cand}, B={b_buf}, "
          f"pool {pool.rows.shape[0]} rows ({int(pool.keep.sum())} kept), "
          f"ring {prog.ring_cap} rows; {MESH_WINDOWS} windows (1 cold, "
          f"{MESH_WINDOWS - 1} warm) identical to the single-device keyed "
          f"path bit for bit on packed and usage; exchange "
          f"{per_exchange} bytes per cold window", flush=True)
    print(f"phase mesh on {gpu}: per-window ms (CUDA events, median of "
          f"{MESH_REPS} chains; window 0 cold) mesh "
          f"{['%.4f' % x for x in t_mesh]}, single device "
          f"{['%.4f' % x for x in t_one]}, mesh again "
          f"{['%.4f' % x for x in t_mesh2]}", flush=True)
    print(f"phase mesh: launches per window {per_window}", flush=True)
    # What a wrapper's host time is made of: one ctypes call that makes
    # K7's two launches (its arguments prepared), and one torch.empty.
    lib = native.library()
    k7_out = torch.empty_like(last.usage)
    k7_pos = torch.full((n,), -1, dtype=torch.int32, device=dev)
    raw = (last.usage.data_ptr(), ring.data_ptr(), ring_rows, r, 0, n,
           k7_pos.data_ptr(), k7_out.data_ptr(),
           torch.cuda.current_stream(dev).cuda_stream)
    costs = []
    for fn in (lambda: lib.nomad_apply_ring(*raw),
               lambda: torch.empty(c, device=dev)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        costs.append((time.perf_counter() - t0) * 1e3 / 200)
        torch.cuda.synchronize()
    print(f"phase mesh host costs: one ctypes call making K7's two launches "
          f"{costs[0]:.4f} ms, one torch.empty {costs[1]:.4f} ms", flush=True)
    return table


def mesh_served_phase(torch, gpu: str, dev):
    """The served storm on 8 logical shards against one device. Returns
    the untraced mesh storm's launches."""
    from nomad_tpu_torch import native
    from nomad_tpu_torch.parallel import scheduling_mesh
    from nomad_tpu_torch.scheduler import kernels as K
    from nomad_tpu_torch.scheduler import stack as stack_mod

    nodes = build_nodes()
    jobs = [make_job() for _ in range(N_SERVED_EVALS)]
    traced_jobs = [make_job() for _ in range(N_SERVED_EVALS)]
    mesh = scheduling_mesh([dev] * MESH_SHARDS)

    def storm(srv, batch, latencies=None):
        t_submit, eval_ids = {}, []
        for j in batch:
            eid = srv.job_register(j.copy())[0]
            t_submit[eid] = time.monotonic()
            eval_ids.append(eid)
        deadline = time.monotonic() + 300
        pending = set(eval_ids)
        while pending and time.monotonic() < deadline:
            now = time.monotonic()
            done = {eid for eid in pending
                    if (e := srv.state.eval_by_id(eid)) is not None
                    and e.Status == "complete"}
            if latencies is not None:
                latencies.extend(now - t_submit[eid] for eid in done)
            pending -= done
            if pending:
                time.sleep(0.02)
        check(not pending, f"mesh-served: {len(pending)} of {len(batch)} "
              f"evals never completed")
        return eval_ids

    def run(m, traced_too):
        srv = _new_server(torch, nodes, num_schedulers=1, device="cuda",
                          mesh=m)
        out = {}
        try:
            worker = srv.workers[0]
            worker.reset_stats()
            K.mesh_stats_drain()
            gc.collect()
            native.reset_counts()
            lats = []
            torch.cuda.synchronize()
            t0 = time.monotonic()
            storm(srv, jobs, lats)
            torch.cuda.synchronize()
            out["wall"] = time.monotonic() - t0
            check(worker.quiesce(60), "mesh-served: never quiesced")
            out["launches"] = dict(native.LAUNCHES)
            out["plain_calls"] = dict(native.PLAIN_CALLS)
            out["stats"] = dict(worker.stats)
            out["lats"] = lats
            out["live"] = {(a.JobID, a.Name): a.NodeID
                           for a in srv.state.allocs()
                           if not a.terminal_status()}
            out["usage"] = _usage_checks(torch, srv, "mesh-served")
            if traced_too:
                worker.reset_stats()
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    t0 = time.monotonic()
                    storm(srv, traced_jobs)
                    torch.cuda.synchronize()
                    out["traced_wall"] = time.monotonic() - t0
                check(worker.quiesce(60), "mesh-served: traced never quiesced")
                device_ms = {}
                for ev in prof.key_averages():
                    us = getattr(ev, "self_device_time_total", None)
                    if us is None:
                        us = getattr(ev, "self_cuda_time_total", 0)
                    if us:
                        device_ms[ev.key] = us / 1e3
                out["device_ms"] = device_ms
                out["counts"] = trace_counts(prof)
                out["traced_stats"] = dict(worker.stats)
        finally:
            srv.shutdown()
        return out

    noise_fn = stack_mod.make_noise_vec
    stack_mod.make_noise_vec = _fixed_noise
    try:
        one = run(None, False)
        shd = run(mesh, True)
    finally:
        stack_mod.make_noise_vec = noise_fn
    want = N_SERVED_EVALS * PER_EVAL
    check(len(one["live"]) == want and len(shd["live"]) == want,
          f"mesh-served: {len(one['live'])} / {len(shd['live'])} live "
          f"allocs, want {want}")
    check(one["live"] == shd["live"],
          "mesh-served: the mesh and the single device placed differently")
    check(np.array_equal(one["usage"], shd["usage"]),
          "mesh-served: committed usage differs from the single device")
    for res, name in ((one, "single device"), (shd, "mesh")):
        st = res["stats"]
        lat_ms = np.asarray(res["lats"]) * 1e3
        print(f"phase mesh-served ({name}) on {gpu}: {N_SERVED_EVALS} evals"
              f", {want} placements in {res['wall']:.3f} s: "
              f"{N_SERVED_EVALS / res['wall']:.1f} evals/s; p50 "
              f"{np.percentile(lat_ms, 50):.1f} ms, p99 "
              f"{np.percentile(lat_ms, 99):.1f} ms; windows {st['windows']}"
              f", multi {st['multi']}, fallback {st['fallback']}, rebases "
              f"{st['rebases']}, mesh windows {st['mesh_windows']} (warm "
              f"{st['mesh_warm']}, cert misses {st['mesh_cert_miss']}, "
              f"{st['mesh_bytes']} bytes exchanged, "
              f"t_mesh_exchange_ms {st['t_mesh_exchange_ms']:.3f}); "
              f"host ms per window t_refresh_ms "
              f"{st['t_refresh_ms'] / st['windows']:.4f}, t_drain_stack_ms "
              f"{st['t_drain_stack_ms'] / st['windows']:.4f}; "
              f"launches {res['launches']}", flush=True)
    st = shd["stats"]
    check(st["mesh_windows"] == st["windows"] and st["mesh_warm"] > 0
          and st["fallback"] == 0 and st["slow"] == 0
          and st["mesh_shards"] == MESH_SHARDS,
          f"mesh-served: worker stats {st}")
    check(one["stats"]["mesh_windows"] == 0,
          "mesh-served: the single-device server ran mesh windows")
    for k in ("score_topk", "merge_candidates", "placement_chain",
              "compact_window") + MESH_KERNELS:
        check(shd["launches"][k] > 0,
              f"mesh-served: kernel {k} never launched")
    check(not any(shd["plain_calls"].values()),
          f"mesh-served: plain versions ran: {shd['plain_calls']}")
    busy = sum(shd["device_ms"].values())
    wall_ms = shd["traced_wall"] * 1e3
    ts = shd["traced_stats"]
    if busy > 0:
        top = sorted(shd["device_ms"].items(), key=lambda kv: -kv[1])[:10]
        print(f"phase mesh-served (traced storm) on {gpu}: {wall_ms:.1f} ms "
              f"wall, device busy {busy:.3f} ms, idle share "
              f"{1 - busy / wall_ms:.4f}; windows {ts['windows']}, mesh "
              f"{ts['mesh_windows']} (warm {ts['mesh_warm']}); copies and "
              f"runtime calls {json.dumps(shd['counts'])}; device ms by "
              f"entry: " + "; ".join(f"{k[:60]}={v:.3f}" for k, v in top),
              flush=True)
    else:
        print("phase mesh-served (traced storm): device busy share not "
              "measured: the trace held no device time", flush=True)
    print(f"phase mesh-served: the mesh and the single-device servers hold "
          f"the same {want} allocs on the same nodes with identical usage",
          flush=True)
    return shd["launches"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="kernels,storm,served-identity,served,mesh,"
                            "mesh-served-identity,mesh-served,system,placer,"
                            "agent,cluster",
                    help="comma list of phases to run (default: all)")
    ap.add_argument("--package-root", default=None,
                    help="drive the nomad_tpu_torch package found in this "
                         "directory (for example an unpacked earlier "
                         "commit) instead of this checkout's")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if args.package_root is not None:
        sys.path.insert(0, os.path.abspath(args.package_root))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    from nomad_tpu_torch import native

    dev = torch.device("cuda")
    gpu = gpu_line()
    print(f"gpu: {gpu}", flush=True)
    print(f"package: {os.path.dirname(os.path.dirname(native.__file__))}",
          flush=True)
    t0 = time.monotonic()
    native.library()
    print(f"kernels built and loaded in {time.monotonic() - t0:.1f} s "
          f"(nvcc {native.build_seconds if native.build_seconds is not None else 0:.1f} s)",
          flush=True)

    unknown = phases - {"kernels", "system", "placer", "storm",
                        "served-identity", "served", "mesh",
                        "mesh-served-identity", "mesh-served", "agent",
                        "cluster"}
    check(not unknown, f"unknown phases {sorted(unknown)}")
    def run(name, fn, default=None):
        """Run one phase when it was asked for, and print its seconds."""
        if name not in phases:
            return default
        t0 = time.monotonic()
        out = fn()
        print(f"phase {name} took {time.monotonic() - t0:.1f} s", flush=True)
        return out

    table = run("kernels", lambda: run_kernel_phases(torch, dev), {})
    storm_launches = run("storm", lambda: storm_phase(torch, gpu), {})
    if storm_launches:
        print(f"per-eval storm path launches: {storm_launches}", flush=True)
    run("served-identity", lambda: served_identity_phase(torch, gpu))
    # The kernels line reports the served storm's launches: this slice's
    # main path (the per-eval storm's are printed above).
    launches = dict(run("served", lambda: served_phase(torch, gpu),
                        storm_launches))
    table.update(run("mesh", lambda: mesh_phase(
        torch, gpu, dev, pin_launches=args.package_root is None), {}))
    run("mesh-served-identity",
        lambda: mesh_served_identity_phase(torch, gpu, dev))
    # K6-K10 run only on a mesh: their launches are the mesh-served
    # storm's, the served path with the table on logical shards.
    mesh_launches = run("mesh-served",
                        lambda: mesh_served_phase(torch, gpu, dev))
    if mesh_launches:
        launches.update({k: mesh_launches[k] for k in MESH_KERNELS})
    # The system and placer paths run last, so the served and mesh storms
    # above follow the same phases whether or not these two are asked
    # for; their own numbers follow the earlier phases' profiler sessions
    # (one slows every later launch in the process). Each prints its
    # launches.
    system_launches = run("system", lambda: system_phase(torch, gpu))
    if system_launches:
        print(f"system path launches: {system_launches}", flush=True)
    placer_launches = run("placer", lambda: placer_phase(torch, gpu))
    if placer_launches:
        print(f"placer path launches: {placer_launches}", flush=True)
    # The dev agent (HTTP, CLI, client runtime, `nomad plan`) after every
    # earlier phase, so each of them runs as before.
    agent_launches = run("agent", lambda: agent_phase(torch, gpu))
    if agent_launches:
        print(f"agent path launches (HTTP storm): {agent_launches}",
              flush=True)
    # The replicated server (three servers, raft, gossip, a leader kill)
    # after every earlier phase, so each of them runs as before.
    cluster_launches = run("cluster", lambda: cluster_phase(torch, gpu))
    if cluster_launches:
        print(f"cluster path launches (the storm, all three servers): "
              f"{cluster_launches}", flush=True)
    device_only_phase(torch)
    rows = []
    for name in native.KERNELS:
        rows.append(dict(name=name, route="cuda", source=SOURCES[name],
                         replaces=REPLACES[name],
                         launches=launches.get(name, 0),
                         **table.get(name, {})))
    print(json.dumps({"kernels": rows}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
