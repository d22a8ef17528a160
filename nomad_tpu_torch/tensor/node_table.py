"""Node table with incremental updates and device tensors.

Ported from nomad_tpu/tensor/node_table.py: the device arrays are torch
tensors on the table's explicit `device` (`cuda` unless the caller passes
`device="cpu"`; a CUDA table on a machine without CUDA raises), and the
dirty-row refresh runs kernel K4b (`csrc/refresh.cu`). The host packs each
refresh chunk straight into a slot of a ring of pinned staging buffers,
which K4b reads in place over PCIe: a refresh issues no upload and no
stream sync, so it never waits for the work already queued on the card.
A slot is rewritten only after the event recorded behind its last kernel
has completed (the reference likewise hands JAX a host array to place).

Columns (float32, resource dims R=5): cpu MHz, memory MB, disk MB, iops,
network mbits. Three persistent arrays:

  capacity  [N, R]  total node resources (the fit bound — reserved counts as
                    usage, matching reference AllocsFit, funcs.go:44-100)
  score_cap [N, 2]  (cpu, mem) minus reserved — the ScoreFit denominator
                    (funcs.go:105-117)
  usage     [N, R]  reserved + sum of non-terminal committed allocs

Rows are stable per node for the node's lifetime (free-list reuse), the array
is padded to power-of-two buckets, and host numpy mirrors are authoritative:
device copies are refreshed by row-scatter of dirty rows just before a
scheduling kernel runs (keep the node tensor resident, delta-scatter
updates, never re-ship the table).

Unlike the reference's immutable JAX arrays, the device tensors are updated
IN PLACE by the refresh. A kernel launched before a refresh still reads the
old rows (launches are ordered on the one stream every kernel of the port
runs on); code that mutates the usage it gets from `device_arrays()` must
work on a copy.

What a placement reads: `device_arrays()` hands out the LIVE tensors (the
refresh's own targets). A placement that launches several kernels in a row
(K2, K3, K4a) must not see a refresh land between them: the server's build
thread refreshes the table while the dispatch thread launches, and a row
rewritten after K2 scored it would break the replay's exactness. So
placements read `device_snapshot()`: clones of the tables taken under the
table lock, in stream order right after the refresh, which no later refresh
touches. The pipelined worker takes one snapshot per window (the
reference's window read one immutable set of arrays); the per-eval stack
takes one per dispatch. Usage is cloned per snapshot (0.3 MB at 16,384
rows); capacity and score_cap once per change of their rows, shared by the
snapshots in between.

Mesh (`set_mesh`): the node axis may shard over a scheduling mesh of S
logical shards of the table's one device; the tensors stay whole and each
shard is a row slice of them (parallel/mesh.py). A mesh over distinct
devices raises.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from nomad_tpu_torch import native
from nomad_tpu_torch.analysis import guarded_by
from nomad_tpu_torch.structs import Allocation, Node, Resources
from nomad_tpu_torch.structs.structs import NodeStatusReady

RES_DIMS = 5  # cpu, mem, disk, iops, mbits
DIM_NAMES = ("cpu", "memory", "disk", "iops", "bandwidth")
_MIN_CAP = 64
# Dirty-row device refresh chunks (fixed shapes -> bounded compile count:
# trickle, steady, storm, and rebase-after-storm buckets).
_REFRESH_CHUNKS = (8, 128, 2048, 16384)
# Packed refresh row: (row, capacity [R], score_cap [2], usage [R]).
_REFRESH_WIDTH = 2 * RES_DIMS + 3
# Staging slots of a table's refresh ring: a refresh waits for a slot's
# previous kernel only when this many chunks are queued unread.
_STAGING_SLOTS = 4


def resources_vec(r: Optional[Resources]) -> np.ndarray:
    out = np.zeros(RES_DIMS, dtype=np.float32)
    if r is None:
        return out
    out[0] = r.CPU
    out[1] = r.MemoryMB
    out[2] = r.DiskMB
    out[3] = r.IOPS
    out[4] = sum(n.MBits for n in r.Networks)
    return out


def alloc_vec(alloc: Allocation) -> np.ndarray:
    """Resource vector of an allocation, memoized on the instance: the
    commit path reads it three times per alloc (usage listener, vectorized
    plan verify, optimistic overlay). Allocations are value-frozen once
    built — anything that changes resources replaces the object — so the
    memo cannot go stale. Callers must not mutate the returned array."""
    vec = getattr(alloc, "_resvec_cache", None)
    if vec is not None:
        return vec
    if alloc.Resources is not None:
        out = resources_vec(alloc.Resources)
    else:
        out = np.zeros(RES_DIMS, dtype=np.float32)
        for r in alloc.TaskResources.values():
            out += resources_vec(r)
    alloc._resvec_cache = out
    return out


class NodeTensor:
    """Mutable host mirror + lazily synced device arrays of the node table."""

    def __init__(self, capacity_hint: int = _MIN_CAP, device="cuda"):
        self.device = resolve_device(device)
        n = max(_MIN_CAP, _next_pow2(capacity_hint))
        self._lock = threading.RLock()
        self.n_rows = n
        self.capacity = np.zeros((n, RES_DIMS), dtype=np.float32)
        self.score_cap = np.ones((n, 2), dtype=np.float32)  # avoid div-by-0
        self.usage = np.zeros((n, RES_DIMS), dtype=np.float32)
        self.ready = np.zeros(n, dtype=bool)
        self.class_ids = np.zeros(n, dtype=np.int32)
        self.dc_ids = np.full(n, -1, dtype=np.int32)

        self.row_of: Dict[str, int] = {}
        self.node_of: List[Optional[str]] = [None] * n
        # Lazily built object-dtype mirror of node_of for vectorized
        # row->node-ID gathers (the windowed collect maps a whole window's
        # chosen rows in one fancy index instead of a Python lookup per
        # placement). Invalidated whenever a row's identity changes.
        self._node_id_arr: Optional[np.ndarray] = None
        self._free: List[int] = list(range(n - 1, -1, -1))
        self._reserved_cache: Dict[str, np.ndarray] = {}
        # Bumped whenever a row's IDENTITY changes (node removed, row freed
        # for reuse, table grown): a device-side usage chain built against an
        # older epoch may carry a departed node's usage on a reused row and
        # must rebase (shape checks alone miss free-list reuse).
        self.row_epoch = 0
        # Bumped on ANY node-set change (upsert, readiness flip, removal):
        # the invalidation key for caches derived from the node population —
        # the shared sweep eligibility (TensorIndex.shared_elig) and the
        # system scheduler's memoized ready-node list. Coarser than
        # row_epoch, which only tracks identity changes.
        self.node_version = 0

        # Vocabularies
        self.class_vocab: Dict[str, int] = {}
        self.class_names: List[str] = []
        self.dc_vocab: Dict[str, int] = {}
        self.dc_names: List[str] = []

        # Device sync state. Two dirty tiers: rows whose capacity/readiness
        # changed (node upserts — must always refresh) vs rows where only
        # USAGE moved (alloc commits). A caller that overrides usage with a
        # device-side chain can skip the usage tier (the pipelined worker
        # mid-storm), so a storm window pays no usage refresh.
        self._dirty_rows: Set[int] = set()
        self._usage_dirty: Set[int] = set()
        self._resized = True
        self._device: Optional[dict] = None
        # Bumped whenever the device capacity/score_cap rows change (a full
        # upload, or a refresh of capacity-tier dirty rows): snapshots share
        # one clone of those two tables until then, so a window's static
        # inputs keep their identity across a storm (the mesh pipeline's warm
        # signature) and a window clones only usage.
        self._static_gen = 0
        self._static_snap: Optional[tuple] = None
        # The scheduling mesh the node axis shards over (set_mesh), or None.
        self.mesh = None
        # Host staging of the refresh chunks, made at the first refresh.
        self._ring: Optional[_StagingRing] = None

    # --------------------------------------------------------------- mesh
    def set_mesh(self, mesh) -> None:
        """Shard the node axis over `mesh` (parallel.SchedulingMesh), or
        None for a single device. A power-of-two shard count: rows pad to
        powers of two (>= 64), so divisibility holds for any such mesh up to
        64 shards and survives table growth. The shards are logical shards
        of the table's own device — row slices of the same tensors — so a
        mesh over distinct devices raises NotImplementedError (ROADMAP's
        multi-card mesh item), as does one on another device than the
        table's (ValueError). Call before serving traffic; the device
        tensors are re-uploaded."""
        if mesh is not None:
            n_dev = mesh.size
            if n_dev & (n_dev - 1):
                raise ValueError(
                    f"scheduling mesh needs a power-of-two device count, got "
                    f"{n_dev}")
            if self.n_rows % n_dev:
                raise ValueError(
                    f"node axis ({self.n_rows}) not divisible by mesh "
                    f"({n_dev})")
            dev = mesh.one_device()
            if dev != _explicit(self.device):
                raise ValueError(f"mesh on {dev}, node table on {self.device}")
        self.mesh = mesh
        self._device = None
        self._resized = True

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """Upload one full array to the table's device (always a copy: the
        device tensor never aliases the host mirror, on the CPU either)."""
        return torch.tensor(arr, device=self.device)

    # ------------------------------------------------------------- vocab
    def class_id(self, computed_class: str) -> int:
        cid = self.class_vocab.get(computed_class)
        if cid is None:
            cid = len(self.class_names)
            self.class_vocab[computed_class] = cid
            self.class_names.append(computed_class)
        return cid

    def dc_id(self, dc: str) -> int:
        did = self.dc_vocab.get(dc)
        if did is None:
            did = len(self.dc_names)
            self.dc_vocab[dc] = did
            self.dc_names.append(dc)
        return did

    # ------------------------------------------------------------ updates
    def upsert_node(self, node: Node) -> None:
        with self._lock:
            row = self.row_of.get(node.ID)
            if row is None:
                row = self._alloc_row()
                self.row_of[node.ID] = row
                self.node_of[row] = node.ID
                self._node_id_arr = None
                self.usage[row] = 0.0
            cap = resources_vec(node.Resources)
            reserved = resources_vec(node.Reserved)
            self.capacity[row] = cap
            # ScoreFit denominator: total minus reserved for cpu/mem. May be
            # zero; the kernel reproduces Go's Inf/NaN division semantics.
            self.score_cap[row] = cap[:2] - reserved[:2]
            # Reserved is baseline usage; preserve the alloc-usage component.
            self.usage[row] = self.usage[row] - self._reserved_of(node.ID) + reserved
            self._reserved_cache[node.ID] = reserved
            self.ready[row] = (node.Status == NodeStatusReady) and not node.Drain
            self.class_ids[row] = self.class_id(node.ComputedClass)
            self.dc_ids[row] = self.dc_id(node.Datacenter)
            self._dirty_rows.add(row)
            self.node_version += 1

    def _reserved_of(self, node_id: str) -> np.ndarray:
        return self._reserved_cache.get(node_id, np.zeros(RES_DIMS, dtype=np.float32))

    def set_node_readiness(self, node_id: str, ready: bool) -> None:
        with self._lock:
            row = self.row_of.get(node_id)
            if row is None:
                return
            self.ready[row] = ready
            self._dirty_rows.add(row)
            self.node_version += 1

    def remove_node(self, node_id: str) -> None:
        with self._lock:
            row = self.row_of.pop(node_id, None)
            if row is None:
                return
            self.node_of[row] = None
            self._node_id_arr = None
            self.capacity[row] = 0.0
            self.score_cap[row] = 1.0
            self.usage[row] = 0.0
            self.ready[row] = False
            self.dc_ids[row] = -1
            self._free.append(row)
            self._dirty_rows.add(row)
            self._reserved_cache.pop(node_id, None)
            self.row_epoch += 1
            self.node_version += 1

    def reset(self) -> None:
        """Drop every row in place (a snapshot restore replaced the world
        and the incremental feed never saw the staged writes). Mirrors are
        zeroed, all rows freed, and BOTH epochs bump so every derived
        consumer — usage chains, shared eligibility, cached row-id arrays
        — rebuilds against the restored population. Mesh/sharding and the
        vocabularies survive: ids are append-only and stay valid."""
        with self._lock:
            self.capacity[:] = 0.0
            self.score_cap[:] = 1.0
            self.usage[:] = 0.0
            self.ready[:] = False
            self.class_ids[:] = 0
            self.dc_ids[:] = -1
            self.row_of.clear()
            self.node_of = [None] * self.n_rows
            self._node_id_arr = None
            self._free = list(range(self.n_rows - 1, -1, -1))
            self._reserved_cache.clear()
            self._dirty_rows.clear()
            self._usage_dirty.clear()
            self._resized = True  # full re-upload on next device_arrays
            self.row_epoch += 1
            self.node_version += 1

    def add_alloc_usage(self, alloc: Allocation) -> None:
        self._apply_usage(alloc, +1.0)

    def remove_alloc_usage(self, alloc: Allocation) -> None:
        self._apply_usage(alloc, -1.0)

    def _apply_usage(self, alloc: Allocation, sign: float) -> None:
        with self._lock:
            row = self.row_of.get(alloc.NodeID)
            if row is None:
                return
            self.usage[row] += sign * alloc_vec(alloc)
            self._usage_dirty.add(row)

    def apply_row_usage_deltas(self, rows: np.ndarray, vecs: np.ndarray,
                               epoch: int) -> bool:
        """Row-addressed batch usage transition: a columnar sweep commit
        carries its node ROWS from emit time, so when no row changed
        identity since (`epoch` still current) the whole batch lands as
        one scatter-add with ZERO per-node dict lookups. Returns False —
        apply nothing — when the epoch moved or rows are out of bounds;
        the caller falls back to the id-addressed path."""
        with self._lock:
            if len(rows) == 0:
                return True
            if epoch != self.row_epoch:
                return False
            if int(rows[-1]) >= self.n_rows:  # rows are sorted ascending
                return False
            np.add.at(self.usage, rows, vecs)
            self._usage_dirty.update(rows.tolist())
            return True

    def apply_usage_deltas(self, node_ids: Sequence[str],
                           vecs: np.ndarray) -> None:
        """Batched usage transitions under ONE lock: a committed plan's 50
        allocs become one scatter-add instead of 50 lock/indexing rounds
        (the plan applier is on the scheduling critical path)."""
        with self._lock:
            rows = []
            keep = []
            for k, nid in enumerate(node_ids):
                row = self.row_of.get(nid)
                if row is not None:
                    rows.append(row)
                    keep.append(k)
            if not rows:
                return
            rows_arr = np.asarray(rows, dtype=np.int64)
            np.add.at(self.usage, rows_arr, vecs[keep])
            self._usage_dirty.update(rows)

    # ------------------------------------------------------------ row mgmt
    def _alloc_row(self) -> int:
        if not self._free:
            self._grow()
        return self._free.pop()

    def _grow(self) -> None:
        old = self.n_rows
        new = old * 2
        self.capacity = _grow2(self.capacity, new)
        self.score_cap = _grow2(self.score_cap, new, fill=1.0)
        self.usage = _grow2(self.usage, new)
        self.ready = _grow1(self.ready, new, fill=False)
        self.class_ids = _grow1(self.class_ids, new, fill=0)
        self.dc_ids = _grow1(self.dc_ids, new, fill=-1)
        self.node_of.extend([None] * (new - old))
        self._free.extend(range(new - 1, old - 1, -1))
        self.n_rows = new
        self._resized = True
        self.row_epoch += 1

    # --------------------------------------------------------- device sync
    def device_arrays(self, skip_usage: bool = False) -> dict:
        """Return the device tensors, refreshing dirty rows via scatter (K4b).

        The tensors are the table's live ones, not a snapshot: the next
        refresh rewrites their rows in place (placements read
        `device_snapshot()`). skip_usage=True refreshes only rows whose
        capacity/readiness changed and leaves usage-only dirty rows queued —
        valid ONLY for callers that override the usage input with their own
        device-side chain (the pipelined worker mid-storm). The queued rows
        are flushed by the next full call."""
        with self._lock:
            pending = (set(self._dirty_rows) if skip_usage
                       else self._dirty_rows | self._usage_dirty)
            if self._device is None or self._resized:
                if self.mesh is not None and self.n_rows % self.mesh.size:
                    raise ValueError(
                        f"node axis ({self.n_rows}) not divisible by mesh "
                        f"({self.mesh.size})")
                self._static_gen += 1
                self._device = {
                    "capacity": self._put(self.capacity),
                    "score_cap": self._put(self.score_cap),
                    "usage": self._put(self.usage),
                }
                self._resized = False
                self._dirty_rows.clear()
                self._usage_dirty.clear()
            elif pending:
                if self._dirty_rows:
                    self._static_gen += 1
                rows = np.fromiter(pending, dtype=np.int32)
                # Fixed-size scatter chunks (tail padded by repeating the
                # first row — sets are idempotent), the reference's buckets:
                # the smallest that fits, so one dirty heartbeat row does not
                # ship a storm-sized transfer.
                d = self._device
                size = _REFRESH_CHUNKS[-1]
                for candidate in _REFRESH_CHUNKS:
                    if len(rows) <= candidate:
                        size = candidate
                        break
                for i in range(0, len(rows), size):
                    self._refresh(d, rows[i:i + size], size)
                # The scatter writes all three column groups, so refreshed
                # rows are current in BOTH tiers regardless of why they were
                # dirty.
                self._dirty_rows -= pending
                self._usage_dirty -= pending
            return dict(self._device)

    def device_snapshot(self, skip_usage: bool = False) -> dict:
        """Clones of the refreshed device tensors, taken under the table
        lock: what a placement reads (see the module docstring). No later
        refresh rewrites them, and nothing writes to them. Usage is cloned
        every call; capacity and score_cap are cloned once per change of
        those rows and shared by every snapshot in between."""
        with self._lock:
            d = self.device_arrays(skip_usage)
            snap = self._static_snap
            if snap is None or snap[0] != self._static_gen:
                snap = (self._static_gen,
                        {k: d[k].clone() for k in ("capacity", "score_cap")})
                self._static_snap = snap
            out = dict(snap[1])
            out["usage"] = d["usage"].clone()
            return out

    def pack_chunk(self, out: np.ndarray, chunk: np.ndarray,
                   size: int) -> None:
        """Write one refresh chunk into out[:size]: per row (row, capacity,
        score_cap, usage), rows and all three column groups in one block
        that K4b splits on the card; the tail past the chunk repeats its
        first row (sets are idempotent), so every chunk has a bucket's
        shape. Call under the table lock."""
        n, r = len(chunk), RES_DIMS
        out[:n, 0] = chunk
        out[:n, 1:1 + r] = self.capacity[chunk]
        out[:n, 1 + r:3 + r] = self.score_cap[chunk]
        out[:n, 3 + r:] = self.usage[chunk]
        out[n:size] = out[0]

    def _refresh(self, d: dict, chunk: np.ndarray, size: int) -> None:
        """Pack `chunk` (at most `size` rows) into a free staging slot and
        launch K4b on it in place. Under the table lock."""
        if self._ring is None:
            self._ring = _StagingRing(self.device)
        ring = self._ring
        slot = ring.take()
        self.pack_chunk(ring.views[slot], chunk, size)
        block = ring.bufs[slot][:size]
        if native.plain_on_card:
            scatter_refresh_plain(d["capacity"], d["score_cap"], d["usage"],
                                  block.to(self.device, non_blocking=True))
        else:
            scatter_refresh(d["capacity"], d["score_cap"], d["usage"], block)
        ring.done(slot)

    def warm_device(self) -> None:
        """Load the kernels (building them on first use) and run the refresh
        once at every _REFRESH_CHUNKS bucket, so the first dirty set of a
        serving table pays no build or first-launch cost. The warm scatter
        rewrites row 0 with its own current values — a no-op — so this is
        safe to call at any time."""
        with self._lock:
            self.device_arrays()
            d = self._device
            for size in _REFRESH_CHUNKS:
                self._refresh(d, np.zeros(1, dtype=np.int32), size)

    # ------------------------------------------------------------- queries
    def node_id_array(self) -> np.ndarray:
        """Object-dtype [n_rows] mirror of node_of, rebuilt lazily when a
        row's identity changes. Callers get a SNAPSHOT: a node removed
        after the return may still appear — the same benign race as a live
        node_of read per placement; the plan applier's re-verification
        against committed state owns the outcome either way."""
        with self._lock:
            arr = self._node_id_arr
            if arr is None or len(arr) != self.n_rows:
                arr = np.empty(self.n_rows, dtype=object)
                arr[:] = self.node_of
                self._node_id_arr = arr
            return arr

    def rows_for(self, node_ids: Sequence[str]) -> np.ndarray:
        return np.array([self.row_of[i] for i in node_ids], dtype=np.int32)

    def snapshot_rows(self, rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Consistent (usage, capacity) copies of the given rows, taken under
        the tensor lock. Alloc commits mutate usage rows IN PLACE
        (_apply_usage), so a lock-free reader could see a torn row — half a
        usage vector before an in-flight `+=`, half after. Fancy indexing
        copies, so the returned arrays are immune to later mutation."""
        with self._lock:
            return self.usage[rows], self.capacity[rows]

    def eligibility_mask(self, dc_ids: Sequence[int],
                        class_ok: Optional[np.ndarray]) -> np.ndarray:
        """ready & datacenter-membership & per-class eligibility, as [N] bool."""
        with self._lock:
            mask = self.ready.copy()
            if dc_ids is not None:
                mask &= np.isin(self.dc_ids, np.asarray(list(dc_ids), dtype=np.int32))
            if class_ok is not None:
                mask &= class_ok[self.class_ids]
            return mask


# Force a chain rebase after this many chained windows: the chain misses
# slow-path/fallback commits (undercount — the applier catches any
# oversubscription) and evictions (overcount — spurious blocked evals), so
# its drift is bounded even through a storm that never pauses.
REBASE_WINDOWS = 256


class ChainLease:
    """One window's exclusive hold on the shared device usage chain.

    Returned by :meth:`ChainArbiter.acquire`; carries the usage array the
    window's kernels must chain on (``None`` = committed usage from the
    table), the arbiter's taint sequence at acquire time (windows in
    flight compare it at finish to detect phantom usage raised under
    them), and the node-table row epoch observed at chain-validation time
    (a row changing identity mid-dispatch must still rebase the NEXT
    window). The holder ends the lease with exactly one of
    :meth:`ChainArbiter.publish` (fast evals dispatched — the window is
    now in flight) or :meth:`ChainArbiter.abort` (nothing dispatched)."""

    __slots__ = ("chain", "taint_seq", "epoch", "rebased", "released",
                 "seq")

    def __init__(self, chain, taint_seq: int, epoch: int, rebased: bool):
        self.chain = chain
        self.taint_seq = taint_seq
        self.epoch = epoch
        self.rebased = rebased
        self.released = False  # publish/abort happened (one-shot)
        self.seq = 0           # chain position, assigned at publish


class ChainArbiter:
    """Arbiter of the cross-worker device usage chain.

    N pipelined workers place optimistically against one node table; their
    windows chain each kernel on the previous window's ``usage_after`` so
    every placement sees every placement dispatched before it — regardless
    of which worker dispatched it. Without arbitration, two workers each
    keep a PRIVATE chain from committed usage: neither sees the other's
    in-flight placements, both argmax onto the same best rows, and the
    plan applier bounces half the plans as partial commits (the measured
    2-worker collapse). The arbiter serializes only the chain handoff:

      * ``acquire`` — block until no other window is mid-dispatch, decide
        whether the tail is still valid (taint/epoch/depth/drained checks,
        previously per-worker ``_usage_chain``), and hand the tail out as
        a :class:`ChainLease`.
      * ``publish`` — install the window's ``usage_after`` as the new
        tail and count the window in flight; the next ``acquire`` (any
        worker) chains on it.
      * ``taint`` / ``finish_window`` — a window that ends with stale or
        fallback records left phantom usage in the chain; the taint bumps
        the sequence (in-flight windows quarantine their squeezed evals
        at finish) and marks the tail dirty so the next ``acquire`` drains
        ALL lease holders — across every worker — and rebases onto
        committed state coherently.

    Dispatch serialization is not a scaling loss: the dispatch stage is
    GIL-bound Python, so two workers' dispatches could not run
    concurrently anyway — the win is that their drain fetches (GIL
    released) and build stages interleave on a chain that stays
    coherent.

    On a sharded mesh the tail is a :class:`kernels.MeshChain` — the
    node-sharded usage PLUS a lead-device pending winner ring — not a
    plain array. The arbiter treats it opaquely: ``shape`` drives the
    resize/epoch rebase checks, publish/acquire hand it through, and a
    rebase simply drops it (committed state lives in the node tensor;
    the ring's placements either committed through plans or are being
    redelivered). Consumers that need real rows (eviction overlays,
    the monolithic-scan fallback, numpy readers) call
    ``materialize()``, which folds the ring into the sharded usage."""

    _concurrency = guarded_by(
        "_cond", "_tail", "_tail_epoch", "_holder", "_pending",
        "_windows_since_rebase", "_dirty", "_taint_seq", "_published_seq",
        "_settled_seq")

    def __init__(self, nt: NodeTensor, rebase_windows: int = REBASE_WINDOWS):
        self.nt = nt
        self.rebase_windows = rebase_windows
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._tail = None            # usage_after of the last dispatched window
        self._tail_epoch = -1        # nt.row_epoch the tail was validated at
        self._holder: Optional[str] = None  # window mid-dispatch (lease out)
        self._pending = 0            # published windows not yet finished
        self._windows_since_rebase = 0
        self._dirty = False          # tail carries phantom usage: rebase next
        self._taint_seq = 0
        # Chain-order finish barrier: windows SETTLE (make their phantom-
        # usage quarantine decision) in publish order, across workers.
        self._published_seq = 0      # windows published so far
        self._settled_seq = 0        # highest contiguously settled window
        self._drained = threading.Event()  # pending == 0 (across all workers)
        self._drained.set()

    # ------------------------------------------------------------- leasing
    def acquire(self, stop: Optional[threading.Event] = None,
                holder: str = "", drain_timeout: float = 60.0) -> ChainLease:
        """Take the window lease, waiting out any other worker's dispatch.

        Rebase decisions (all previously per-worker, now global): a dirty
        or depth-limited tail waits out EVERY in-flight window — any
        worker's — before restarting from committed state; an epoch/shape
        mismatch or a fully drained pipeline rebases immediately
        (committed state is strictly fresher once everything landed).
        The drain wait is bounded: a wedged window must not wedge every
        worker, and rebasing onto committed state early is always safe —
        the plan applier re-verifies every placement."""
        nt = self.nt
        with self._cond:
            while self._holder is not None:
                if stop is not None and stop.is_set():
                    raise RuntimeError("chain arbiter: worker stopping")
                self._cond.wait(0.1)
            self._holder = holder or "window"
            dirty = self._dirty
            self._dirty = False
            chain = self._tail
            if chain is not None and dirty:
                # Phantom usage baked into the tail: wait the in-flight
                # windows out (their commits land in the host mirror),
                # then restart from committed state.
                self._wait_drained_locked(stop, drain_timeout)
                chain = None
            if chain is not None and (chain.shape[0] != nt.n_rows
                                      or self._tail_epoch != nt.row_epoch):
                # Table resized OR a row changed identity (node removed /
                # freed row reused): the chain may carry a departed
                # node's usage on a row that now belongs to someone else.
                chain = None
            if chain is not None \
                    and self._windows_since_rebase >= self.rebase_windows:
                # Bound chain drift: drain the pipeline, then restart.
                self._wait_drained_locked(stop, drain_timeout)
                chain = None
            if chain is not None and self._pending == 0:
                # Pipeline is empty: everything this chain carries has
                # committed into the host mirror, so committed state is
                # strictly fresher (it also includes slow-path/fallback
                # commits the chain missed).
                chain = None
            rebased = self._tail is not None and chain is None
            if chain is None:
                self._tail = None
                self._windows_since_rebase = 0
            return ChainLease(chain=chain, taint_seq=self._taint_seq,
                              epoch=nt.row_epoch, rebased=rebased)

    def publish(self, lease: ChainLease, usage_after) -> None:
        """Install the dispatched window's usage tail and count it in
        flight; releases the dispatch lease."""
        with self._cond:
            if lease.released:
                return
            lease.released = True
            self._published_seq += 1
            lease.seq = self._published_seq
            self._tail = usage_after
            self._tail_epoch = lease.epoch
            self._windows_since_rebase += 1
            self._pending += 1
            self._drained.clear()
            self._holder = None
            self._cond.notify_all()

    def abort(self, lease: ChainLease) -> None:
        """Release the dispatch lease without publishing (the window had
        no fast evals, or dispatch failed before any kernel launched).
        One-shot like publish: a double release must not free a lease
        another worker has since acquired."""
        with self._cond:
            if lease.released:
                return
            lease.released = True
            self._holder = None
            self._cond.notify_all()

    # ------------------------------------------------------ window lifetime
    def finish_window(self) -> bool:
        """A published window fully finished (built, acked or nacked).
        Returns True when that drained the pipeline across ALL workers."""
        with self._cond:
            self._pending = max(0, self._pending - 1)
            drained = self._pending == 0
            if drained:
                self._drained.set()
                self._cond.notify_all()
            return drained

    def taint(self) -> None:
        """A window ended with stale/fallback records: its chained kernel
        placements never commit as dispatched. Windows in flight on the
        tainted tail detect this via the sequence bump; the next acquire
        sees the dirty flag and rebases."""
        with self._cond:
            self._taint_seq += 1
            self._dirty = True

    def taint_changed(self, seq: int) -> bool:
        with self._cond:
            return self._taint_seq != seq

    def wait_turn(self, seq: int, stop: Optional[threading.Event] = None,
                  timeout: float = 60.0) -> bool:
        """Block until every window published BEFORE chain position `seq`
        has SETTLED — made its phantom-usage quarantine decision and
        raised any taint. One build thread per worker settles its own
        windows in order, but with N workers a window chained on another
        worker's tail can otherwise finish first and consult the taint
        sequence before the tail owner raises it — parking squeezed evals
        as blocked on capacity that was never really taken. Bounded: a
        wedged predecessor must not wedge every worker, and proceeding
        early only risks the (rare, logged) missed-quarantine the barrier
        normally closes."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._settled_seq < seq - 1:
                if stop is not None and stop.is_set():
                    return False
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(min(remaining, 0.1))
            return True

    def mark_settled(self, seq: int) -> None:
        """The window at chain position `seq` made its taint decision;
        successors may now make theirs. Idempotent (the build loop's
        finally re-marks windows _finish_fast already settled)."""
        with self._cond:
            if seq > self._settled_seq:
                self._settled_seq = seq
                self._cond.notify_all()

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        """Block until no window is in flight (quiesce for tests/bench)."""
        return self._drained.wait(timeout)

    def wait_dispatch_idle(self, timeout: float) -> bool:
        """Park until no window is mid-dispatch (the lease is free),
        WITHOUT acquiring: a worker waits its turn BEFORE dequeuing evals
        it could not launch anyway. Dequeue-then-wait holds those evals
        hostage through the other worker's dispatch — their deadlines
        burn and the storm splinters into one-eval windows. The lease is
        only held during dispatch, so a worker parked here still wakes in
        time to dispatch while the previous window's drain/build (the
        device RTT and plan-applier wait) run lease-free."""
        with self._cond:
            deadline = time.monotonic() + timeout
            while self._holder is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(min(remaining, 0.05))
            return True

    @property
    def pending(self) -> int:
        with self._cond:
            return self._pending

    @property
    def dirty(self) -> bool:
        with self._cond:
            return self._dirty

    def _wait_drained_locked(self, stop: Optional[threading.Event],
                             timeout: float) -> None:
        """Wait (bounded, stop-aware) for pending == 0 with _lock held.
        Proceeding before fully drained is safe — it only rebases onto
        committed state while windows are still landing, which the plan
        applier's re-verification already tolerates."""
        deadline = time.monotonic() + timeout
        while self._pending > 0:
            if stop is not None and stop.is_set():
                return
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            self._cond.wait(min(remaining, 0.1))


def _explicit(device: torch.device) -> torch.device:
    """`cuda` without an index is the current card."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def resolve_device(device) -> torch.device:
    """The table's device. A CUDA device on a machine without CUDA raises:
    the port never switches devices behind the caller's back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            f"device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


class _StagingRing:
    """The refresh chunks' host staging: _STAGING_SLOTS buffers of the
    largest chunk, pinned for a CUDA table (K4b reads them in place) and
    pageable for a CPU one, with an event per slot recorded after the
    kernel that reads it. `take` hands out the next slot once its previous
    kernel has completed; `done` records the slot's event. Used under the
    table lock. A kernel may still read a slot when the ring is dropped, so
    its finalizer waits on every event before the buffers go back to
    PyTorch's host allocator (which records no event for a kernel's
    reads)."""

    def __init__(self, device: torch.device):
        cuda = device.type == "cuda"
        self.device = device
        self.bufs = [torch.empty((_REFRESH_CHUNKS[-1], _REFRESH_WIDTH),
                                 dtype=torch.float32, pin_memory=cuda)
                     for _ in range(_STAGING_SLOTS)]
        self.views = [b.numpy() for b in self.bufs]
        self.events = ([torch.cuda.Event() for _ in self.bufs] if cuda
                       else None)
        self._next = 0
        # The finalizer's arguments keep the buffers alive until it ran.
        weakref.finalize(self, _StagingRing._settle, self.events,
                         self.bufs).atexit = False

    def take(self) -> int:
        slot = self._next
        self._next = (slot + 1) % len(self.bufs)
        if self.events is not None:
            self.events[slot].synchronize()
        return slot

    def done(self, slot: int) -> None:
        """Record the slot's event behind the kernel just launched on it
        (on the stream every kernel of the port uses)."""
        if self.events is not None:
            self.events[slot].record(torch.cuda.current_stream(self.device))

    @staticmethod
    def _settle(events, bufs) -> None:
        for ev in events or ():
            ev.synchronize()


def scatter_refresh_plain(capacity: torch.Tensor, score_cap: torch.Tensor,
                          usage: torch.Tensor, packed: torch.Tensor) -> None:
    """K4b's plain version: split one packed refresh block
    [k, 1 + R + 2 + R] f32 = (row, capacity, score_cap, usage) and set those
    rows of the three tables in place (reference: _scatter_refresh). Rows
    outside [0, n) drop, as the reference's scatter drops rows past the
    table. Repeated padding rows carry identical values, so duplicates are
    benign."""
    native.PLAIN_CALLS["scatter_refresh"] += 1
    r = capacity.shape[1]
    rows = packed[:, 0].to(torch.int64)
    keep = (rows >= 0) & (rows < capacity.shape[0])
    packed, rows = packed[keep], rows[keep]
    capacity[rows] = packed[:, 1:1 + r]
    score_cap[rows] = packed[:, 1 + r:3 + r]
    usage[rows] = packed[:, 3 + r:]


def scatter_refresh(capacity: torch.Tensor, score_cap: torch.Tensor,
                    usage: torch.Tensor, packed: torch.Tensor) -> None:
    """K4b (csrc/refresh.cu): one launch sets the capacity, score_cap and
    usage rows of a packed refresh block in place. CPU tables run the plain
    version. CUDA tables launch the kernel, which reads the block on the
    card or, in place, from pinned host memory (16-byte aligned); a
    pageable host block raises, as does a failed launch. The caller keeps a
    pinned block unchanged and alive until an event recorded after this
    call has completed."""
    device = capacity.device
    devices = {t.device for t in (capacity, score_cap, usage)}
    if len(devices) != 1:
        raise ValueError(f"scatter_refresh tables span devices {devices}")
    if device.type != "cuda":
        if packed.device != device:
            raise ValueError(f"scatter_refresh: block on {packed.device}, "
                             f"tables on {device}")
        scatter_refresh_plain(capacity, score_cap, usage, packed)
        return
    n, r = capacity.shape
    k = packed.shape[0]
    for t, shape in ((capacity, (n, r)), (score_cap, (n, 2)), (usage, (n, r)),
                     (packed, (k, 2 * r + 3))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"scatter_refresh: want contiguous f32 {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    addr = native.device_address(packed, device)
    if addr % 16:
        raise ValueError("scatter_refresh: the packed block must be 16-byte "
                         "aligned")
    err = native.library().nomad_scatter_refresh(
        addr, k, n, r, capacity.data_ptr(), score_cap.data_ptr(),
        usage.data_ptr(), native.stream(device))
    native.check("scatter_refresh", err)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _grow2(a: np.ndarray, n: int, fill: float = 0.0) -> np.ndarray:
    out = np.full((n, a.shape[1]), fill, dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def _grow1(a: np.ndarray, n: int, fill) -> np.ndarray:
    out = np.full(n, fill, dtype=a.dtype)
    out[: a.shape[0]] = a
    return out
