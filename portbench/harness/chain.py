"""The record of the pipelined workers' usage chain that the score check
needs: each dispatched window's evaluations in the order the kernels
chained them, its place in the chain, whether it started from committed
usage, the raft indexes around its read of that usage, and the nodes the
kernels chose for each evaluation as the window read them back.

The program keeps this in `ChainArbiter` and the `_WindowWork` it hands
from dispatch to drain, and publishes none of it. So the run wraps each
worker's `_dispatch_window`, `_drain_window` and `_finish_fast` and reads
what they were given and returned; each calls through unchanged, and
nothing of the program is switched or set. A window that starts from
committed usage (its lease carries no chain) reads the node table's usage
once, in `NodeTensor.device_snapshot`, which the run wraps as well: the
usage it read is the state store's at some raft index between the two
read around that call (around the whole dispatch where the call was not
seen).

The chosen nodes, not the committed ones, are what the chain carries: an
evaluation that the worker re-runs on its exact path (its plan did not
commit as placed, or it was redelivered mid-window) leaves its kernels'
placements in the usage that the windows chained after it read. Those
evaluations are noted once their window has finished.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Set


class Window:
    __slots__ = ("seq", "based", "index_lo", "index_hi", "evals")

    def __init__(self, seq: int, based: bool, index_lo: int, index_hi: int,
                 evals: List[str]):
        self.seq = seq              # chain position (ChainArbiter.publish)
        self.based = based          # started from committed usage
        self.index_lo = index_lo    # raft index read before the usage read
        self.index_hi = index_hi    # and after it
        self.evals = evals          # fast evaluations in chain order


class ChainRecord:
    def __init__(self, server):
        self.windows: List[Window] = []
        # Evaluation -> the nodes its kernels chose, one per placement.
        self.chosen: Dict[str, List[str]] = {}
        self.rerun: Set[str] = set()
        self._lock = threading.Lock()
        self._local = threading.local()
        self._server = server
        nt = server.tindex.nt
        self._nt = nt
        self._node_of: Dict[int, str] = {}
        nt.device_snapshot = self._wrap_snapshot(nt.device_snapshot)
        for worker in server.workers:
            if not hasattr(worker, "_dispatch_window"):
                continue
            worker._dispatch_window = self._wrap(worker._dispatch_window)
            worker._drain_window = self._wrap_drain(worker._drain_window)
            worker._finish_fast = self._wrap_finish(worker._finish_fast)

    def _index(self) -> int:
        return self._server.fsm.state.latest_index()

    def _wrap(self, dispatch):
        def recorded(batch, lease=None):
            if lease is None:
                return dispatch(batch, lease)
            based = lease.chain is None
            self._local.read = None
            lo = self._index()
            try:
                work = dispatch(batch, lease)
            finally:
                read, self._local.read = self._local.read, None
            hi = self._index()
            if read is not None:
                lo, hi = read
            if work is not None and work.published:
                win = Window(work.chain_seq, based, lo, hi,
                             [rec.ev.ID for rec in work.fast])
                with self._lock:
                    self.windows.append(win)
            return work
        return recorded

    def _wrap_snapshot(self, snapshot):
        def recorded(skip_usage=False):
            if skip_usage or getattr(self._local, "read", 0) is not None:
                return snapshot(skip_usage)
            lo = self._index()
            out = snapshot(skip_usage)
            self._local.read = (lo, self._index())
            return out
        return recorded

    def _wrap_drain(self, drain):
        def recorded(work):
            out = drain(work)
            got = {}
            for rec, cr in zip(work.fast, out):
                if cr is not None:
                    got[rec.ev.ID] = [self._node(int(r))
                                      for r in cr.chosen if r >= 0]
            with self._lock:
                self.chosen.update(got)
            return out
        return recorded

    def _wrap_finish(self, finish):
        def recorded(work):
            failed = True
            try:
                out = finish(work)
                failed = False
                return out
            finally:
                rerun = [rec.ev.ID for rec in work.fast
                         if failed or rec.fallback or rec.stale]
                with self._lock:
                    self.rerun.update(rerun)
        return recorded

    def _node(self, row: int) -> str:
        nid = self._node_of.get(row)
        if nid is None:
            self._node_of = {r: n for n, r in dict(self._nt.row_of).items()}
            nid = self._node_of.get(row, "")
        return nid

    def ordered(self) -> List[Window]:
        with self._lock:
            return sorted(self.windows, key=lambda w: w.seq)
