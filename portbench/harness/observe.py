"""What the benchmark watches from the client's side: evaluations turning
complete on the port's event stream, the committed allocation changes,
the program's metric samples, and the benchmark's own spans."""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

# Frames a subscription holds before it drops its oldest: more than a run
# commits, so nothing is dropped (a drop is counted and fails the run).
QUEUE_FRAMES = 1 << 24


class EvalWatch:
    """Records the first moment each evaluation is seen `complete` (or
    `failed`/`cancelled`) on the Eval topic, by a thread blocked on the
    subscription (no polling), and wakes whoever waits on `cond`."""

    TERMINAL = ("complete", "failed", "cancelled")

    def __init__(self, broker):
        self.sub = broker.subscribe(topics=["Eval"],
                                    from_index=broker.stats()["Tail"],
                                    queue_size=QUEUE_FRAMES)
        self.broker = broker
        self.done: Dict[str, float] = {}
        self.status: Dict[str, str] = {}
        self.order: List[str] = []          # terminal evaluations, in turn
        self.cond = threading.Condition()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="portbench-evals")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            frame = self.sub.next(timeout=0.2)
            if frame is None:
                continue
            now = time.monotonic()
            fresh = False
            for ev in frame["Events"]:
                p = ev["Payload"]
                status = p.get("Status")
                if status in self.TERMINAL and p["ID"] not in self.done:
                    self.done[p["ID"]] = now
                    self.status[p["ID"]] = status
                    self.order.append(p["ID"])
                    fresh = True
            if fresh:
                with self.cond:
                    self.cond.notify_all()

    def wait_all(self, eval_ids, deadline: float) -> List[str]:
        """Wait until every id is terminal or the deadline passes; returns
        those still open."""
        with self.cond:
            while True:
                left = [e for e in eval_ids if e not in self.done]
                if not left or time.monotonic() >= deadline:
                    return left
                self.cond.wait(min(0.5, max(0.0, deadline - time.monotonic())))

    def close(self) -> int:
        self._stop.set()
        self._thread.join(timeout=5)
        self.broker.unsubscribe(self.sub)
        return self.sub.dropped_total


class CommitLog:
    """Holds every committed allocation change in raft order (the Alloc and
    AllocationBatch topics) until the run reads them once its window has
    closed: the subscription's queue is the record, nothing reads it
    inside the window."""

    def __init__(self, broker):
        self.broker = broker
        self.sub = broker.subscribe(topics=["Alloc", "AllocationBatch"],
                                    from_index=broker.stats()["Tail"],
                                    queue_size=QUEUE_FRAMES)

    def drain(self) -> List[dict]:
        frames = []
        while True:
            frame = self.sub.next(timeout=0)
            if frame is None:
                break
            frames.append(frame)
        return frames

    def close(self) -> int:
        self.broker.unsubscribe(self.sub)
        return self.sub.dropped_total


class SampleSink:
    """A metrics sink (MetricsRegistry.add_sink) that sums the program's
    timing samples by key while it is recording."""

    def __init__(self):
        self.recording = False
        self.sums: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def set_gauge(self, key, value) -> None:
        pass

    def incr_counter(self, key, value) -> None:
        pass

    def add_sample(self, key, value) -> None:
        if self.recording:
            name = ".".join(key)
            self.sums[name] = self.sums.get(name, 0.0) + value
            self.counts[name] = self.counts.get(name, 0) + 1


class Spans:
    """The benchmark's own spans around its calls into the program: host
    milliseconds by name, and, when a profiler runs, the same spans as
    `torch.profiler.record_function` ranges on the trace's clock."""

    def __init__(self, torch=None):
        self.torch = torch
        self.recording = False
        self.ms: Dict[str, List[float]] = {}

    @contextmanager
    def span(self, name: str):
        rf = (self.torch.profiler.record_function(f"portbench.{name}")
              if self.torch is not None else None)
        if rf is not None:
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = (time.perf_counter() - t0) * 1e3
            if rf is not None:
                rf.__exit__(None, None, None)
            if self.recording:
                self.ms.setdefault(name, []).append(dt)


def quantile(values, q: float) -> Optional[float]:
    """The q-quantile by linear interpolation between order statistics."""
    if not values:
        return None
    xs = sorted(values)
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
