"""The result's line: the cell's metrics, the device, and the check."""

from __future__ import annotations

import sys
from typing import Dict, List

FORBIDDEN = ("jax", "jaxlib", "flax", "nomad_tpu")


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name, compared
    whole, is JAX's, jaxlib's, flax's or the JAX package's."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def end_to_end(name: str, out: dict):
    """The benchmark's own end-to-end metrics, taken by the host's clock
    from the client's side of the server's entry points."""
    m = out["measured"]
    if name == "setup_s":
        return out["setup_s"]
    if name == "placements_per_s":
        return m.placements / m.span_s
    if name == "eval_latency_p50_ms":
        return m.p(0.5)
    if name == "eval_latency_p95_ms":
        return m.p(0.95)
    raise KeyError(f"no end-to-end metric {name!r}")


def summary(cell, seed: int, out: dict, card: str) -> str:
    """One line for standard error: the set-up's parts, the window, the
    check's coverage and the workers' counters."""
    m = out["measured"]
    gen = out["gen"]["late_ms"]
    replay, chain = out["replay"], out["run"].chain
    return (
        f"portbench: {cell.name} seed {seed} on {card}: "
        f"set-up {out['setup_s']:.3f} s ("
        + ", ".join(f"{k} {v:.3f}" for k, v in out["setup_parts"])
        + " s), "
        f"log store {out['run'].cluster.log_store_name}, "
        f"window {out['window_s']:.3f} s, {len(m.completed)} evaluations "
        f"complete in it, {m.placements} placements, {m.attempted} due; "
        f"generator late p50/max "
        f"{(sorted(gen)[len(gen) // 2] if gen else 0):.3f}/"
        f"{(max(gen) if gen else 0):.3f} ms; check {out['t_check']:.3f} s "
        f"over {out['n_frames']} commit frames; "
        f"{out['numbers'].get('gaps_read', 0)} placements scored, "
        f"{replay.gaps_skipped} on rows changed during a usage read left "
        f"out, {replay.evals_unscored} sampled evaluations unscored; chain "
        f"{len(chain.windows)} windows, "
        f"{sum(w.based for w in chain.windows)} from committed usage, "
        f"{replay.readback_off} evaluations committed otherwise than read "
        f"back, {len(chain.rerun)} re-run; workers "
        + ", ".join(f"{k} {m.stats.get(k, 0):g}" for k in (
            "windows", "fast", "slow", "fallback", "stale", "rebases")))


def metrics(cell, out: dict, trace: bool) -> Dict[str, dict]:
    got = {}
    if not trace:
        for spec in cell.end_to_end:
            value = end_to_end(spec["name"], out)
            if value is not None:
                got[spec["name"]] = {"value": value, "unit": spec["unit"]}
        return got
    for spec in cell.per_layer:
        value = cell.readers[spec["name"]].read(out["measured"])
        if value is not None:
            got[spec["name"]] = {"value": value, "unit": spec["unit"]}
    return got


def line(cell, out: dict, trace: bool, ok: bool, checks: Dict[str, dict],
         device_kind: str, count: int) -> dict:
    """The result's line, its keys in the contract's order, with the
    check's numbers and limits last."""
    from . import devtrace

    m = out["measured"]
    got = {
        "correct": ok,
        "attempted": m.attempted,
        "failed": (out["numbers"]["open_evals"]
                   + out["numbers"]["failed_evals"]),
        "metrics": metrics(cell, out, trace),
        "device": {"platform": "gpu", "kind": device_kind, "count": count,
                   "memory_peak_bytes": out["memory_peak"]},
    }
    if trace:
        got["device"]["busy_s"] = out["traced"]["busy_s"]
        got["device"]["window_s"] = out["window_s"]
        got["breakdown"] = devtrace.breakdown(out["traced"])
    got["checks"] = checks
    return got
