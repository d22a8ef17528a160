"""The one generator of arrivals: when each request of a traffic mix is
due, from the mix's parameters and the seed.

- `{"process": "closed", "outstanding": n, "clients": c}`: a closed loop
  of c submitters that keep n requests outstanding between them; a
  request is due when a slot frees.
- `{"process": "poisson", "rate_per_s": r}`: an open loop of Poisson
  arrivals at r a second. Every seed gets the same set of gaps (the
  exponential distribution's quantiles at (k + 1/2) / n for the n =
  round(r * seconds) arrivals of the window) in its own order, so the
  work is the same for every seed and only the order of the gaps moves.
- `{"process": "uniform", "rate_per_s": r}`: an open loop of n =
  round(r * seconds) arrivals at equal gaps, the k-th due at
  (k + 1/2) * seconds / n, the same for every seed.

An open loop's `clients` is the number of senders: a request goes out
when it is due by the first sender that is free, whatever the earlier
ones still wait for.
"""

from __future__ import annotations

import math
import random
from typing import List, Optional


def schedule(arrivals: dict, seconds: float,
             rng: random.Random) -> Optional[List[float]]:
    """Due offsets from the window's start, in seconds; None for a closed
    loop."""
    process = arrivals["process"]
    if process == "closed":
        return None
    n = max(1, round(arrivals["rate_per_s"] * seconds))
    if process == "uniform":
        return [(k + 0.5) * seconds / n for k in range(n)]
    if process != "poisson":
        raise ValueError(f"unknown arrival process {process!r}")
    gaps = [-math.log(1.0 - (k + 0.5) / n) for k in range(n)]
    rng.shuffle(gaps)
    scale = seconds * n / (n + 1) / sum(gaps)
    out, t = [], 0.0
    for g in gaps:
        t += g * scale
        out.append(t)
    return out
