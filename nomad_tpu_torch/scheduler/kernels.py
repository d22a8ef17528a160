"""Placement kernels: the scheduling hot path on the card (single device).

Ported from nomad_tpu/scheduler/kernels.py. The reference's jitted XLA
programs become hand-written CUDA kernels in `csrc/`:

  K1  `_score`              -> csrc/score.cuh (device function)
  K2  window-start score pass + per-key top-K  -> `score_topk`
  K3  candidate sort, dedup and trim           -> `merge_candidates`
  K4a sequential placement chain (scan and replay modes) -> `placement_chain`
  K5  a window's results compacted for the host copy -> `compact_window`
  K6-K10 the shard-local keyed mesh pipeline (csrc/mesh.cu): `mesh_pack`,
      `apply_ring`, `cold_packets` (one shard: `cold_packet`), `pool_build`,
      `warm_finish`, composed by `_MeshKeyedProgram` with K2-K4a into
      `_place_batch_keyed_mesh`

`place_batch`, `place_batch_multi` and `place_batch_keyed` keep the
reference's signatures and output layout and are built from those stages.
Each stage wrapper runs its plain PyTorch version (`*_plain`, beside it) when
its tensors lie on the CPU, and launches its kernel on a CUDA tensor or
raises. Within `native.plain_versions()` the composites run every stage's
plain version on whatever device the tensors are on: a comparison run,
never the default.

Scoring matches reference funcs.go:102-137 (including its Inf/NaN division
edges) with the job anti-affinity penalty applied after clamping (reference:
rank.go:242-304). Selection is a global argmax that breaks ties to the lowest
row; host-supplied per-node noise stands in for the reference's node shuffle.

`penalty` and `distinct_hosts` are host scalars here (the reference shipped
them as device arrays): a kernel takes them as launch arguments.
"""

from __future__ import annotations

import functools
import threading
import time
from collections import OrderedDict
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from nomad_tpu_torch import native
from nomad_tpu_torch.resilience import failpoints

_LOG2_10 = float(np.log2(10.0))
_NEG_INF = float("-inf")


class PlacementResult(NamedTuple):
    packed: torch.Tensor       # [P, 3] f32: (chosen row or -1, score, n_feasible)
    usage_after: torch.Tensor  # [N, R] usage including the new placements

    # One packed array so the host reads a result back in one copy.
    @property
    def chosen(self):
        return self.packed[:, 0].to(torch.int32)

    @property
    def scores(self):
        return self.packed[:, 1]

    @property
    def n_feasible(self):
        return self.packed[:, 2].to(torch.int32)


class CompactResult(NamedTuple):
    """Host-side per-eval view of a result: exactly the arrays the plan
    build consumes, in the dtypes it consumes them."""

    chosen: np.ndarray   # [P_pad] int32 chosen row per placement (-1 = none)
    scores: np.ndarray   # [P_pad] f32 winning score per placement
    nf_last: int         # n_feasible of the eval's LAST valid placement
    ok: bool             # every valid placement found a row


def _score(usage2: torch.Tensor, score_cap: torch.Tensor) -> torch.Tensor:
    """K1's plain version. BestFit-v3: 20 - 10^freeCpuPct - 10^freeMemPct,
    clamped to [0, 18]; usage2 [..., 2] is proposed (cpu, mem) utilization
    including reserved, score_cap [..., 2] capacity minus reserved. Division
    by zero follows IEEE (Inf/NaN) like the Go reference; NaN becomes 0.
    One eager op per step, each rounded once: csrc/score.cuh rounds the same
    way."""
    free_pct = 1.0 - usage2 / score_cap
    total = (torch.exp2(free_pct[..., 0] * _LOG2_10)
             + torch.exp2(free_pct[..., 1] * _LOG2_10))
    score = torch.clamp(20.0 - total, 0.0, 18.0)
    return torch.nan_to_num(score, nan=0.0, posinf=18.0, neginf=0.0)


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True when the stage must launch its kernel. Mixed devices raise."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs span devices {sorted(map(str, devices))}")
    return next(iter(devices)).type == "cuda"


def _need(t: torch.Tensor, dtype: torch.dtype, shape: tuple, name: str):
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _u8(t: torch.Tensor) -> torch.Tensor:
    """A bool tensor as the uint8 bytes a kernel reads (same storage)."""
    return t.view(torch.uint8)


# ---------------------------------------------------------------- K2


def score_topk_plain(capacity, score_cap, usage, tg_masks, job_counts0,
                     key_demands, noise, penalty: float, distinct: bool,
                     banned0, k_cand: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Window-start masked score per (key, row) and each key's top-K rows.

    Returns (masked0 [T, N] f32, nf0 [T] int32, cand [T, min(K, N)] int32),
    cand ordered by (score desc, row asc) as lax.top_k orders it, -inf
    entries included. torch.topk promises no tie order, so this sorts on
    the score with a stable sort, which keeps equal scores in row order."""
    native.PLAIN_CALLS["score_topk"] += 1
    fits0 = (capacity[None] - usage[None] >= key_demands[:, None, :]).all(-1)
    ok0 = fits0 & tg_masks
    if distinct:
        ok0 = ok0 & ~banned0[None, :]
    util2 = usage[None, :, :2] + key_demands[:, None, :2]
    score = _score(util2, score_cap[None])
    score = (score - job_counts0.to(torch.float32)[None, :] * penalty
             + noise[None, :])
    masked0 = torch.where(ok0, score, _NEG_INF)
    nf0 = ok0.sum(dim=1).to(torch.int32)
    kc = min(k_cand, masked0.shape[1])
    order = torch.sort(masked0, dim=1, descending=True, stable=True).indices
    return masked0, nf0, order[:, :kc].to(torch.int32).contiguous()


def score_topk(capacity, score_cap, usage, tg_masks, job_counts0,
               key_demands, noise, penalty: float, distinct: bool, banned0,
               k_cand: int):
    """K2. See score_topk_plain for the contract."""
    if not _on_cuda(capacity, score_cap, usage, tg_masks, job_counts0,
                    key_demands, noise, banned0):
        return score_topk_plain(capacity, score_cap, usage, tg_masks,
                                job_counts0, key_demands, noise, penalty,
                                distinct, banned0, k_cand)
    n, r = capacity.shape
    t = key_demands.shape[0]
    _need(capacity, torch.float32, (n, r), "capacity")
    _need(score_cap, torch.float32, (n, 2), "score_cap")
    _need(usage, torch.float32, (n, r), "usage")
    _need(tg_masks, torch.bool, (t, n), "tg_masks")
    _need(job_counts0, torch.int32, (n,), "job_counts0")
    _need(key_demands, torch.float32, (t, r), "key_demands")
    _need(noise, torch.float32, (n,), "noise")
    _need(banned0, torch.bool, (n,), "banned0")
    kc = min(k_cand, n)
    dev = capacity.device
    masked0 = torch.empty((t, n), dtype=torch.float32, device=dev)
    nf0 = torch.empty(t, dtype=torch.int32, device=dev)
    unordered = torch.empty((t, kc), dtype=torch.int32, device=dev)
    cand = torch.empty((t, kc), dtype=torch.int32, device=dev)
    lib = native.library()
    work = torch.empty(lib.nomad_select_work_bytes(t), dtype=torch.uint8,
                       device=dev)
    p = native.ptr
    err = lib.nomad_score_topk(
        p(capacity), p(score_cap), p(usage), p(_u8(tg_masks)), p(job_counts0),
        p(key_demands), p(noise), p(_u8(banned0)), float(penalty),
        int(bool(distinct)), n, r, t, kc, p(masked0), p(nf0), p(unordered),
        p(cand), p(work), native.stream(dev))
    native.check("score_topk", err)
    return masked0, nf0, cand


# ---------------------------------------------------------------- K3


def _first_occurrence(rows_sorted: torch.Tensor) -> torch.Tensor:
    keep = torch.ones_like(rows_sorted, dtype=torch.bool)
    keep[1:] = rows_sorted[1:] != rows_sorted[:-1]
    return keep


def merge_candidates_plain(cand: torch.Tensor, masked0: torch.Tensor,
                           k_cand: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate rows sorted by row (stable: copies keep key-major order)
    with a first-occurrence keep mask; when T * K_trim < n_cand, each key
    keeps only its global top-K (duplicates scoring -inf), and the kept set
    is re-sorted and its keep mask rebuilt from scratch (reference:
    kernels.py:484-494). Returns (rows [C] int32, keep [C] bool)."""
    native.PLAIN_CALLS["merge_candidates"] += 1
    flat = cand.reshape(-1).to(torch.int64)
    rows_s = flat[torch.sort(flat, stable=True).indices]
    keep = _first_occurrence(rows_s)
    n_keys = masked0.shape[0]
    n_cand = flat.shape[0]
    k_trim = min(k_cand, n_cand)
    if n_keys * k_trim < n_cand:
        masked0c = torch.where(keep[None, :], masked0[:, rows_s], _NEG_INF)
        tidx = torch.sort(masked0c, dim=1, descending=True,
                          stable=True).indices[:, :k_trim]
        sel = tidx.reshape(-1)
        sel = sel[torch.sort(rows_s[sel], stable=True).indices]
        rows_s = rows_s[sel]
        keep = _first_occurrence(rows_s)
    return rows_s.to(torch.int32), keep


_K3_TILE = 1024   # keys a block of K3 sorts (csrc/keyed.cu kTileKeys)


def merge_candidates(cand: torch.Tensor, masked0: torch.Tensor, k_cand: int):
    """K3. See merge_candidates_plain for the contract."""
    if not _on_cuda(cand, masked0):
        return merge_candidates_plain(cand, masked0, k_cand)
    n_keys, n = masked0.shape
    n_cand = cand.numel()
    _need(cand, torch.int32, tuple(cand.shape), "cand")
    _need(masked0, torch.float32, (n_keys, n), "masked0")
    k_trim = min(k_cand, n_cand)
    trim = n_keys * k_trim < n_cand
    dev = cand.device
    # Outputs and scratch as views of one buffer per dtype (the wrapper's
    # host time is mostly tensor creation). Without the trim (every path of
    # the port) the u64 scratch holds the sorted 1,024-key tiles; the
    # trim's one-block merge sorts in shared memory up to 4,096 keys.
    if trim:
        n_out = n_keys * k_trim
        n_pow2 = 1 << max(0, (n_cand - 1).bit_length())
        n_keys64 = n_pow2 if n_pow2 > 4096 else 0
        rows_all, sel, rows_out = torch.empty(
            n_cand + 2 * n_out, dtype=torch.int32, device=dev).split(
                [n_cand, n_out, n_out])
        keep_all, keep_out = torch.empty(
            n_cand + n_out, dtype=torch.bool, device=dev).split(
                [n_cand, n_out])
    else:
        n_keys64 = -(-n_cand // _K3_TILE) * _K3_TILE
        rows_out = torch.empty(n_cand, dtype=torch.int32, device=dev)
        keep_out = torch.empty(n_cand, dtype=torch.bool, device=dev)
        rows_all = keep_all = sel = None
    gbuf = (torch.empty(n_keys64, dtype=torch.int64, device=dev)
            if n_keys64 else None)
    p = native.ptr
    err = native.library().nomad_merge_candidates(
        p(cand), p(masked0), n, n_keys, n_cand, k_trim, int(trim), p(gbuf),
        p(rows_all), p(_u8(keep_all)) if trim else None, p(sel),
        p(rows_out), p(_u8(keep_out)), native.stream(dev))
    native.check("merge_candidates", err)
    return rows_out, keep_out


# --------------------------------------------------------------- K4a


def placement_chain_plain(capacity, score_cap, usage, tg_masks, job_counts0,
                          demands, tg_ids, valid, noise, penalty: float,
                          distinct: bool, banned0, reset=None, rows=None,
                          keep=None, masked0=None, nf0=None,
                          winners: bool = False):
    """The sequential placement chain, one step per placement.

    Scan mode (rows is None): the table is every node row and demands is
    [P, R] per placement (reference: _make_step, place_batch,
    place_batch_multi with `reset`). Replay mode: the table is the merged
    candidates (rows, keep from merge_candidates), demands is the [T, R]
    key demand, zeroed on padding steps, n_feasible is nf0[t] + sum(ok) -
    sum(ok at window start), and the final usage is a scatter-SET of the
    candidates' chained usage (reference: kernels.py:508-560).
    Returns (packed [P, 3] f32, usage_after [N, R] f32); with winners=True
    (replay mode) also each step's argmax table index [P] int32, found or
    not, and the candidates' final chained usage [C, R] (the mesh's warm
    step reads its ring delta from them, reference: kernels.py:957-959)."""
    native.PLAIN_CALLS["placement_chain"] += 1
    replay = rows is not None
    steps_t = tg_ids.tolist()
    steps_v = valid.tolist()
    steps_r = reset.tolist() if reset is not None else [False] * len(steps_t)
    if replay:
        idx = rows.to(torch.int64)
        t_cap, t_sc, t_noise = capacity[idx], score_cap[idx], noise[idx]
        t_elig = tg_masks[:, idx]
        cnt0, ban0 = job_counts0[idx], banned0[idx]
        t_use = usage[idx]
        ok0 = (masked0[:, idx] != _NEG_INF) & keep[None, :]   # [T, C]
        ok0_sum = ok0.sum(dim=1)
        # Per-step key demand, zeroed on padding steps (reference kd_p).
        step_d = (demands[tg_ids.to(torch.int64)]
                  * valid[:, None].to(torch.float32))
    else:
        t_cap, t_sc, t_noise, t_elig = capacity, score_cap, noise, tg_masks
        cnt0, ban0 = job_counts0, banned0
        t_use = usage.clone()
        step_d = demands
    c_cnt, c_ban = cnt0.clone(), ban0.clone()
    packed = torch.empty((len(steps_t), 3), dtype=torch.float32,
                         device=usage.device)
    win = torch.empty(len(steps_t), dtype=torch.int32, device=usage.device)
    neg_inf = torch.tensor(_NEG_INF, dtype=torch.float32, device=usage.device)
    for j, (t, v, r) in enumerate(zip(steps_t, steps_v, steps_r)):
        if r:
            c_cnt, c_ban = cnt0.clone(), ban0.clone()
        d = step_d[j]
        ok = (t_cap - t_use >= d[None, :]).all(dim=1) & t_elig[t]
        if distinct:
            ok = ok & ~c_ban
        if replay:
            ok = ok & keep
        sc = _score(t_use[:, :2] + d[None, :2], t_sc)
        sc = sc - c_cnt.to(torch.float32) * penalty + t_noise
        m = torch.where(ok, sc, neg_inf)
        i = torch.argmax(m)
        win[j] = i
        found = ok[i] & bool(v)
        t_use[i] += d * found.to(torch.float32)
        c_cnt[i] += found.to(c_cnt.dtype)
        c_ban[i] |= found
        n_ok = ok.sum()
        nf = nf0[t] + n_ok - ok0_sum[t] if replay else n_ok
        row = rows[i] if replay else i
        packed[j, 0] = torch.where(found, row.to(torch.float32), -1.0)
        packed[j, 1] = torch.where(found, m[i], neg_inf)
        packed[j, 2] = nf.to(torch.float32)
    if replay:
        usage_after = usage.clone()
        usage_after[idx[keep]] = t_use[keep]
    else:
        usage_after = t_use
    if winners:
        return packed, usage_after, win, t_use
    return packed, usage_after


def placement_chain(capacity, score_cap, usage, tg_masks, job_counts0,
                    demands, tg_ids, valid, noise, penalty: float,
                    distinct: bool, banned0, reset=None, rows=None, keep=None,
                    masked0=None, nf0=None, winners: bool = False):
    """K4a. See placement_chain_plain for the contract."""
    if not _on_cuda(capacity, score_cap, usage, tg_masks, job_counts0,
                    demands, tg_ids, valid, noise, banned0):
        return placement_chain_plain(capacity, score_cap, usage, tg_masks,
                                     job_counts0, demands, tg_ids, valid,
                                     noise, penalty, distinct, banned0,
                                     reset, rows, keep, masked0, nf0,
                                     winners)
    n, r = capacity.shape
    t = tg_masks.shape[0]
    steps = tg_ids.shape[0]
    if r > 16:
        raise ValueError(f"placement_chain supports at most 16 resource "
                         f"dims, got {r}")
    _need(capacity, torch.float32, (n, r), "capacity")
    _need(score_cap, torch.float32, (n, 2), "score_cap")
    _need(usage, torch.float32, (n, r), "usage")
    _need(tg_masks, torch.bool, (t, n), "tg_masks")
    _need(job_counts0, torch.int32, (n,), "job_counts0")
    _need(tg_ids, torch.int32, (steps,), "tg_ids")
    _need(valid, torch.bool, (steps,), "valid")
    _need(noise, torch.float32, (n,), "noise")
    _need(banned0, torch.bool, (n,), "banned0")
    if reset is not None:
        _need(reset, torch.bool, (steps,), "reset")
    replay = rows is not None
    if winners and not replay:
        raise ValueError("placement_chain: winners needs replay mode")
    dev = capacity.device
    if replay:
        n_table = rows.shape[0]
        _need(demands, torch.float32, (t, r), "key_demands")
        _need(rows, torch.int32, (n_table,), "rows")
        _need(keep, torch.bool, (n_table,), "keep")
        _need(masked0, torch.float32, (t, n), "masked0")
        _need(nf0, torch.int32, (t,), "nf0")
        c_use = torch.empty((n_table, r), dtype=torch.float32, device=dev)
        ok0_sum = torch.empty(t, dtype=torch.int32, device=dev)
    else:
        n_table = n
        _need(demands, torch.float32, (steps, r), "demands")
        c_use = ok0_sum = None
    c_cnt = torch.empty(n_table, dtype=torch.int32, device=dev)
    c_ban = torch.empty(n_table, dtype=torch.uint8, device=dev)
    packed = torch.empty((steps, 3), dtype=torch.float32, device=dev)
    usage_out = torch.empty_like(usage)
    win = (torch.empty(steps, dtype=torch.int32, device=dev) if winners
           else None)
    lib = native.library()
    work_bytes = lib.nomad_placement_chain_work_bytes(n_table, steps, r)
    work = torch.empty(work_bytes, dtype=torch.uint8, device=dev)
    p = native.ptr
    err = lib.nomad_placement_chain(
        p(capacity), p(score_cap), p(usage), p(_u8(tg_masks)), p(job_counts0),
        p(_u8(banned0)), p(noise), p(demands), p(tg_ids), p(_u8(valid)),
        p(_u8(reset)) if reset is not None else None, float(penalty),
        int(bool(distinct)), n, r, t, steps, n_table, p(rows),
        p(_u8(keep)) if keep is not None else None, p(masked0), p(nf0),
        p(c_use), p(c_cnt), p(c_ban), p(ok0_sum), p(packed), p(usage_out),
        p(win), p(work), work_bytes, native.stream(dev))
    native.check("placement_chain", err)
    if winners:
        return packed, usage_out, win, c_use
    return packed, usage_out


# --------------------------------------------------------- composites


def place_batch(capacity, score_cap, usage, tg_masks, job_counts, demands,
                tg_ids, valid, noise, penalty, distinct_hosts,
                banned0) -> PlacementResult:
    """One evaluation's placements in order, each seeing the previous ones'
    usage, anti-affinity counts and bans (reference: kernels.place_batch,
    the monolithic scan; context.go:109-140 sequencing). K4a in scan mode."""
    chain = placement_chain_plain if native.plain_on_card else placement_chain
    packed, usage_after = chain(capacity, score_cap, usage, tg_masks,
                                job_counts, demands, tg_ids, valid, noise,
                                float(penalty), bool(distinct_hosts), banned0)
    return PlacementResult(packed, usage_after)


def place_batch_multi(capacity, score_cap, usage, tg_masks, job_counts0,
                      demands, tg_ids, valid, noise, penalty, distinct_hosts,
                      banned0, reset) -> PlacementResult:
    """One scan over a whole window of same-shaped evaluations: placements
    concatenated, with the per-job state (counts, bans) reset at each
    eval's first step (reference: kernels.place_batch_multi). K4a in scan
    mode with `reset`."""
    chain = placement_chain_plain if native.plain_on_card else placement_chain
    packed, usage_after = chain(capacity, score_cap, usage, tg_masks,
                                job_counts0, demands, tg_ids, valid, noise,
                                float(penalty), bool(distinct_hosts), banned0,
                                reset=reset)
    return PlacementResult(packed, usage_after)


def keyed_cand_count(n_valid: int) -> int:
    """Candidate budget for a window with n_valid real placements, padded
    to a power of two (at least 8)."""
    k = 8
    while k < n_valid:
        k *= 2
    return k


def place_batch_keyed(mesh, capacity, score_cap, usage, tg_masks,
                      job_counts0, key_demands, tg_ids, valid, noise,
                      penalty, distinct_hosts, banned0, reset,
                      n_valid: int) -> PlacementResult:
    """place_batch / place_batch_multi semantics via the keyed candidate
    program: one score pass per key and its top-K (K2), the candidate merge
    (K3), and the exact chain replayed over the candidates (K4a). key_demands
    is [T, R] with demands[p] == key_demands[tg_ids[p]] for every valid
    placement; n_valid (host-known) bounds the candidate sets.

    Exactness (reference: kernels.py:357-398): at step j every modified row
    is a prior winner, and the winner is either such a row or the best
    unmodified one, whose window-start rank for its key is at most j <= K.
    The replay recomputes scores from the same row data with the same f32
    operations, so valid placements are bit-identical to place_batch /
    place_batch_multi. On padding steps chosen is -1 and score -inf; their
    n_feasible is unspecified, as in the reference.

    A mesh of more than one shard runs the shard-local pipeline
    (`_place_batch_keyed_mesh`; `usage` may then be the previous window's
    MeshChain, keeping the chain shard-resident); None or a one-shard mesh
    runs the single-device program, folding a MeshChain first."""
    if mesh is not None and mesh.size > 1:
        return _place_batch_keyed_mesh(
            mesh, capacity, score_cap, usage, tg_masks, job_counts0,
            key_demands, tg_ids, valid, noise, penalty, distinct_hosts,
            banned0, reset, n_valid)
    if isinstance(usage, MeshChain):
        usage = usage.materialize()
    penalty = float(penalty)
    distinct = bool(distinct_hosts)
    k_cand = keyed_cand_count(n_valid)
    topk, merge, chain = ((score_topk_plain, merge_candidates_plain,
                           placement_chain_plain) if native.plain_on_card else
                          (score_topk, merge_candidates, placement_chain))
    masked0, nf0, cand = topk(capacity, score_cap, usage, tg_masks,
                              job_counts0, key_demands, noise, penalty,
                              distinct, banned0, k_cand)
    rows, keep = merge(cand, masked0, k_cand)
    packed, usage_after = chain(capacity, score_cap, usage, tg_masks,
                                job_counts0, key_demands, tg_ids, valid,
                                noise, penalty, distinct, banned0,
                                reset=reset, rows=rows, keep=keep,
                                masked0=masked0, nf0=nf0)
    return PlacementResult(packed, usage_after)


# ------------------------------------------------ shard-local mesh pipeline
# The mesh window is the reference's explicitly shard-local pipeline
# (nomad_tpu/scheduler/kernels.py:600-653), on the S logical shards of one
# card (parallel/mesh.py):
#
#   COLD window (chain start / rebuild): K7 applies the pending winner ring
#     to every shard's usage rows in one call (the shards share the card),
#     and per shard K8 runs one masked score pass over only the shard's rows
#     and emits the shard's top-B candidate packet
#     (B = 2k) with its per-key feasible count and top-B values. The packets
#     meet on the lead device (the exchange: a same-device copy here, the
#     failpoint `tensor.mesh.exchange` at its seam), and K9 merges them into
#     the resident candidate POOL: sorted by global row, first-occurrence
#     dedup, tau = max_s of each shard's B-th value, nf0 = sum_s nf0_s.
#   WARM window (every chained window after the first): on the lead device
#     against the pool only. K2 is the window-start pass over the pool taken
#     as a table, K3 sorts the selected pool indices and dedups them, K4a
#     replays the exact P-step chain over them, and K10 checks the exactness
#     certificate, updates nf0, translates pool indices to global rows and
#     appends the winner delta to the ring. A cold window ends with the same
#     warm step over its freshly built pool.
#
# Exactness (reference :641-653): winners only modify pool rows, so a row
# outside the pool still scores <= tau; the certificate per key
#     count(pool scores > tau) >= k   OR   pool holds every feasible row
# proves the true top-k lies in the pool, and the replay then matches the
# single-device keyed path bit for bit. A failed certificate raises the
# chain's FLAG; the pipelined worker nacks the window, taints the chain and
# redelivers it onto a cold window. Cold windows are exact by construction.
#
# The reference's warm windows need a `keep2 = first-occurrence & keep[sel]`
# mask (:886-887): a pool duplicate selected by one key must never win. Here
# the pool's eligibility columns are already ANDed with the pool's keep (K9),
# and K2 and K4a read them, so a duplicate is never feasible in the replay
# and its final scatter-SET writes back its unchanged usage.

_MESH_BUF_MULT = 2      # per-shard candidate buffer per key = mult * k
_MESH_RING_MULT = 16    # pending winner-row ring = mult * k_cand rows


class PoolState(NamedTuple):
    """The resident candidate pool of a mesh chain: K9's outputs. The first
    four are the reference pool_build's after its packed pool [C, W]; the
    rest are that pool's columns as K2 and K4a read a table (`pool_columns`
    builds them from the reference's pool)."""

    pool_use: torch.Tensor  # [C, R] f32 the rows' usage at the rebuild
    keep: torch.Tensor      # [C] bool first occurrence of each global row
    tau: torch.Tensor       # [T] f32 max over shards of the B-th value
    nf0: torch.Tensor       # [T] int32 feasible rows of the whole table
    rows: torch.Tensor      # [C] int32 global row
    cap: torch.Tensor       # [C, R] f32
    sc: torch.Tensor        # [C, 2] f32
    cnt: torch.Tensor       # [C] int32
    ban: torch.Tensor       # [C] bool
    noise: torch.Tensor     # [C] f32
    elig: torch.Tensor      # [T, C] bool eligibility AND keep


def pool_columns(pool: torch.Tensor, keep: torch.Tensor, r_dims: int,
                 n_keys: int) -> dict:
    """The pool's table columns from its packet rows (plain PyTorch):
    [row, capacity(R), score_cap(2), usage(R), counts, banned, noise,
    eligibility(T)]."""
    r = r_dims
    return dict(
        rows=pool[:, 0].to(torch.int32),
        cap=pool[:, 1:1 + r].contiguous(),
        sc=pool[:, 1 + r:3 + r].contiguous(),
        cnt=pool[:, 3 + 2 * r].to(torch.int32),
        ban=pool[:, 4 + 2 * r] > 0.5,
        noise=pool[:, 5 + 2 * r].contiguous(),
        elig=((pool[:, 6 + 2 * r:6 + 2 * r + n_keys] > 0.5)
              & keep[:, None]).T.contiguous())


# ---------------------------------------------------------------- K6


def mesh_pack_plain(capacity, score_cap, job_counts0, noise, banned0):
    """The node-static columns as ONE packed table [N, R + 5] f32 =
    [capacity(R), score_cap(2), counts, noise, banned] (reference:
    _MeshKeyedProgram.pack_fn), so the cold stage reads two arrays (table
    and usage) per candidate instead of seven."""
    native.PLAIN_CALLS["mesh_pack"] += 1
    return torch.cat([capacity, score_cap,
                      job_counts0.to(torch.float32)[:, None], noise[:, None],
                      banned0.to(torch.float32)[:, None]], dim=1)


def mesh_pack(capacity, score_cap, job_counts0, noise, banned0):
    """K6 (csrc/mesh.cu). See mesh_pack_plain for the contract."""
    if not _on_cuda(capacity, score_cap, job_counts0, noise, banned0):
        return mesh_pack_plain(capacity, score_cap, job_counts0, noise,
                               banned0)
    n, r = capacity.shape
    _need(capacity, torch.float32, (n, r), "capacity")
    _need(score_cap, torch.float32, (n, 2), "score_cap")
    _need(job_counts0, torch.int32, (n,), "job_counts0")
    _need(noise, torch.float32, (n,), "noise")
    _need(banned0, torch.bool, (n,), "banned0")
    table = torch.empty((n, r + 5), dtype=torch.float32,
                        device=capacity.device)
    p = native.ptr
    err = native.library().nomad_mesh_pack(
        p(capacity), p(score_cap), p(job_counts0), p(noise), p(_u8(banned0)),
        n, r, p(table), native.stream(capacity.device))
    native.check("mesh_pack", err)
    return table


# ---------------------------------------------------------------- K7


def apply_ring_plain(usage, ring, row_base: int, out=None, pos=None):
    """Usage rows [row_base, row_base + n) [n, R] with the pending winner
    ring [cap, 1+R] applied (reference: _apply_ring): one shard's rows, or
    every shard's with row_base 0, which equals the per-shard applications
    laid end to end (a ring entry's row belongs to one shard). Ring entries
    carry each window's FINAL usage of the row (row -1 marks an empty
    entry), so the LAST entry per owned row wins: a scatter-max of ring
    positions picks it. Writes `out` (a new tensor when None) and returns
    it. `pos` is K7's scratch (see apply_ring); the plain version needs
    none."""
    native.PLAIN_CALLS["apply_ring"] += 1
    n_loc = usage.shape[0]
    row_f = ring[:, 0]
    drow = row_f.to(torch.int64) - row_base
    own = (row_f >= 0) & (drow >= 0) & (drow < n_loc)
    iota = torch.arange(ring.shape[0], device=ring.device)
    pos = torch.full((n_loc + 1,), -1, dtype=torch.int64, device=ring.device)
    pos.scatter_reduce_(0, torch.where(own, drow, n_loc), iota, "amax")
    last = own & (pos[drow.clamp(0, max(n_loc - 1, 0))] == iota)
    res = usage.clone()
    res[drow[last]] = ring[last, 1:]
    if out is None:
        return res
    out.copy_(res)
    return out


def apply_ring(usage, ring, row_base: int, out=None, pos=None):
    """K7 (csrc/mesh.cu). See apply_ring_plain for the contract. `pos` is
    the kernel's row -> last ring entry scratch, int32 [n], -1 in every
    entry; K7 leaves it so (its write pass puts back what its mark pass
    set), so a caller that keeps one pays no fill (the mesh program keeps
    one, and no two calls that share it may run at once). None: a new
    one."""
    if not _on_cuda(usage, ring, out, pos):
        return apply_ring_plain(usage, ring, row_base, out)
    n, r = usage.shape
    _need(usage, torch.float32, (n, r), "usage")
    _need(ring, torch.float32, (ring.shape[0], r + 1), "ring")
    if out is None:
        out = torch.empty_like(usage)
    _need(out, torch.float32, (n, r), "out")
    dev = usage.device
    if pos is None:
        pos = torch.full((n,), -1, dtype=torch.int32, device=dev)
    _need(pos, torch.int32, (n,), "pos")
    err = native.library().nomad_apply_ring(
        usage.data_ptr(), ring.data_ptr(), ring.shape[0], r, int(row_base),
        n, pos.data_ptr(), out.data_ptr(), native.stream(dev))
    native.check("apply_ring", err)
    return out


# ---------------------------------------------------------------- K8


def _cold_shard(table, usage, tg_masks, key_demands, penalty: float,
                distinct: bool, row_base: int, b_buf: int):
    """cold_packet_plain's body, uncounted (see there)."""
    r = usage.shape[1]
    capacity = table[:, :r]
    score_cap = table[:, r:r + 2]
    counts = table[:, r + 2]
    noise = table[:, r + 3]
    banned0 = table[:, r + 4] > 0.5
    fits0 = (capacity[None] - usage[None] >= key_demands[:, None, :]).all(-1)
    ok0 = fits0 & tg_masks
    if distinct:
        ok0 = ok0 & ~banned0[None, :]
    util2 = usage[None, :, :2] + key_demands[:, None, :2]
    score = _score(util2, score_cap[None])
    score = score - counts[None, :] * penalty + noise[None, :]
    masked0 = torch.where(ok0, score, _NEG_INF)
    nf0 = ok0.sum(dim=1).to(torch.int32)
    idx = torch.sort(masked0, dim=1, descending=True,
                     stable=True).indices[:, :b_buf]
    vals = torch.gather(masked0, 1, idx)
    flat = idx.reshape(-1)
    pkt = torch.cat([
        (flat + row_base).to(torch.float32)[:, None],
        capacity[flat], score_cap[flat], usage[flat],
        counts[flat][:, None], banned0[flat].to(torch.float32)[:, None],
        noise[flat][:, None], tg_masks[:, flat].T.to(torch.float32)], dim=1)
    return pkt, nf0, vals


def cold_packet_plain(table, usage, tg_masks, key_demands, penalty: float,
                      distinct: bool, row_base: int, b_buf: int):
    """One shard's cold stage after its ring apply (reference: a_cold):
    the masked window-start score per key over the shard's n_loc rows, read
    from the packed table; nf0 [T] int32 (feasible rows); the top-B rows per
    key by (score desc, row asc) as lax.top_k orders them; and the packet
    [T*B, 6 + 2R + T] f32 = [global row, capacity, score_cap, usage, counts,
    banned, noise, eligibility per key] with the top-B values [T, B] f32.
    tg_masks is the shard's column slice [T, n_loc] of the [T, N] masks."""
    native.PLAIN_CALLS["cold_packet"] += 1
    return _cold_shard(table, usage, tg_masks, key_demands, penalty,
                       distinct, row_base, b_buf)


def cold_packets_plain(table, usage, tg_masks, key_demands, penalty: float,
                       distinct: bool, n_shards: int, b_buf: int):
    """The cold stage of all S logical shards in one call: the per-shard
    cold_packet_plain of every shard s (rows [s n_loc, (s+1) n_loc) of the
    [N, ...] inputs, row_base s n_loc) laid end to end in the exchange's
    layout. Returns (packets [S*T*B, W] in (shard, key, b) order, nf_all
    [S, T] int32, vals_all [S, T, B] f32)."""
    native.PLAIN_CALLS["cold_packet"] += 1
    n_loc = usage.shape[0] // n_shards
    outs = [_cold_shard(table[q * n_loc:(q + 1) * n_loc],
                        usage[q * n_loc:(q + 1) * n_loc],
                        tg_masks[:, q * n_loc:(q + 1) * n_loc], key_demands,
                        penalty, distinct, q * n_loc, b_buf)
            for q in range(n_shards)]
    return (torch.cat([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]),
            torch.stack([o[2] for o in outs]))


def cold_select_work(device: torch.device, n_shards: int,
                     n_keys: int) -> torch.Tensor:
    """K8's select scratch for S shards of T keys (S*T segments): every
    call initializes what it reads, so one buffer serves any number of
    calls that run one after another."""
    n = native.library().nomad_select_work_bytes(n_shards * n_keys)
    return torch.empty(n, dtype=torch.uint8, device=device)


def _cold_launch(table, usage, tg_masks, key_demands, penalty: float,
                 distinct: bool, n_shards: int, row_base: int, b_buf: int,
                 work):
    """K8 over S = n_shards shards of the [S n_loc, ...] inputs: (pkt
    [S*T*B, W], nf_all [S, T], vals [S, T, B]), packet rows carrying
    row_base + their row."""
    n, r = usage.shape
    t = key_demands.shape[0]
    _need(table, torch.float32, (n, r + 5), "table")
    _need(usage, torch.float32, (n, r), "usage")
    _need(key_demands, torch.float32, (t, r), "key_demands")
    if (tg_masks.dtype != torch.bool or tuple(tg_masks.shape) != (t, n)
            or tg_masks.stride(1) != 1):
        raise ValueError(f"tg_masks: want bool ({t}, {n}) with unit row "
                         f"stride, got {tg_masks.dtype} "
                         f"{tuple(tg_masks.shape)} {tg_masks.stride()}")
    if n_shards < 1 or n % n_shards:
        raise ValueError(f"cold_packet: {n} rows in {n_shards} shards")
    n_loc = n // n_shards
    if not 1 <= b_buf <= n_loc:
        raise ValueError(f"cold_packet: B = {b_buf} outside [1, {n_loc}]")
    dev = usage.device
    w = 6 + 2 * r + t
    n_seg = n_shards * t
    # Outputs and scratch as views of one buffer per dtype: the wrapper's
    # host time is mostly tensor creation.
    pkt, vals, masked0 = torch.empty(
        n_seg * b_buf * (w + 1) + t * n, dtype=torch.float32,
        device=dev).split([n_seg * b_buf * w, n_seg * b_buf, t * n])
    nf_all, nf_sel, unordered, cand = torch.empty(
        n_seg * (2 + 2 * b_buf), dtype=torch.int32, device=dev).split(
            [n_seg, n_seg, n_seg * b_buf, n_seg * b_buf])
    if work is None:
        work = cold_select_work(dev, n_shards, t)
    p = native.ptr
    err = native.library().nomad_cold_packet(
        p(table), p(usage), p(_u8(tg_masks)), tg_masks.stride(0),
        p(key_demands), float(penalty), int(bool(distinct)), n_loc, n_shards,
        r, t, b_buf, int(row_base), p(masked0), p(nf_sel), p(unordered),
        p(cand), p(pkt), p(nf_all), p(vals), p(work), native.stream(dev))
    native.check("cold_packet", err)
    return (pkt.view(n_seg * b_buf, w), nf_all.view(n_shards, t),
            vals.view(n_shards, t, b_buf))


def cold_packet(table, usage, tg_masks, key_demands, penalty: float,
                distinct: bool, row_base: int, b_buf: int):
    """K8 (csrc/mesh.cu) on one shard: the all-shard entry at S = 1 with a
    row_base (the form a mesh over several cards would call per card). See
    cold_packet_plain for the contract."""
    if not _on_cuda(table, usage, tg_masks, key_demands):
        return cold_packet_plain(table, usage, tg_masks, key_demands, penalty,
                                 distinct, row_base, b_buf)
    pkt, nf_all, vals = _cold_launch(table, usage, tg_masks, key_demands,
                                     penalty, distinct, 1, row_base, b_buf,
                                     None)
    return pkt, nf_all[0], vals[0]


def cold_packets(table, usage, tg_masks, key_demands, penalty: float,
                 distinct: bool, n_shards: int, b_buf: int, work=None):
    """K8 (csrc/mesh.cu) over all S logical shards in one call. See
    cold_packets_plain for the contract. `work` is the select's scratch
    (cold_select_work(device, S, T)); the mesh program keeps one and
    launches under its lock, since two calls' launches sharing it must not
    interleave. None: a new one."""
    if not _on_cuda(table, usage, tg_masks, key_demands, work):
        return cold_packets_plain(table, usage, tg_masks, key_demands,
                                  penalty, distinct, n_shards, b_buf)
    return _cold_launch(table, usage, tg_masks, key_demands, penalty,
                        distinct, n_shards, 0, b_buf, work)


# ---------------------------------------------------------------- K9

def pool_build_plain(cand, nf_all, vals_all, key_demands) -> PoolState:
    """The exchanged packets [S*T*B, W] merged into the resident pool
    (reference: pool_build): a stable sort by global row, first-occurrence
    keep (copies of a row are identical), pool_use, tau = max_s vals[s, :,
    B-1], nf0 = sum_s nf_all[s] (int32), and the pool's table columns."""
    native.PLAIN_CALLS["pool_build"] += 1
    r, t = key_demands.shape[1], key_demands.shape[0]
    rows_g = cand[:, 0].to(torch.int32)
    order = torch.sort(rows_g, stable=True).indices
    pool = cand[order]
    keep = _first_occurrence(rows_g[order])
    tau = vals_all[:, :, -1].max(dim=0).values
    nf0 = nf_all.sum(dim=0).to(torch.int32)
    pool_use = pool[:, 3 + r:3 + 2 * r].contiguous()
    return PoolState(pool_use, keep, tau, nf0,
                     **pool_columns(pool, keep, r, t))


def pool_build(cand, nf_all, vals_all, key_demands) -> PoolState:
    """K9 (csrc/mesh.cu). See pool_build_plain for the contract. The
    packets are S*T segments of B rows (one per shard and key, as the
    exchange lays them); K9's merge is exact whatever rows they hold."""
    if not _on_cuda(cand, nf_all, vals_all, key_demands):
        return pool_build_plain(cand, nf_all, vals_all, key_demands)
    t, r = key_demands.shape
    s, _, b_buf = vals_all.shape
    c, w = cand.shape
    _need(cand, torch.float32, (s * t * b_buf, 6 + 2 * r + t), "cand")
    _need(nf_all, torch.int32, (s, t), "nf_all")
    _need(vals_all, torch.float32, (s, t, b_buf), "vals_all")
    dev = cand.device
    ld = 1 << max(0, (b_buf - 1).bit_length())
    skeys = torch.empty(s * t * ld, dtype=torch.int64, device=dev)
    # The outputs as views of one buffer per dtype: the wrapper's host time
    # is mostly tensor creation, and three allocations cost less than
    # eleven.
    pool_use, cap, sc, noise, tau = torch.empty(
        2 * c * r + 3 * c + t, dtype=torch.float32, device=dev).split(
            [c * r, c * r, 2 * c, c, t])
    rows, cnt, nf0 = torch.empty(2 * c + t, dtype=torch.int32,
                                 device=dev).split([c, c, t])
    keep, ban, elig = torch.empty((2 + t) * c, dtype=torch.bool,
                                  device=dev).split([c, c, t * c])
    out = PoolState(pool_use=pool_use.view(c, r), keep=keep, tau=tau,
                    nf0=nf0, rows=rows, cap=cap.view(c, r), sc=sc.view(c, 2),
                    cnt=cnt, ban=ban, noise=noise, elig=elig.view(t, c))
    # A bool tensor's data_ptr is the bytes the kernel writes.
    err = native.library().nomad_pool_build(
        cand.data_ptr(), s * t, b_buf, w, nf_all.data_ptr(),
        vals_all.data_ptr(), s, t, r, skeys.data_ptr(),
        *[x.data_ptr() for x in out], native.stream(dev))
    native.check("pool_build", err)
    return out


# --------------------------------------------------------------- K10


def warm_finish_plain(masked0, n_fin, packed_loc, win, c_use, pool_rows, cap,
                      pool_use2, elig, ban, key_demands, distinct: bool, tau,
                      nf0, ring, ring_n: int, k_sel: int):
    """The warm step's end after K2 (masked0 [T, C], n_fin [T] over the
    pool), K3 and K4a (packed_loc [P, 3] in pool indices, win [P], c_use
    [n_sel, R], pool_use2 [C, R]) (reference: warm_step :870-878, :942-962):
    the exactness flag (0-dim f32: 1.0 when a key is certified neither by k
    pool scores above tau nor by the pool holding all nf0 feasible rows),
    nf0_2 = nf0 + sum(ok after) - sum(ok before) over the pool, packed with
    global rows, and the ring with the [P, 1+R] winner delta written at
    ring_n (clamped so it fits, as dynamic_update_slice clamps).
    Returns (packed, nf0_2, ring2, flag)."""
    native.PLAIN_CALLS["warm_finish"] += 1
    steps = packed_loc.shape[0]
    if steps > ring.shape[0]:
        raise ValueError(f"warm_finish: {steps} steps exceed the ring's "
                         f"{ring.shape[0]} rows")
    above = (masked0 > tau[:, None]).sum(dim=1)
    exact = (above >= k_sel) | (n_fin >= nf0)
    flag = (~exact).any().to(torch.float32)
    fits_f = (cap[None] - pool_use2[None]
              >= key_demands[:, None, :]).all(-1)            # [T, C]
    ok_f = fits_f & elig
    if distinct:
        ok_f = ok_f & ~ban[None, :]
    nf0_2 = (nf0 + (ok_f.sum(dim=1) - n_fin)).to(torch.int32)
    loc = packed_loc[:, 0]
    rows_g = torch.where(
        loc >= 0, pool_rows[loc.clamp(min=0).to(torch.int64)].to(
            torch.float32), -1.0)
    packed = packed_loc.clone()
    packed[:, 0] = rows_g
    delta = torch.cat([rows_g[:, None], c_use[win.to(torch.int64)]], dim=1)
    start = min(max(int(ring_n), 0), ring.shape[0] - steps)
    ring2 = ring.clone()
    ring2[start:start + steps] = delta
    return packed, nf0_2, ring2, flag


def warm_finish(masked0, n_fin, packed_loc, win, c_use, pool_rows, cap,
                pool_use2, elig, ban, key_demands, distinct: bool, tau, nf0,
                ring, ring_n: int, k_sel: int):
    """K10 (csrc/mesh.cu). See warm_finish_plain for the contract."""
    if not _on_cuda(masked0, n_fin, packed_loc, win, c_use, pool_rows, cap,
                    pool_use2, elig, ban, key_demands, tau, nf0, ring):
        return warm_finish_plain(masked0, n_fin, packed_loc, win, c_use,
                                 pool_rows, cap, pool_use2, elig, ban,
                                 key_demands, distinct, tau, nf0, ring,
                                 ring_n, k_sel)
    t, c = masked0.shape
    r = cap.shape[1]
    steps = packed_loc.shape[0]
    ring_rows = ring.shape[0]
    _need(masked0, torch.float32, (t, c), "masked0")
    _need(n_fin, torch.int32, (t,), "n_fin")
    _need(packed_loc, torch.float32, (steps, 3), "packed_loc")
    _need(win, torch.int32, (steps,), "win")
    _need(c_use, torch.float32, (c_use.shape[0], r), "c_use")
    _need(pool_rows, torch.int32, (c,), "pool_rows")
    _need(cap, torch.float32, (c, r), "cap")
    _need(pool_use2, torch.float32, (c, r), "pool_use2")
    _need(elig, torch.bool, (t, c), "elig")
    _need(ban, torch.bool, (c,), "ban")
    _need(key_demands, torch.float32, (t, r), "key_demands")
    _need(tau, torch.float32, (t,), "tau")
    _need(nf0, torch.int32, (t,), "nf0")
    _need(ring, torch.float32, (ring_rows, r + 1), "ring")
    if steps > ring_rows:
        raise ValueError(f"warm_finish: {steps} steps exceed the ring's "
                         f"{ring_rows} rows")
    dev = masked0.device
    # The outputs as views of one buffer per dtype, ring2 first so that it
    # starts 16-byte aligned; a new ring, never the old one updated (a
    # window whose certificate fails is re-run from the old ring).
    n_ring = ring.numel()
    fbuf = torch.empty(n_ring + 3 * steps + 1, dtype=torch.float32,
                       device=dev)
    ring2 = fbuf[:n_ring].view(ring_rows, r + 1)
    packed = fbuf[n_ring:n_ring + 3 * steps].view(steps, 3)
    flag = fbuf[-1]
    nf0_2 = torch.empty(t, dtype=torch.int32, device=dev)
    vec = int(ring.data_ptr() % 16 == 0 and n_ring % 4 == 0)
    p = native.ptr
    err = native.library().nomad_warm_finish(
        p(masked0), p(n_fin), p(packed_loc), p(win), p(c_use), p(pool_rows),
        p(cap), p(pool_use2), p(_u8(elig)), p(_u8(ban)), p(key_demands),
        int(bool(distinct)), p(tau), p(nf0), p(ring), ring_rows, int(ring_n),
        c, t, r, steps, int(k_sel), p(packed), p(nf0_2), p(ring2), p(flag),
        p(_k10_scratch(dev, t)), vec, native.stream(dev))
    native.check("warm_finish", err)
    return packed, nf0_2, ring2, flag


# K10's per-key counts and ticket, one zeroed buffer per device that every
# call leaves zeroed (its last block puts it back), so no call fills it.
# The port launches on one stream a device, which orders the calls that
# share it.
_K10_SCRATCH = {}
_K10_SCRATCH_LOCK = threading.Lock()


def _k10_scratch(dev: torch.device, n_keys: int) -> torch.Tensor:
    with _K10_SCRATCH_LOCK:
        buf = _K10_SCRATCH.get(dev)
        if buf is None or buf.numel() < 2 * n_keys + 1:
            buf = torch.zeros(max(64, 2 * n_keys + 1), dtype=torch.int32,
                              device=dev)
            _K10_SCRATCH[dev] = buf
        return buf


# ------------------------------------------------------- the pipeline


class MeshChain:
    """Opaque usage-chain tail of the keyed mesh pipeline (reference:
    kernels.MeshChain).

    `usage` is the node-sharded usage EXCLUDING every window since the last
    rebuild; those winners live in `ring` (on the lead device) until the
    next cold window scatters them into their owning shards. `pool` (a
    PoolState), `pool_use` and `nf0` are the lead-device candidate state
    warm windows run against; `sig` pins the static inputs the warm path may
    assume unchanged (tensor identity and the host scalars; `refs` keeps the
    tensors alive). `flag` is a warm window's exactness certificate (a
    0-dim tensor, None for cold windows, which are exact by construction).
    Everything is device state: building a MeshChain never waits on the
    card."""

    __slots__ = ("prog", "usage", "ring", "ring_n", "pool", "pool_use", "nf0",
                 "flag", "sig", "refs", "exchange_bytes")

    def __init__(self, prog, usage, ring, ring_n, pool, pool_use, nf0, flag,
                 sig, refs, exchange_bytes):
        self.prog = prog
        self.usage = usage
        self.ring = ring
        self.ring_n = ring_n
        self.pool = pool
        self.pool_use = pool_use
        self.nf0 = nf0
        self.flag = flag
        self.sig = sig
        self.refs = refs
        self.exchange_bytes = exchange_bytes

    @property
    def shape(self):
        # The ChainArbiter's shape/epoch validation sees the chain like a
        # plain usage tensor.
        return self.usage.shape

    def materialize(self) -> torch.Tensor:
        """Full usage including the pending winner ring (one K7 call)."""
        return self.prog.apply_fn(self.usage, self.ring)

    def __array__(self, dtype=None, copy=None):
        arr = self.materialize().cpu().numpy()
        return arr.astype(dtype) if dtype is not None else arr


class _MeshKeyedProgram:
    """The stages of one (mesh, k_cand) bucket, each a composite over the
    kernels K2-K4a and K6-K10 (their plain versions inside
    `native.plain_versions()`). Packet rows use the single-device program's
    column layout: [row, capacity(R), score_cap(2), usage(R), counts,
    banned, noise, eligibility(T)]."""

    def __init__(self, mesh, k_cand: int):
        n = mesh.size
        if n & (n - 1):
            raise ValueError(f"scheduling mesh needs a power-of-two shard "
                             f"count, got {n}")
        self.mesh = mesh
        self.device = mesh.one_device()
        self.dev0 = mesh.dev0
        self.n_shards = n
        self.k_cand = k_cand
        self.ring_cap = _MESH_RING_MULT * k_cand
        # The memos are shared by every thread that places on this mesh (a
        # worker's window dispatch and another's per-eval slow path).
        self._lock = threading.Lock()
        self._tables: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._ring_zero: dict = {}
        self._ring_pos: dict = {}
        self._cold_work: dict = {}

    # Each stage picks kernels or, for a comparison run, plain versions.
    @staticmethod
    def _k(kernel, plain):
        return plain if native.plain_on_card else kernel

    def pack_fn(self, capacity, score_cap, job_counts0, noise, banned0):
        return self._k(mesh_pack, mesh_pack_plain)(
            capacity, score_cap, job_counts0, noise, banned0)

    def table(self, capacity, score_cap, job_counts0, noise, banned0):
        """The packed table for these inputs, memoized by tensor identity
        (one K6 launch per signature change; the memo keeps them alive)."""
        refs = (capacity, score_cap, job_counts0, noise, banned0)
        key = tuple(map(id, refs))
        with self._lock:
            hit = self._tables.get(key)
            if hit is not None:
                self._tables.move_to_end(key)
                return hit[1]
            table = self.pack_fn(*refs)
            self._tables[key] = (refs, table)
            while len(self._tables) > 64:
                self._tables.popitem(last=False)
            return table

    def ring_zero(self, r_dims: int) -> torch.Tensor:
        """The empty ring [ring_cap, 1 + R] (every row -1) on the lead
        device; shared, never written (K10 writes a new ring)."""
        with self._lock:
            ring = self._ring_zero.get(r_dims)
            if ring is None:
                ring = _ring_zero(self.ring_cap, r_dims, self.dev0)
                self._ring_zero[r_dims] = ring
            return ring

    def a_cold(self, table, usage, tg_masks, key_demands, penalty: float,
               distinct: bool, ring):
        """The cold shard-local stage (reference: a_cold under shard_map):
        K7 applies the ring to every shard's usage rows in one call (into
        the new usage tail: the shards share one device, and a ring entry's
        row belongs to one shard), then one K8 call scores every shard's
        rows of that tail and emits each shard's packet from its own rows
        only. Returns (packets [S*T*B, W], usage tail [N, R], nf0 [S, T],
        top-B values [S, T, B]): the exchange's layout, on the mesh's
        device. K8's select scratch is the program's, one per S*T, used
        under its lock as K7's is."""
        n = usage.shape[0]
        n_loc = n // self.n_shards
        b_buf = min(_MESH_BUF_MULT * self.k_cand, n_loc)
        usage_tail = self.apply_fn(usage, ring)
        args = (table, usage_tail, tg_masks, key_demands.to(self.device),
                penalty, distinct, self.n_shards, b_buf)
        if native.plain_on_card:
            cand, nf_all, vals_all = cold_packets_plain(*args)
        else:
            n_seg = self.n_shards * key_demands.shape[0]
            with self._lock:
                work = None
                if usage_tail.is_cuda:
                    work = self._cold_work.get(n_seg)
                    if work is None:
                        work = cold_select_work(self.device, self.n_shards,
                                                key_demands.shape[0])
                        self._cold_work[n_seg] = work
                cand, nf_all, vals_all = cold_packets(*args, work=work)
        return cand, usage_tail, nf_all, vals_all

    def exchange(self, cand, nf_all, vals_all):
        """The winner-row exchange: the packets [S*T*B, W], feasible counts
        [S, T] and top-B values [S, T, B], already in the exchange's layout,
        to the lead device (no copy on logical shards of one card)."""
        dev0 = self.dev0
        return cand.to(dev0), nf_all.to(dev0), vals_all.to(dev0)

    def pool_build(self, cand, nf_all, vals_all, key_demands) -> PoolState:
        return self._k(pool_build, pool_build_plain)(cand, nf_all, vals_all,
                                                     key_demands)

    def warm_step(self, pool: PoolState, pool_use, nf0, ring, ring_n: int,
                  key_demands, tg_ids, valid, reset, penalty: float,
                  distinct: bool):
        """One window against the resident pool on the lead device
        (reference: warm_step): K2's window-start pass over the pool as a
        table, K3's sorted, deduped selection of each key's top k_sel, K4a's
        exact replay over it, and K10. Returns (packed [P, 3], pool_use2,
        nf0_2, ring2, flag)."""
        topk, merge, chain, finish = (
            (score_topk_plain, merge_candidates_plain, placement_chain_plain,
             warm_finish_plain) if native.plain_on_card else
            (score_topk, merge_candidates, placement_chain, warm_finish))
        k_sel = min(self.k_cand, pool.rows.shape[0])
        masked0, n_fin, cand = topk(pool.cap, pool.sc, pool_use, pool.elig,
                                    pool.cnt, key_demands, pool.noise,
                                    penalty, distinct, pool.ban, self.k_cand)
        sel, keep_sel = merge(cand, masked0, self.k_cand)
        packed_loc, pool_use2, win, c_use = chain(
            pool.cap, pool.sc, pool_use, pool.elig, pool.cnt, key_demands,
            tg_ids, valid, pool.noise, penalty, distinct, pool.ban,
            reset=reset, rows=sel, keep=keep_sel, masked0=masked0, nf0=nf0,
            winners=True)
        packed, nf0_2, ring2, flag = finish(
            masked0, n_fin, packed_loc, win, c_use, pool.rows, pool.cap,
            pool_use2, pool.elig, pool.ban, key_demands, distinct, pool.tau,
            nf0, ring, ring_n, k_sel)
        return packed, pool_use2, nf0_2, ring2, flag

    def apply_fn(self, usage, ring) -> torch.Tensor:
        """Every shard's usage with the ring applied, as a new [N, R]
        tensor (reference: apply_ring_full under shard_map): one K7 call
        over all shards' rows, which share the mesh's one device. K7's
        scratch is the program's, made once per row count; the lock keeps
        one call's two launches from interleaving with another thread's
        on the stream, since both would use it."""
        n = usage.shape[0]
        with self._lock:
            pos = self._ring_pos.get(n)
            if pos is None:
                pos = torch.full((n,), -1, dtype=torch.int32,
                                 device=self.device)
                self._ring_pos[n] = pos
            return self._k(apply_ring, apply_ring_plain)(
                usage, ring.to(self.device), 0, pos=pos)


@functools.lru_cache(maxsize=16)
def _mesh_keyed_program(mesh, k_cand: int) -> _MeshKeyedProgram:
    return _MeshKeyedProgram(mesh, k_cand)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _place_batch_keyed_mesh(mesh, capacity, score_cap, usage, tg_masks,
                            job_counts0, key_demands, tg_ids, valid, noise,
                            penalty, distinct_hosts, banned0, reset,
                            n_valid: int) -> PlacementResult:
    """One window of the shard-local mesh pipeline (reference:
    _place_batch_keyed_mesh). `usage` is a plain tensor (cold window) or
    the previous window's MeshChain: warm when the chain's static inputs
    are the same tensors (and host scalars) and its ring has room for this
    window; anything else rebuilds cold, applying the chain's pending ring
    on the way when the k bucket still matches."""
    k_cand = keyed_cand_count(n_valid)
    prog = _mesh_keyed_program(mesh, k_cand)
    p_pad = tg_ids.shape[0]
    r_dims = key_demands.shape[1]
    penalty = float(penalty)
    distinct = bool(distinct_hosts)
    refs = (capacity, score_cap, tg_masks, job_counts0, noise, banned0,
            key_demands)
    sig = tuple(map(id, refs)) + (penalty, distinct, k_cand, mesh)
    table = prog.table(capacity, score_cap, job_counts0, noise, banned0)

    chain = usage if isinstance(usage, MeshChain) else None
    warm = (chain is not None and chain.prog is prog and chain.sig == sig
            and chain.ring_n + p_pad <= prog.ring_cap)

    t0 = time.perf_counter()
    exchange_ms = 0.0
    exchange_bytes = 0
    poisoned = False
    if warm:
        pool, pool_use, nf0 = chain.pool, chain.pool_use, chain.nf0
        ring, ring_n = chain.ring, chain.ring_n
        usage_tail = chain.usage
    else:
        if chain is not None and chain.prog is prog:
            # Same bucket: the cold stage applies the chain's pending ring
            # while rebuilding, no materialize pass.
            base, ring0 = chain.usage, chain.ring
        elif chain is not None:
            base, ring0 = chain.materialize(), prog.ring_zero(r_dims)
        else:
            base, ring0 = usage, prog.ring_zero(r_dims)
        pkts, usage_tail, nfs, vals = prog.a_cold(
            table, base, tg_masks, key_demands, penalty, distinct, ring0)
        # The winner-row exchange seam (reference :1108-1119): `error` and
        # `delay` surface here at dispatch; `drop` simulates a silently lost
        # exchange by poisoning the chain's exactness certificate, so the
        # failure surfaces at the drain-stage certificate check, which nacks
        # the window, taints the chain and redelivers exactly once.
        poisoned = failpoints.fire("tensor.mesh.exchange") == "drop"
        cand, nf_all, vals_all = prog.exchange(pkts, nfs, vals)
        exchange_bytes = _nbytes(cand, nf_all, vals_all)
        pool = prog.pool_build(cand, nf_all, vals_all, key_demands)
        pool_use, nf0 = pool.pool_use, pool.nf0
        ring, ring_n = prog.ring_zero(r_dims), 0
        # Cold rebuild + exchange launch time only: warm windows exchange
        # nothing, so their dispatch must not inflate the metric.
        exchange_ms = (time.perf_counter() - t0) * 1e3

    packed, pool_use2, nf0_2, ring2, flag = prog.warm_step(
        pool, pool_use, nf0, ring, ring_n, key_demands, tg_ids, valid, reset,
        penalty, distinct)

    with _MESH_STATS_LOCK:
        _MESH_STATS["exchange_ms"] += exchange_ms
        _MESH_STATS["candidate_bytes"] += exchange_bytes
        _MESH_STATS["windows"] += 1
        _MESH_STATS["warm_windows"] += 1 if warm else 0

    chain_flag = flag if warm else None
    if poisoned:
        chain_flag = torch.ones((), dtype=torch.float32, device=prog.dev0)
    new_chain = MeshChain(prog, usage_tail, ring2, ring_n + p_pad, pool,
                          pool_use2, nf0_2, chain_flag, sig, refs,
                          exchange_bytes)
    return PlacementResult(packed, new_chain)


def mesh_collective_audit(mesh, k_cand: int, n_rows: int = 512,
                          n_keys: int = 4, p_pad: int = 64,
                          r_dims: int = 5) -> dict:
    """Run every stage of the mesh pipeline on synthetic inputs (the
    reference's shape and seed) and report what each did. The reference
    counted collectives in each stage's compiled program; the port has no
    compiler that could insert one and never imports torch.distributed, so
    the four stage keys are 0 by construction. Returns those keys,
    `exchange_bytes` (the per-window bytes of the exchanged packets, the
    reference's formula), and `launches`: per stage, the kernel launches
    (or plain-version calls, on the CPU) it made. Raises if any stage left
    a tensor off its shard's device or the lead device."""
    prog = _mesh_keyed_program(mesh, k_cand)
    dev = prog.device
    rng = np.random.default_rng(0)

    def put(a):
        return torch.tensor(np.asarray(a), device=dev)

    cap = put(rng.uniform(1e3, 4e3, (n_rows, r_dims)).astype(np.float32))
    sc = put(rng.uniform(8e2, 4e3, (n_rows, 2)).astype(np.float32))
    usage = put(np.zeros((n_rows, r_dims), np.float32))
    counts = put(np.zeros(n_rows, np.int32))
    noise = put((rng.random(n_rows) * 1e-3).astype(np.float32))
    banned = put(np.zeros(n_rows, bool))
    masks = put(np.ones((n_keys, n_rows), bool))
    kd = put(np.full((n_keys, r_dims), 20, np.float32))
    tg_ids = put(np.zeros(p_pad, np.int32))
    valid = put(np.ones(p_pad, bool))
    reset = put(np.zeros(p_pad, bool))
    ring0 = prog.ring_zero(r_dims)

    def runs():
        return {k: native.LAUNCHES[k] + native.PLAIN_CALLS[k]
                for k in native.KERNELS}

    def on(where, *tensors):
        for t in tensors:
            if t.device != where:
                raise RuntimeError(f"mesh stage left a tensor on {t.device},"
                                   f" want {where}")

    launches = {}
    before = runs()
    table = prog.pack_fn(cap, sc, counts, noise, banned)
    pkts, tail, nfs, vals = prog.a_cold(table, usage, masks, kd, 10.0, False,
                                        ring0)
    on(dev, pkts, nfs, vals, tail)
    after = runs()
    launches["cold"] = {k: after[k] - before[k] for k in after
                        if after[k] != before[k]}
    cand, nf_all, vals_all = prog.exchange(pkts, nfs, vals)
    on(prog.dev0, cand, nf_all, vals_all)
    out = {"cold": 0,
           "exchange_bytes": _nbytes(cand, nf_all, vals_all)}
    before = runs()
    pool = prog.pool_build(cand, nf_all, vals_all, kd)
    on(prog.dev0, *pool)
    after = runs()
    launches["pool_build"] = {k: after[k] - before[k] for k in after
                              if after[k] != before[k]}
    out["pool_build"] = 0
    before = runs()
    res = prog.warm_step(pool, pool.pool_use, pool.nf0, ring0, 0, kd, tg_ids,
                         valid, reset, 10.0, False)
    on(prog.dev0, *res)
    after = runs()
    launches["warm"] = {k: after[k] - before[k] for k in after
                        if after[k] != before[k]}
    out["warm"] = 0
    before = runs()
    full = prog.apply_fn(tail, res[3])
    on(dev, full)
    after = runs()
    launches["apply"] = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
    out["apply"] = 0
    out["launches"] = launches
    return out


# Module-level mesh pipeline counters, drained by the pipelined worker into
# its declared stats schema (nomad.mesh.* keys). The lock covers the +=
# read-modify-writes against a concurrent drain's copy and reset.
_MESH_STATS = {"exchange_ms": 0.0, "candidate_bytes": 0, "windows": 0,
               "warm_windows": 0}
_MESH_STATS_LOCK = threading.Lock()


def mesh_stats_drain() -> dict:
    """Return-and-reset the pipeline counters (any worker's stats roll-up
    may drain; totals are preserved across drains)."""
    with _MESH_STATS_LOCK:
        out = dict(_MESH_STATS)
        _MESH_STATS.update(exchange_ms=0.0, candidate_bytes=0, windows=0,
                           warm_windows=0)
    return out


def _ring_zero(cap: int, r_dims: int, device="cpu") -> torch.Tensor:
    """An empty winner ring [cap, 1 + R]: every row -1."""
    return torch.full((cap, 1 + r_dims), -1.0, dtype=torch.float32,
                      device=device)


# ---------------------------------------------------------------- K5


def compact_window_plain(packed3: torch.Tensor, valid: torch.Tensor,
                         last_idx: torch.Tensor):
    """A window's packed results reduced to what the host build reads
    (reference: kernels.compact_window). packed3 [E, P, 3] f32 (chosen row,
    score, n_feasible), valid [E, P] bool, last_idx [E] int32 (each eval's
    last valid placement, in [0, P)). Returns chosen [E, P] int32 (truncated
    toward zero), scores [E, P] f32, nf_last [E] int32 and ok [E] bool
    (every valid placement found a row), all contiguous."""
    native.PLAIN_CALLS["compact_window"] += 1
    chosen = packed3[..., 0].to(torch.int32)
    scores = packed3[..., 1].contiguous()
    nf_last = torch.gather(packed3[..., 2], 1,
                           last_idx.to(torch.int64)[:, None])[:, 0]
    ok = ((chosen >= 0) | ~valid).all(dim=1)
    return chosen, scores, nf_last.to(torch.int32), ok


@functools.lru_cache(maxsize=64)
def _compact_parts(e: int, p: int):
    """K5's output block: (byte offset, bytes, dtype, shape) of chosen
    [E, P] int32, scores [E, P] f32, nf_last [E] int32 and ok [E] bool,
    each part 16-byte aligned, and the block's size in bytes."""
    parts, off = [], 0
    for dtype, shape, size in ((torch.int32, (e, p), 4 * e * p),
                               (torch.float32, (e, p), 4 * e * p),
                               (torch.int32, (e,), 4 * e),
                               (torch.bool, (e,), e)):
        parts.append((off, size, dtype, shape))
        off = (off + size + 15) // 16 * 16
    return tuple(parts), off


def compact_block(e: int, p: int, device: torch.device) -> torch.Tensor:
    """A fresh output block for K5 at [E, P]: pinned host memory when the
    window is on a card (K5 writes it in place; its owner keeps it alive
    until an event recorded after the kernel has completed), plain host
    memory on the CPU."""
    return torch.empty(_compact_parts(e, p)[1], dtype=torch.uint8,
                       pin_memory=device.type == "cuda")


def compact_block_views(block: torch.Tensor, e: int, p: int):
    """(chosen, scores, nf_last, ok): the four parts of a K5 output block
    as tensors over its bytes."""
    parts, size = _compact_parts(e, p)
    if block.dtype != torch.uint8 or block.dim() != 1 \
            or not block.is_contiguous() or block.numel() < size:
        raise ValueError(f"K5 output block: want {size} contiguous bytes, "
                         f"got {block.dtype} {tuple(block.shape)}")
    return tuple(block[off:off + size].view(dtype).view(shape)
                 for off, size, dtype, shape in parts)


def compact_block_fill(block: torch.Tensor, outs) -> tuple:
    """Write K5's four outputs (from its plain version) into `block` and
    return the block's views; copies from a card are non-blocking, so the
    views are ready after an event recorded behind them."""
    views = compact_block_views(block, *outs[0].shape)
    for dst, src in zip(views, outs):
        dst.copy_(src, non_blocking=True)
    return views


def compact_window(packed3: torch.Tensor, valid: torch.Tensor,
                   last_idx: torch.Tensor,
                   out: Optional[torch.Tensor] = None):
    """K5 (csrc/compact.cu). See compact_window_plain for the contract.
    The outputs are the four parts of one block (`compact_block_views`):
    `out` when given, a fresh block on the inputs' device otherwise. On a
    card `out` may lie there or in pinned host memory, which the kernel
    writes in place (its owner keeps it alive until an event recorded
    after this call has completed); a pageable host block raises. CPU
    inputs run the plain version, copied into `out` when given."""
    if not _on_cuda(packed3, valid, last_idx):
        outs = compact_window_plain(packed3, valid, last_idx)
        return outs if out is None else compact_block_fill(out, outs)
    e, p = valid.shape
    _need(packed3, torch.float32, (e, p, 3), "packed3")
    _need(valid, torch.bool, (e, p), "valid")
    _need(last_idx, torch.int32, (e,), "last_idx")
    dev = packed3.device
    parts, size = _compact_parts(e, p)
    if out is None:
        out = torch.empty(size, dtype=torch.uint8, device=dev)
    views = compact_block_views(out, e, p)
    base = native.device_address(out, dev)
    addr = [base + off for off, _, _, _ in parts]
    pt = native.ptr
    err = native.library().nomad_compact_window(
        pt(packed3), pt(_u8(valid)), pt(last_idx), e, p, *addr,
        native.stream(dev))
    native.check("compact_window", err)
    return views


# ------------------------------------------------------- host mirrors


def compact_host(packed: np.ndarray, n_valid: int) -> CompactResult:
    """Numpy reduction of one host-side result to what the plan build
    reads (reference: kernels.compact_host)."""
    packed = np.asarray(packed)
    chosen = packed[:, 0].astype(np.int32)
    return CompactResult(
        chosen=chosen,
        scores=packed[:, 1].astype(np.float32, copy=False),
        nf_last=int(packed[n_valid - 1, 2]),
        ok=bool((chosen[:n_valid] >= 0).all()))


_LOG2_10_F32 = np.float32(_LOG2_10)


def place_batch_host(capacity, score_cap, usage, tg_masks, job_counts,
                     demands, tg_ids, valid, noise, penalty,
                     distinct_hosts, banned0) -> PlacementResult:
    """Numpy mirror of place_batch (reference: kernels.place_batch_host,
    copied as is). The stack routes an eval here only when its index allows
    host selection, which the port leaves off: whether a host route pays
    beside a local card is still to be measured. Same f32 BestFit-v3 formula
    with its Inf/NaN edges, same anti-affinity penalty and noise tie-break,
    same in-loop usage updates; the result's arrays are numpy."""
    capacity = np.asarray(capacity, np.float32)
    score_cap = np.asarray(score_cap, np.float32)
    usage = np.array(usage, np.float32, copy=True)
    job_counts = np.array(job_counts, np.int32, copy=True)
    banned = np.array(banned0, bool, copy=True)
    demands = np.asarray(demands, np.float32)
    tg_ids = np.asarray(tg_ids, np.int32)
    valid = np.asarray(valid, bool)
    noise = np.asarray(noise, np.float32)
    penalty = np.float32(penalty)
    distinct_hosts = bool(distinct_hosts)
    tg_masks = np.asarray(tg_masks, bool)

    p = len(tg_ids)
    packed = np.empty((p, 3), np.float32)
    neg_inf = np.float32(-np.inf)

    def full_scores(demand):
        """Whole-table masked-score pass — the same f32 formula as the
        device kernel's step."""
        util2 = usage[:, :2] + demand[:2]
        free_pct = np.float32(1.0) - util2 / score_cap
        total = (np.exp2(free_pct[:, 0] * _LOG2_10_F32)
                 + np.exp2(free_pct[:, 1] * _LOG2_10_F32))
        score = np.clip(np.float32(20.0) - total,
                        np.float32(0.0), np.float32(18.0))
        score = np.nan_to_num(score, nan=0.0, posinf=18.0, neginf=0.0)
        return score - job_counts.astype(np.float32) * penalty + noise

    def row_score(idx, demand):
        """One row of full_scores, recomputed after the row's usage or
        count changed — bit-identical to the full pass for that row."""
        util2 = usage[idx, :2] + demand[:2]
        free_pct = np.float32(1.0) - util2 / score_cap[idx]
        total = (np.exp2(free_pct[0] * _LOG2_10_F32)
                 + np.exp2(free_pct[1] * _LOG2_10_F32))
        score = np.float32(np.clip(np.float32(20.0) - total,
                                   np.float32(0.0), np.float32(18.0)))
        score = np.nan_to_num(score, nan=0.0, posinf=18.0, neginf=0.0)
        return (score - np.float32(job_counts[idx]) * penalty
                + noise[idx])

    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        # Between two placements of one (tg, demand) key only ONE node row
        # changes, so the masked-score vector is computed once per key and
        # patched at the placed row afterwards.
        cache: dict = {}  # key -> [masked, ok, n_feasible, demand, tg]
        for k in range(p):
            demand = demands[k]
            tg = int(tg_ids[k])
            key = (tg, demand.tobytes())
            ent = cache.get(key)
            if ent is None:
                eligible = tg_masks[tg]
                fits = np.all(capacity - usage >= demand[None, :], axis=1)
                ok = fits & eligible
                if distinct_hosts:
                    ok &= ~banned
                masked = np.where(ok, full_scores(demand), neg_inf)
                ent = cache[key] = [masked, ok,
                                    np.float32(np.count_nonzero(ok)),
                                    demand, tg]
            masked, ok, n_feasible = ent[0], ent[1], ent[2]
            idx = int(np.argmax(masked))
            found = bool(ok[idx]) and bool(valid[k])
            packed[k, 0] = np.float32(idx) if found else np.float32(-1)
            packed[k, 1] = masked[idx] if found else neg_inf
            packed[k, 2] = n_feasible
            if found:
                usage[idx] += demand
                job_counts[idx] += 1
                banned[idx] = True
                # A row's score/feasibility is a pure function of that row,
                # so the patched vectors stay identical to a full recompute.
                cap_row = capacity[idx]
                usage_row = usage[idx]
                for cent in cache.values():
                    cmask, cok, cn, cdemand, ctg = cent
                    old_ok = bool(cok[idx])
                    new_ok = (bool(np.all(cap_row - usage_row >= cdemand))
                              and bool(tg_masks[ctg, idx]))
                    if distinct_hosts:
                        new_ok = new_ok and not banned[idx]
                    cok[idx] = new_ok
                    cmask[idx] = (row_score(idx, cdemand) if new_ok
                                  else neg_inf)
                    if new_ok != old_ok:
                        cent[2] = np.float32(
                            cn + (1.0 if new_ok else -1.0))
    return PlacementResult(packed, usage)
