"""The redesigned K4a chain and K2/K8 select, modelled on the CPU.

`csrc/chain.cu` rescores the whole table only on a trigger step (the first,
a reset, a change of key or of demand) and otherwise updates one winner, a
segment's best and the best of the segment bests; `csrc/select.cuh` selects
each key's top K by a radix select whose passes run over the whole card.
Neither runs here, so `chain_model` and `select_model` below replay their
bookkeeping step for step in numpy and torch (triggers, segment bests, n_ok
moved by the winner's change of feasibility, the index written on a step
that places nothing; the digit passes, the compaction and the one-block
finish) and are held against the unchanged plain versions
(`placement_chain_plain`, `score_topk_plain`, `cold_packet_plain`) on
randomized scan, multi-with-reset and replay inputs and on the designs'
edge cases. The model reads every float it needs from the plain version's
own expressions over the whole table, so it agrees with it bit for bit;
what it models is which entries are rescored, when, and how their bests
are reduced.

The tests marked `cuda` hold the kernels themselves against the plain
versions on the card at the same edge cases; they skip without one.
"""

import numpy as np
import pytest
import torch

from nomad_tpu_torch import native
from nomad_tpu_torch.scheduler import kernels as tk

SEG = 128                 # csrc/chain.cu kSeg
INT_MAX = 2 ** 31 - 1
NEG_INF = float("-inf")
U32 = np.uint32
U64 = np.uint64


# ------------------------------------------------------------ the models


def score_key(s) -> np.ndarray:
    """csrc/chain.cu score_key: order-preserving u32, -0.0 as +0.0."""
    s = np.array(s, dtype=np.float32, ndmin=1)
    s[s == 0] = 0.0
    u = s.view(U32)
    return np.where(u >> U32(31), ~u, u | U32(0x80000000)).astype(U32)


def best(keys, idx):
    """(key desc, index asc) over parallel arrays; (0, INT_MAX) if empty."""
    keys = np.asarray(keys)
    if keys.size == 0:
        return 0, INT_MAX
    k = keys.max()
    return int(k), int(np.asarray(idx)[keys == k].min())


def triggers(tg_ids, valid, demands, reset, n_keys, replay):
    """Steps on which the kernel rescores the whole table."""
    t = np.clip(tg_ids, 0, n_keys - 1)
    trig = np.zeros(len(t), bool)
    for j in range(len(t)):
        if j == 0 or (reset is not None and reset[j]) or t[j] != t[j - 1]:
            trig[j] = True
        elif replay:
            trig[j] = valid[j] != valid[j - 1]
        else:
            trig[j] = bool((demands[j].view(U32)
                            != demands[j - 1].view(U32)).any())
    return trig


def chain_model(capacity, score_cap, usage, tg_masks, job_counts0, demands,
                tg_ids, valid, noise, penalty, distinct, banned0, reset=None,
                rows=None, keep=None, masked0=None, nf0=None, seg=SEG):
    """K4a's bookkeeping. Returns (packed, usage_after, win, chained usage,
    stats) with stats counting full passes and incremental rescores."""
    replay = rows is not None
    n_keys = tg_masks.shape[0]
    p = tg_ids.shape[0]
    tg = np.clip(tg_ids.numpy(), 0, n_keys - 1)
    vl = valid.numpy()
    rs = reset.numpy() if reset is not None else None
    if replay:
        idx = rows.to(torch.int64)
        t_cap, t_sc, t_noise = capacity[idx], score_cap[idx], noise[idx]
        t_elig = tg_masks[:, idx]
        cnt0, ban0 = job_counts0[idx], banned0[idx]
        use = usage[idx].clone()
        ok0_sum = ((masked0[:, idx] != NEG_INF) & keep[None, :]).sum(dim=1)
        # The plain version's per-step demand: zeroed on padding steps.
        step_d = (demands[tg_ids.to(torch.int64)]
                  * valid[:, None].to(torch.float32))
    else:
        t_cap, t_sc, t_noise, t_elig = capacity, score_cap, noise, tg_masks
        cnt0, ban0 = job_counts0, banned0
        use = usage.clone()
        step_d = demands
    trig = triggers(tg, vl, step_d.numpy(), rs, n_keys, replay)
    c_cnt, c_ban = cnt0.clone(), ban0.clone()
    n_table = t_cap.shape[0]
    n_seg = -(-n_table // seg)
    segk = np.zeros(n_seg, np.int64)
    segi = np.zeros(n_seg, np.int64)

    def table(t, d):
        """The plain version's expressions over the whole table."""
        ok = (t_cap - use >= d[None, :]).all(dim=1) & t_elig[t]
        if distinct:
            ok = ok & ~c_ban
        if replay:
            ok = ok & keep
        sc = tk._score(use[:, :2] + d[None, :2], t_sc)
        sc = sc - c_cnt.to(torch.float32) * penalty + t_noise
        return ok, sc

    def reduce_segment(s):
        lo, hi = s * seg, min((s + 1) * seg, n_table)
        segk[s], segi[s] = best(score_key(score[lo:hi]), np.arange(lo, hi))

    packed = torch.empty((p, 3), dtype=torch.float32)
    win = torch.empty(p, dtype=torch.int32)
    stats = {"full": 0, "incremental": 0, "rose": 0}
    score = okf = d = None
    n_ok = top_i = t = 0
    for j in range(p):
        if trig[j]:
            t = int(tg[j])
            if rs is not None and rs[j]:
                c_cnt, c_ban = cnt0.clone(), ban0.clone()
            d = step_d[j]
            ok, sc = table(t, d)
            score = torch.where(ok, sc, NEG_INF).numpy().copy()
            okf = ok.numpy().copy()
            for s in range(n_seg):
                reduce_segment(s)
            n_ok = int(okf.sum())
            top_i = best(segk, segi)[1]
            stats["full"] += 1
        else:
            # Between triggers the key and the demand stay the same.
            assert tg[j] == t
            assert np.array_equal(step_d[j].numpy().view(U32),
                                  d.numpy().view(U32))
        bi = top_i
        found = bool(vl[j]) and bool(okf[bi])
        bv = score[bi]
        nf = int(nf0[t]) + n_ok - int(ok0_sum[t]) if replay else n_ok
        win[j] = bi
        row = int(rows[bi]) if replay else bi
        packed[j, 0] = float(row) if found else -1.0
        packed[j, 1] = float(bv) if found else NEG_INF
        packed[j, 2] = float(nf)
        if not found:
            continue
        use[bi] = use[bi] + d
        c_cnt[bi] += 1
        c_ban[bi] = True
        if j + 1 >= p or trig[j + 1]:
            okf[bi] = False    # stale until the next full pass rescores it
            continue
        # The winner was feasible at this (t, d): only its ban and its fit
        # can change, so its new feasibility needs neither mask nor keep.
        fit = bool((t_cap[bi] - use[bi] >= d).all())
        ok_new = (not distinct) and fit
        ok_all, sc_all = table(t, d)
        assert ok_new == bool(ok_all[bi])
        old_key = int(score_key(score[bi])[0])
        score[bi] = float(sc_all[bi]) if ok_new else NEG_INF
        okf[bi] = ok_new
        n_ok += int(ok_new) - 1
        assert n_ok == int(ok_all.sum())
        if int(score_key(score[bi])[0]) >= old_key:
            # The best only rose: it stays the best, with no reduction.
            segk[bi // seg] = int(score_key(score[bi])[0])
            reduce_segment(bi // seg)
            assert best(segk, segi)[1] == bi
            stats["rose"] += 1
        else:
            reduce_segment(bi // seg)
            top_i = best(segk, segi)[1]
        stats["incremental"] += 1
    if replay:
        usage_after = usage.clone()
        usage_after[idx[keep]] = use[keep]
    else:
        usage_after = use
    return packed, usage_after, win, use, stats


def desc_score_key(s, rows) -> np.ndarray:
    """score.cuh desc_score_key: ascending u64 order is (score desc, row
    asc)."""
    s = np.array(s, dtype=np.float32, ndmin=1)
    s[s == 0] = 0.0
    u = s.view(U32).astype(U64)
    u = np.where(u >> U64(31), ~u & U64(0xFFFFFFFF), u | U64(0x80000000))
    return ((~u & U64(0xFFFFFFFF)) << U64(32)) | np.asarray(rows).astype(U64)


def in_play(keys, prefix, lo):
    if lo >= 64:
        return np.ones(keys.shape, bool)
    return (keys >> U64(lo)) == (U64(prefix) >> U64(lo))


def _narrow(keys, prefix, lo, k_rem, bits):
    """One radix pass: the digit below lo whose bin holds the k_rem-th key
    in play. Returns (prefix, lo, k_rem, keys in play)."""
    dlo = max(lo - bits, 0)
    play = keys[in_play(keys, prefix, lo)]
    digits = ((play >> U64(dlo)) & U64((1 << (lo - dlo)) - 1)).astype(np.int64)
    hist = np.bincount(digits, minlength=1 << (lo - dlo))
    cum = np.cumsum(hist)
    b = int(np.argmax(cum >= k_rem))
    before = int(cum[b] - hist[b])
    return prefix | (b << dlo), dlo, k_rem - before, int(hist[b])


def select_model(masked0: np.ndarray, kc: int, cap=4096, digit_bits=12,
                 finish_bits=8, grid_passes=3):
    """launch_select's passes for every key. Returns (nf0, selected rows
    per key as a list of sets, stats per key)."""
    n = masked0.shape[1]
    nf0, selected, stats = [], [], []
    for m_row in masked0:
        keys = desc_score_key(m_row, np.arange(n))
        prefix, lo, k_rem, m = 0, 64, kc, n
        done = n <= cap or kc == n
        passes = 0
        for _ in range(grid_passes):
            if done:
                continue
            prefix, lo, k_rem, m = _narrow(keys, prefix, lo, k_rem,
                                           digit_bits)
            done = lo == 0 or m <= cap or m == k_rem
            passes += 1
        # The compaction.
        take_all = k_rem == m
        play = in_play(keys, prefix, lo)
        sel = np.where(play, take_all, keys < U64(prefix))
        out = set(np.nonzero(sel)[0].tolist())
        assert len(out) == kc - (0 if take_all else k_rem)
        finish = 0
        if not take_all:
            # The keys in play: buffered when they fit, else read again
            # from the scores (the finish filters them by the same prefix).
            surv = keys[play]
            assert len(surv) == m
            k_fin = k_rem
            while k_rem < m and lo > 0:
                prefix, lo, k_rem, m = _narrow(surv, prefix, lo, k_rem,
                                               finish_bits)
                finish += 1
            pick = surv[(surv < U64(prefix)) | in_play(surv, prefix, lo)]
            assert len(pick) == k_fin
            out |= set((pick & U64(0xFFFFFFFF)).astype(np.int64).tolist())
        assert len(out) == kc
        nf0.append(int(np.sum(m_row != NEG_INF)))
        selected.append(out)
        stats.append({"grid_passes": passes, "finish_passes": finish,
                      "take_all": take_all,
                      "buffered": not take_all and len(surv) <= cap})
    return np.array(nf0, np.int32), selected, stats


# ------------------------------------------------------------- the inputs


def _fleet(n, t, seed, uniform=False, zero_noise=False):
    """Node-side inputs as torch CPU tensors. uniform: the storm's mock
    fleet (identical nodes); zero_noise: exact ties everywhere."""
    rng = np.random.default_rng(seed)
    if uniform:
        d = dict(
            capacity=np.tile(np.float32([4000, 8192, 102400, 150, 1000]),
                             (n, 1)),
            score_cap=np.tile(np.float32([3900, 7936]), (n, 1)),
            usage=np.tile(np.float32([100, 256, 4096, 0, 1]), (n, 1)),
            tg_masks=np.ones((t, n), bool),
            job_counts=np.zeros(n, np.int32),
            key_demands=np.tile(np.float32([20, 32, 10, 0, 0]), (t, 1)),
            banned0=np.zeros(n, bool))
    else:
        d = dict(
            capacity=rng.uniform(1000, 4000, (n, 5)).astype(np.float32),
            score_cap=rng.uniform(800, 3800, (n, 2)).astype(np.float32),
            usage=rng.uniform(0, 500, (n, 5)).astype(np.float32),
            tg_masks=rng.random((t, n)) < 0.9,
            job_counts=rng.integers(0, 3, n).astype(np.int32),
            key_demands=rng.uniform(10, 100, (t, 5)).astype(np.float32),
            banned0=rng.random(n) < 0.05)
    d["noise"] = (np.zeros(n, np.float32) if zero_noise
                  else (rng.random(n) * 1e-3).astype(np.float32))
    return rng, {k: torch.tensor(v) for k, v in d.items()}


def _served_steps(evals, per_eval=64, n_valid=50):
    """dispatch_multi's window: one key, a reset at each eval's first step,
    n_valid valid steps of each eval's per_eval."""
    p = evals * per_eval
    valid = np.zeros(p, bool)
    reset = np.zeros(p, bool)
    for e in range(evals):
        valid[e * per_eval:e * per_eval + n_valid] = True
        reset[e * per_eval] = True
    return (torch.zeros(p, dtype=torch.int32), torch.tensor(valid),
            torch.tensor(reset))


# Each case: (fleet kwargs, T, the step builder, distinct). The step
# builder returns (tg_ids, valid, reset, demand override or None).
def _steps_random(rng, t, p, every=16, frac=0.9):
    valid = np.zeros(p, bool)
    valid[:int(p * frac)] = True
    reset = np.zeros(p, bool)
    reset[::every] = True
    return (torch.tensor(rng.integers(0, t, p).astype(np.int32)),
            torch.tensor(valid), torch.tensor(reset))


def _steps_runs(rng, t, p, run=12, frac=1.0):
    """Runs of one key: the key changes mid-run, without a reset."""
    ids = np.repeat(rng.integers(0, t, -(-p // run)), run)[:p]
    valid = np.zeros(p, bool)
    valid[:int(p * frac)] = True
    reset = np.zeros(p, bool)
    reset[0] = True
    return (torch.tensor(ids.astype(np.int32)), torch.tensor(valid),
            torch.tensor(reset))


CHAIN_CASES = {
    # name: (n, T, fleet kwargs, steps kind, distinct)
    "random": (300, 3, {}, "random", False),
    "random_distinct": (300, 3, {}, "random", True),
    "served_shape": (512, 1, dict(uniform=True), "served", False),
    "uniform_ties": (200, 1, dict(uniform=True, zero_noise=True), "runs",
                     False),
    "uniform_ties_distinct": (200, 1, dict(uniform=True, zero_noise=True),
                              "runs", True),
    "all_infeasible_key": (256, 2, {}, "runs", False),
    "key_change_mid_run": (300, 3, {}, "runs", False),
    "padding_runs": (300, 2, {}, "served", False),
    "not_segment_multiple": (129, 2, {}, "random", True),
    "three_dims": (200, 2, dict(r=3), "runs", True),
    "seven_dims": (200, 2, dict(r=7), "random", False),
    "forty_keys": (300, 40, {}, "runs", False),
}


def _resize_dims(f, r, rng):
    """The fleet with r resource dimensions: the first r, or extra random
    ones beyond 5."""
    for name, (lo, hi) in (("capacity", (1000, 4000)), ("usage", (0, 500)),
                           ("key_demands", (10, 100))):
        x = f[name]
        if r <= x.shape[1]:
            f[name] = x[:, :r].contiguous()
        else:
            extra = rng.uniform(lo, hi, (x.shape[0], r - x.shape[1]))
            f[name] = torch.cat([x, torch.tensor(extra.astype(np.float32))],
                                dim=1)
    return f


def _case(name, mode, seed=0):
    n, t, fleet_kw, kind, distinct = CHAIN_CASES[name]
    fleet_kw = dict(fleet_kw)
    r_dims = fleet_kw.pop("r", 5)
    rng, f = _fleet(n, t, seed + n, **fleet_kw)
    if r_dims != 5:
        f = _resize_dims(f, r_dims, rng)
    if name == "all_infeasible_key":
        f["tg_masks"][0] = False        # every step of key 0 places nothing
    if kind == "random":
        tg_ids, valid, reset = _steps_random(rng, t, 160)
    elif kind == "runs":
        tg_ids, valid, reset = _steps_runs(rng, t, 160, frac=0.85)
    else:
        tg_ids, valid, reset = _served_steps(3)
        tg_ids = torch.tensor(rng.integers(0, t, len(valid)).astype(np.int32)
                              if t > 1 else np.zeros(len(valid), np.int32))
        if t > 1:   # padding runs inside runs of one key
            tg_ids = torch.repeat_interleave(tg_ids[::16], 16)[:len(valid)]
    if mode == "scan":
        reset = None
    base = (f["capacity"], f["score_cap"], f["usage"], f["tg_masks"],
            f["job_counts"])
    if mode == "replay":
        n_valid = int(valid.sum())
        k_cand = tk.keyed_cand_count(max(n_valid, 1))
        masked0, nf0, cand = tk.score_topk_plain(
            *base, f["key_demands"], f["noise"], 10.0, distinct,
            f["banned0"], k_cand)
        rows, keep = tk.merge_candidates_plain(cand, masked0, k_cand)
        args = (*base, f["key_demands"], tg_ids, valid, f["noise"], 10.0,
                distinct, f["banned0"])
        kw = dict(reset=reset, rows=rows, keep=keep, masked0=masked0,
                  nf0=nf0)
    else:
        demands = (f["key_demands"][tg_ids.to(torch.int64)]
                   * valid[:, None].to(torch.float32)).contiguous()
        args = (*base, demands, tg_ids, valid, f["noise"], 10.0, distinct,
                f["banned0"])
        kw = dict(reset=reset) if reset is not None else {}
    return args, kw


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


# --------------------------------------------------------- the chain model


@pytest.mark.parametrize("mode", ["scan", "multi", "replay"])
@pytest.mark.parametrize("name", sorted(CHAIN_CASES))
def test_chain_model_matches_plain(name, mode):
    """The incremental bookkeeping gives the plain chain's packed result,
    usage and (replay) argmax index and chained usage, bit for bit."""
    args, kw = _case(name, mode)
    ref = tk.placement_chain_plain(*args, **kw,
                                   winners=mode == "replay")
    got = chain_model(*args, **kw)
    assert torch.equal(_bits(got[0]), _bits(ref[0]))
    assert torch.equal(_bits(got[1]), _bits(ref[1]))
    if mode == "replay":
        assert torch.equal(got[2], ref[2])
        assert torch.equal(_bits(got[3]), _bits(ref[3]))
    stats = got[4]
    assert stats["full"] >= 1
    if name != "all_infeasible_key":
        # Most steps are incremental: the design's point.
        assert stats["incremental"] > 0


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("mode", ["scan", "multi", "replay"])
def test_chain_model_random_seeds(seed, mode):
    args, kw = _case("random", mode, seed=seed)
    ref = tk.placement_chain_plain(*args, **kw, winners=mode == "replay")
    got = chain_model(*args, **kw)
    for a, b in zip(got[:len(ref)], ref):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("seg", [1, 5, 32, 128, 1024])
def test_chain_model_any_segment_size(seg):
    """Segment bests reduce to the same argmax at any segment size,
    including segments that do not divide the table."""
    args, kw = _case("not_segment_multiple", "replay")
    ref = tk.placement_chain_plain(*args, **kw, winners=True)
    got = chain_model(*args, **kw, seg=seg)
    assert torch.equal(got[2], ref[2])
    assert torch.equal(_bits(got[0]), _bits(ref[0]))


def test_served_shape_rescores_twice_per_eval():
    """At the served window's shape (one key, a reset every 64 steps, 50
    valid of 64) the chain rescores the table at each eval's first step and
    its first padding step, and nowhere else."""
    args, kw = _case("served_shape", "replay")
    got = chain_model(*args, **kw)
    ref = tk.placement_chain_plain(*args, **kw)
    assert torch.equal(_bits(got[0]), _bits(ref[0]))
    assert got[4]["full"] == 2 * 3
    assert got[4]["incremental"] == 3 * 49


def test_demand_change_mid_run_triggers_in_scan_mode():
    """Scan mode takes a demand per step: a new demand under the same key
    rescores the table."""
    rng, f = _fleet(300, 1, 7)
    p = 90
    tg_ids = torch.zeros(p, dtype=torch.int32)
    valid = torch.ones(p, dtype=torch.bool)
    dem = np.repeat(rng.uniform(10, 100, (3, 5)).astype(np.float32), 30, 0)
    args = (f["capacity"], f["score_cap"], f["usage"], f["tg_masks"],
            f["job_counts"], torch.tensor(dem), tg_ids, valid, f["noise"],
            10.0, False, f["banned0"])
    ref = tk.placement_chain_plain(*args)
    got = chain_model(*args)
    assert torch.equal(_bits(got[0]), _bits(ref[0]))
    assert torch.equal(_bits(got[1]), _bits(ref[1]))
    assert got[4]["full"] == 3


def test_all_infeasible_steps_write_index_zero():
    """A step with every entry infeasible places nothing, scores -inf and
    still writes the argmax's index: 0, the first of the -inf entries."""
    args, kw = _case("all_infeasible_key", "replay")
    ref = tk.placement_chain_plain(*args, **kw, winners=True)
    got = chain_model(*args, **kw)
    tg_ids = args[6]
    dead = (tg_ids == 0).numpy()
    assert dead.any()
    assert (ref[0][dead, 0] == -1).all()
    assert (ref[2][dead] == 0).all()
    assert torch.equal(got[2], ref[2])


# -------------------------------------------------------- the select model


def _select_inputs(n, t, seed, kind):
    rng, f = _fleet(n, t, seed, uniform=kind in ("uniform", "ties"),
                    zero_noise=kind == "ties")
    if kind == "starved":
        f["tg_masks"][0] = False
        f["tg_masks"][0, [3, n // 2]] = True
    return f


SELECT_CASES = [
    # (n, T, k, kind, cap)
    (3000, 1, 64, "varied", 4096),     # n <= cap: the finish alone
    (3000, 1, 64, "varied", 128),      # grid passes, then the finish
    (3000, 2, 700, "varied", 256),     # n_keys > 1
    (2048, 1, 1, "varied", 64),        # k = 1
    (2048, 1, 2048, "varied", 64),     # k = n: every row, no finish
    (2048, 2, 2048, "starved", 64),    # k = n with -inf rows
    (4096, 1, 512, "uniform", 64),     # noise-only ties
    (4096, 1, 512, "ties", 64),        # exact ties: the row decides
    (4096, 3, 100, "starved", 64),     # fewer feasible rows than k
    (5000, 1, 777, "varied", 4096),    # n > cap at the kernel's cap
]


@pytest.mark.parametrize("n,t,k,kind,cap", SELECT_CASES)
def test_select_model_matches_score_topk(n, t, k, kind, cap):
    """The select's passes pick each key's top K rows and count nf0 as the
    plain version's stable sort does."""
    f = _select_inputs(n, t, n + t + k, kind)
    masked0, nf0, cand = tk.score_topk_plain(
        f["capacity"], f["score_cap"], f["usage"], f["tg_masks"],
        f["job_counts"], f["key_demands"], f["noise"], 10.0, False,
        f["banned0"], k)
    got_nf0, sel, stats = select_model(masked0.numpy(), cand.shape[1],
                                       cap=cap)
    np.testing.assert_array_equal(got_nf0, nf0.numpy())
    for row, want in zip(sel, cand.numpy()):
        assert row == set(want.tolist())
    if k < n and n > cap:
        assert all(s["grid_passes"] >= 1 for s in stats)


def test_select_model_runs_every_digit_on_exact_ties():
    """Equal scores leave only the row bits to decide: the grid passes go
    down into the row word before the survivors fit."""
    f = _select_inputs(8192, 1, 5, "ties")
    masked0, _, cand = tk.score_topk_plain(
        f["capacity"], f["score_cap"], f["usage"], f["tg_masks"],
        f["job_counts"], f["key_demands"], f["noise"], 10.0, False,
        f["banned0"], 1000)
    _, sel, stats = select_model(masked0.numpy(), 1000, cap=16)
    assert sel[0] == set(range(1000))
    assert sel[0] == set(cand[0].tolist())
    # Three grid passes leave 8,192 tied keys in play: the finish reads
    # them again from the scores instead of a buffer.
    assert stats[0]["grid_passes"] == 3
    assert not stats[0]["buffered"]
    _, sel, stats = select_model(masked0.numpy(), 1000, cap=16,
                                 grid_passes=6)
    assert sel[0] == set(range(1000))
    assert stats[0]["grid_passes"] >= 4


@pytest.mark.parametrize("b_buf", [1, 64, 2048])
def test_select_model_matches_cold_packet(b_buf):
    """K8's shape: one shard's packed table, top-B rows and nf0."""
    _, f = _fleet(2048, 2, 11)
    table = tk.mesh_pack_plain(f["capacity"], f["score_cap"],
                               f["job_counts"], f["noise"], f["banned0"])
    pkt, nf0, vals = tk.cold_packet_plain(
        table, f["usage"], f["tg_masks"], f["key_demands"], 10.0, True,
        4096, b_buf)
    r = f["usage"].shape[1]
    masked0 = tk.score_topk_plain(
        f["capacity"], f["score_cap"], f["usage"], f["tg_masks"],
        f["job_counts"], f["key_demands"], f["noise"], 10.0, True,
        f["banned0"], b_buf)[0]
    got_nf0, sel, _ = select_model(masked0.numpy(), b_buf, cap=256)
    np.testing.assert_array_equal(got_nf0, nf0.numpy())
    rows = (pkt[:, 0].to(torch.int64) - 4096).reshape(2, b_buf)
    for t in range(2):
        assert sel[t] == set(rows[t].tolist())
    assert pkt.shape[1] == 6 + 2 * r + 2


# ------------------------------------------------- the kernels on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _to(dev, args, kw):
    mv = lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x
    return tuple(mv(a) for a in args), {k: mv(v) for k, v in kw.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["scan", "multi", "replay"])
@pytest.mark.parametrize("name", sorted(CHAIN_CASES))
def test_chain_kernel_edge_cases_on_card(cuda_device, name, mode):
    args, kw = _to(cuda_device, *_case(name, mode))
    winners = mode == "replay"
    got = tk.placement_chain(*args, **kw, winners=winners)
    ref = tk.placement_chain_plain(*args, **kw, winners=winners)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16384, 65536 + 77])
def test_chain_kernel_table_beyond_shared_memory(cuda_device, n):
    """Scan tables whose state does not fit the shared-memory budget keep
    it in global memory; one not a multiple of the segment size."""
    rng, f = _fleet(n, 2, n)
    tg_ids, valid, reset = _steps_runs(rng, 2, 96, frac=0.9)
    demands = (f["key_demands"][tg_ids.to(torch.int64)]
               * valid[:, None].to(torch.float32)).contiguous()
    args, kw = _to(cuda_device, (
        f["capacity"], f["score_cap"], f["usage"], f["tg_masks"],
        f["job_counts"], demands, tg_ids, valid, f["noise"], 10.0, True,
        f["banned0"]), dict(reset=reset))
    got = tk.placement_chain(*args, **kw)
    ref = tk.placement_chain_plain(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,k,kind,cap", SELECT_CASES
                         + [(131072, 1, 2048, "varied", 4096),
                            (1 << 20, 1, 1024, "varied", 4096)])
def test_select_kernel_edge_cases_on_card(cuda_device, n, t, k, kind, cap):
    """K2's select against the plain stable sort (cap is the model's; the
    kernel's is 4,096)."""
    f = {key: v.to(cuda_device)
         for key, v in _select_inputs(n, t, n + t + k, kind).items()}
    args = (f["capacity"], f["score_cap"], f["usage"], f["tg_masks"],
            f["job_counts"], f["key_demands"], f["noise"], 10.0, False,
            f["banned0"], k)
    got = tk.score_topk(*args)
    ref = tk.score_topk_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("b_buf,kind", [(1, "varied"), (2048, "varied"),
                                        (2048, "ties"), (8192, "starved")])
def test_cold_packet_select_on_card(cuda_device, b_buf, kind):
    """K8 at a shard's 131,072 rows (and k = n on a small shard)."""
    n = 131072 if b_buf < 8192 else 8192
    f = {key: v.to(cuda_device)
         for key, v in _select_inputs(n, 2, b_buf, kind).items()}
    table = tk.mesh_pack(f["capacity"], f["score_cap"], f["job_counts"],
                         f["noise"], f["banned0"])
    args = (table, f["usage"], f["tg_masks"], f["key_demands"], 10.0, True,
            0, b_buf)
    before = native.LAUNCHES["cold_packet"]
    got = tk.cold_packet(*args)
    assert native.LAUNCHES["cold_packet"] == before + 1
    ref = tk.cold_packet_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(_bits(a), _bits(b))
