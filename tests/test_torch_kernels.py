"""nomad_tpu_torch's placement kernels held against nomad_tpu's.

The same numpy inputs, made from a seed, go through the JAX program and its
counterpart in the port. On the CPU every port wrapper runs its plain
PyTorch version; the tests marked `cuda` hold each CUDA kernel against that
plain version on the card and skip without one.

Tolerances: chosen rows, n_feasible on valid steps, and usage are exact.
Scores agree within 4e-6 ABSOLUTE, not in ulps: jnp.exp2 and torch.exp2 on
the CPU disagree by up to 3 ulp on about a third of inputs in [0, 3.33], and
the score 20 - total cancels, so near 0 that is hundreds of ulps of the
result while staying below 4e-6 absolute. Placement parity against JAX
therefore uses fleets with varied resources, where such a difference cannot
reorder two rows; on the card the kernel and its plain version round the
same way and must agree bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nomad_tpu.scheduler import kernels as jk
from nomad_tpu_torch import native
from nomad_tpu_torch.scheduler import kernels as tk

SCORE_TOL = 4e-6


def _t(a, device="cpu"):
    return torch.tensor(np.asarray(a), device=device)


def assert_same_placements(ref_packed, ref_usage, packed, usage, valid=None):
    """Rows exact, n_feasible exact on valid steps, usage exact, scores
    within SCORE_TOL absolute."""
    rp = np.asarray(ref_packed)
    bp = packed.cpu().numpy() if isinstance(packed, torch.Tensor) \
        else np.asarray(packed)
    v = np.ones(len(rp), bool) if valid is None else np.asarray(valid)
    np.testing.assert_array_equal(rp[:, 0], bp[:, 0])
    np.testing.assert_array_equal(rp[v, 2], bp[v, 2])
    fin = np.isfinite(rp[:, 1])
    np.testing.assert_array_equal(fin, np.isfinite(bp[:, 1]))
    np.testing.assert_allclose(bp[fin, 1], rp[fin, 1], rtol=0,
                               atol=SCORE_TOL)
    bu = usage.cpu().numpy() if isinstance(usage, torch.Tensor) else usage
    np.testing.assert_array_equal(np.asarray(ref_usage), bu)


def _scan_args(d):
    """Positional place_batch args in the reference's order."""
    return (d["capacity"], d["score_cap"], d["usage"], d["tg_masks"],
            d["job_counts"], d["demands"], d["tg_ids"], d["valid"],
            d["noise"], d["penalty"], d["distinct"], d["banned0"])


def _run_scan_both(d):
    ref = jk.place_batch(*[jnp.asarray(a) for a in _scan_args(d)])
    port = tk.place_batch(*[_t(a) if isinstance(a, np.ndarray) else a
                            for a in _scan_args(d)])
    return ref, port


class TestScore:
    def test_edges_and_values(self):
        rng = np.random.default_rng(3)
        u = rng.uniform(0, 4000, (4096, 2)).astype(np.float32)
        c = rng.uniform(-10, 4000, (4096, 2)).astype(np.float32)
        # IEEE division edges: x/0, 0/0, negative capacity, over-use.
        u[:4] = [[1, 1], [0, 0], [5, 0], [0, 7]]
        c[:4] = [[0, 0], [0, 0], [0, 3], [-2, 0]]
        ref = np.asarray(jk._score(jnp.asarray(u), jnp.asarray(c)))
        got = tk._score(_t(u), _t(c)).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=0, atol=SCORE_TOL)
        # x/0 on both dims clamps to 18 and 0/0 (NaN) sanitizes to 0 exactly.
        np.testing.assert_array_equal(got[:2], [18.0, 0.0])
        np.testing.assert_array_equal(ref[:2], [18.0, 0.0])


class TestPlaceBatch:
    """TestPlaceBatchKernel's cases (tests/test_tensor_and_kernels.py)."""

    def _inputs(self, n=64, p=8):
        return dict(
            capacity=np.full((n, 5), 1000, np.float32),
            score_cap=np.full((n, 2), 1000, np.float32),
            usage=np.zeros((n, 5), np.float32),
            tg_masks=np.ones((1, n), bool), job_counts=np.zeros(n, np.int32),
            demands=np.full((p, 5), 100, np.float32),
            tg_ids=np.zeros(p, np.int32), valid=np.ones(p, bool),
            noise=np.zeros(n, np.float32), penalty=10.0, distinct=False,
            banned0=np.zeros(n, bool))

    @pytest.mark.parametrize("case", ["spread", "pack", "exhaust", "distinct"])
    def test_matches_jax(self, case):
        d = self._inputs()
        if case == "pack":
            d["penalty"] = 0.0
        elif case == "exhaust":
            d = self._inputs(n=2, p=8)
            d["demands"] = np.full((8, 5), 300, np.float32)
        elif case == "distinct":
            d = self._inputs(n=4, p=8)
            d["demands"] = np.full((8, 5), 10, np.float32)
            d["distinct"] = True
        ref, port = _run_scan_both(d)
        assert_same_placements(ref.packed, ref.usage_after, port.packed,
                               port.usage_after)
        chosen = port.chosen.numpy()
        expect = {"spread": lambda: len(set(chosen.tolist())) == 8,
                  "pack": lambda: len(set(chosen.tolist())) == 1,
                  "exhaust": lambda: (chosen >= 0).sum() == 6,
                  "distinct": lambda: len(set(chosen[chosen >= 0])) == 4}
        assert expect[case]()

    def test_graft_entry_shape(self):
        """__graft_entry__.entry()'s (1024, 64, 2) flagship shape."""
        n, p, t = 1024, 64, 2
        rng = np.random.default_rng(0)
        d = dict(
            capacity=rng.uniform(1000, 4000, (n, 5)).astype(np.float32),
            score_cap=rng.uniform(800, 3800, (n, 2)).astype(np.float32),
            usage=rng.uniform(0, 500, (n, 5)).astype(np.float32),
            tg_masks=rng.random((t, n)) < 0.9,
            job_counts=np.zeros(n, np.int32),
            demands=rng.uniform(10, 100, (p, 5)).astype(np.float32),
            tg_ids=rng.integers(0, t, p).astype(np.int32),
            valid=np.ones(p, bool),
            noise=(rng.random(n).astype(np.float32) * 1e-3),
            penalty=10.0, distinct=False, banned0=np.zeros(n, bool))
        ref, port = _run_scan_both(d)
        assert_same_placements(ref.packed, ref.usage_after, port.packed,
                               port.usage_after)


def _keyed_inputs(n=512, t=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng, dict(
        capacity=rng.uniform(1000, 4000, (n, 5)).astype(np.float32),
        score_cap=rng.uniform(800, 3800, (n, 2)).astype(np.float32),
        usage=rng.uniform(0, 500, (n, 5)).astype(np.float32),
        tg_masks=rng.random((t, n)) < 0.9,
        job_counts=rng.integers(0, 3, n).astype(np.int32),
        key_demands=rng.uniform(10, 100, (t, 5)).astype(np.float32),
        noise=(rng.random(n) * 1e-3).astype(np.float32),
        banned0=rng.random(n) < 0.05,
    )


class TestKeyed:
    """TestKeyedKernel's cases: the port's keyed path against JAX's keyed
    kernel (mesh=None) and against the monolithic scan."""

    @pytest.mark.parametrize(
        "p,n_valid,distinct,multi",
        [(64, 61, False, False), (64, 64, True, False),
         (128, 128, False, True), (256, 250, True, True),
         (8, 5, False, False)])
    def test_matches_jax(self, p, n_valid, distinct, multi):
        rng, d = _keyed_inputs()
        t = d["key_demands"].shape[0]
        tg_ids = rng.integers(0, t, p).astype(np.int32)
        valid = np.zeros(p, bool)
        valid[:n_valid] = True
        reset = np.zeros(p, bool)
        if multi:
            reset[::8] = True
        args = (d["capacity"], d["score_cap"], d["usage"], d["tg_masks"],
                d["job_counts"], d["key_demands"], tg_ids, valid, d["noise"])
        ref = jk.place_batch_keyed(None, *args, np.float32(10.0),
                                   np.asarray(distinct), d["banned0"], reset,
                                   n_valid)
        port = tk.place_batch_keyed(None, *[_t(a) for a in args], 10.0,
                                    distinct, _t(d["banned0"]), _t(reset),
                                    n_valid)
        assert_same_placements(ref.packed, ref.usage_after, port.packed,
                               port.usage_after, valid)
        bp = port.packed.numpy()
        assert (bp[~valid, 0] == -1).all()
        assert np.isneginf(bp[~valid, 1]).all()
        # And the port's own scan route gives the same placements.
        demands = d["key_demands"][tg_ids] * valid[:, None]
        scan_fn = tk.place_batch_multi if multi else tk.place_batch
        extra = (_t(reset),) if multi else ()
        scan = scan_fn(_t(d["capacity"]), _t(d["score_cap"]), _t(d["usage"]),
                       _t(d["tg_masks"]), _t(d["job_counts"]), _t(demands),
                       _t(tg_ids), _t(valid), _t(d["noise"]), 10.0, distinct,
                       _t(d["banned0"]), *extra)
        assert_same_placements(scan.packed.numpy(), scan.usage_after,
                               port.packed, port.usage_after, valid)

    def test_top_k_order_matches_lax(self):
        """K2's plain version orders each key's candidates as lax.top_k
        does: score desc, ties (here: a uniform fleet with no noise, and
        the -inf tail) to the lowest row."""
        import jax

        n, t, k = 256, 2, 64
        d = dict(capacity=np.full((n, 5), 1000, np.float32),
                 score_cap=np.full((n, 2), 1000, np.float32),
                 usage=np.zeros((n, 5), np.float32),
                 tg_masks=np.zeros((t, n), bool),
                 job_counts=np.zeros(n, np.int32),
                 key_demands=np.full((t, 5), 10, np.float32),
                 noise=np.zeros(n, np.float32), banned0=np.zeros(n, bool))
        d["tg_masks"][0, ::3] = True          # 86 feasible: ties, then -inf
        d["tg_masks"][1, 200:210] = True      # 10 feasible, 54 -inf entries
        masked0, nf0, cand = tk.score_topk_plain(
            *[_t(d[k_]) for k_ in ("capacity", "score_cap", "usage",
                                   "tg_masks", "job_counts", "key_demands",
                                   "noise")], 10.0, False, _t(d["banned0"]),
            k)
        _, ref_idx = jax.lax.top_k(jnp.asarray(masked0.numpy()), k)
        np.testing.assert_array_equal(np.asarray(ref_idx), cand.numpy())
        np.testing.assert_array_equal(nf0.numpy(), [86, 10])

    def test_starved_key_with_duplicates(self):
        """test_compaction_survives_starved_key_with_duplicates' inputs:
        key 0 is eligible on 2 rows only, key 1 broadly."""
        n, t, p = 512, 2, 64
        rng = np.random.default_rng(9)
        d = dict(
            capacity=rng.uniform(1000, 4000, (n, 5)).astype(np.float32),
            score_cap=rng.uniform(800, 3800, (n, 2)).astype(np.float32),
            usage=rng.uniform(0, 300, (n, 5)).astype(np.float32),
            job_counts=np.zeros(n, np.int32),
            noise=(rng.random(n) * 1e-3).astype(np.float32),
            banned0=np.zeros(n, bool))
        tg_masks = np.zeros((t, n), bool)
        tg_masks[0, [3, 200]] = True
        tg_masks[1] = rng.random(n) < 0.95
        kd = np.array([[30, 40, 0, 0, 0], [20, 25, 0, 0, 0]], np.float32)
        tg_ids = np.asarray([0] * 4 + [1] * 60, np.int32)
        valid = np.ones(p, bool)
        reset = np.zeros(p, bool)
        ref = jk.place_batch(d["capacity"], d["score_cap"], d["usage"],
                             tg_masks, d["job_counts"], kd[tg_ids], tg_ids,
                             valid, d["noise"], np.float32(10.0),
                             np.asarray(False), d["banned0"])
        port = tk.place_batch_keyed(
            None, _t(d["capacity"]), _t(d["score_cap"]), _t(d["usage"]),
            _t(tg_masks), _t(d["job_counts"]), _t(kd), _t(tg_ids), _t(valid),
            _t(d["noise"]), 10.0, False, _t(d["banned0"]), _t(reset), p)
        assert_same_placements(ref.packed, ref.usage_after, port.packed,
                               port.usage_after)

        # The per-key trim (K3) fires only when more than T * K candidates
        # arrive, as from a mesh's shards: merge 8 row shards' own top-K and
        # replay over the trimmed table. Rows must not vanish.
        w = [_t(d[k_]) for k_ in ("capacity", "score_cap", "usage")]
        masked0, nf0, _ = tk.score_topk_plain(
            *w, _t(tg_masks), _t(d["job_counts"]), _t(kd), _t(d["noise"]),
            10.0, False, _t(d["banned0"]), n)
        shard = n // 8
        cand = torch.cat([
            torch.sort(masked0[:, i * shard:(i + 1) * shard], dim=1,
                       descending=True, stable=True).indices[:, :p] + i * shard
            for i in range(8)]).to(torch.int32)
        rows, keep = tk.merge_candidates_plain(cand, masked0, p)
        assert rows.numel() == t * p  # the trim ran
        packed, usage = tk.placement_chain_plain(
            *w, _t(tg_masks), _t(d["job_counts"]), _t(kd), _t(tg_ids),
            _t(valid), _t(d["noise"]), 10.0, False, _t(d["banned0"]),
            reset=_t(reset), rows=rows, keep=keep, masked0=masked0, nf0=nf0)
        assert_same_placements(ref.packed, ref.usage_after, packed, usage)


class TestMulti:
    def test_multi_matches_jax(self):
        """TestMultiKernelParity's window: 5 evals of 16 placements, 8
        resource dims, per-eval resets."""
        rng = np.random.default_rng(11)
        n, p, t, evals = 256, 16, 3, 5
        capacity = rng.uniform(500, 3000, (n, 8)).astype(np.float32)
        score_cap = capacity[:, :2].copy()
        usage0 = (capacity * rng.uniform(0, 0.5, (n, 8))).astype(np.float32)
        tg_masks = rng.random((t, n)) < 0.8
        jc0 = np.zeros(n, np.int32)
        demands = rng.uniform(1, 200, (p, 8)).astype(np.float32)
        tg_ids = rng.integers(0, t, p).astype(np.int32)
        noise = (rng.random(n) * 1e-3).astype(np.float32)
        banned0 = np.zeros(n, bool)
        reset = np.zeros(evals * p, bool)
        reset[::p] = True
        args = (capacity, score_cap, usage0, tg_masks, jc0,
                np.tile(demands, (evals, 1)), np.tile(tg_ids, evals),
                np.ones(evals * p, bool), noise)
        ref = jk.place_batch_multi(*args, np.float32(10.0), np.asarray(True),
                                   banned0, reset)
        port = tk.place_batch_multi(*[_t(a) for a in args], 10.0, True,
                                    _t(banned0), _t(reset))
        assert_same_placements(ref.packed, ref.usage_after, port.packed,
                               port.usage_after)


class TestHost:
    """TestHostKernelParity's inputs: the port's numpy mirror and its
    plain scan against JAX's scan."""

    def _inputs(self, seed, n=256, p=48, t=8):
        rng = np.random.default_rng(seed)
        capacity = rng.uniform(100, 4000, (n, 8)).astype(np.float32)
        usage = (capacity * rng.uniform(0, 0.9, (n, 8))).astype(np.float32)
        score_cap = capacity[:, :2] * rng.uniform(
            0.5, 1.0, (n, 2)).astype(np.float32)
        return dict(
            capacity=capacity, score_cap=score_cap, usage=usage,
            tg_masks=rng.random((t, n)) < 0.7,
            job_counts=rng.integers(0, 3, n).astype(np.int32),
            demands=rng.uniform(1, 500, (p, 8)).astype(np.float32),
            tg_ids=rng.integers(0, t, p).astype(np.int32),
            valid=rng.random(p) < 0.9,
            noise=(rng.random(n) * 1e-3).astype(np.float32),
            penalty=10.0, distinct=True, banned0=rng.random(n) < 0.05)

    @pytest.mark.parametrize("seed", [0, 7, 42])
    def test_scan_and_host_match_jax(self, seed):
        d = self._inputs(seed)
        ref, port = _run_scan_both(d)
        assert_same_placements(ref.packed, ref.usage_after, port.packed,
                               port.usage_after)
        host = tk.place_batch_host(*_scan_args(d))
        rp = np.asarray(ref.packed)
        np.testing.assert_array_equal(rp[:, 0], host.packed[:, 0])
        np.testing.assert_array_equal(rp[:, 2], host.packed[:, 2])

    def test_distinct_hosts_off(self):
        d = self._inputs(3)
        d["distinct"] = False
        ref, port = _run_scan_both(d)
        assert_same_placements(ref.packed, ref.usage_after, port.packed,
                               port.usage_after)

    def test_compact_host(self):
        packed = np.array([[3, 1.5, 7], [-1, -np.inf, 6], [0, 0, 0]],
                          np.float32)
        ref = jk.compact_host(packed, 2)
        got = tk.compact_host(packed, 2)
        np.testing.assert_array_equal(ref.chosen, got.chosen)
        assert (ref.nf_last, ref.ok) == (got.nf_last, got.ok) == (6, False)


# ------------------------------------------- K3 as the card runs it


K3_TILE = 1024   # csrc/keyed.cu kTileKeys


def _k3_model(cand):
    """K3's untrimmed merge (csrc/keyed.cu k3_tile_sort, k3_place) in
    numpy. The flat candidates become keys row << 32 | position, cut into
    tiles of 1,024 padded with ~0, and each tile goes through the kernel's
    bitonic network: at stage (k, j) position i meets position i ^ j and
    keeps the smaller key when (i & j == 0) == (i & k == 0). Then
    each key's index in the merged order is its rank in its tile plus, per
    other tile, the count of keys below it (a search by powers of two from
    1,024); the largest such key over all tiles is its predecessor, whose
    row decides keep. Returns (rows int32, keep bool)."""
    flat = np.asarray(cand).reshape(-1).astype(np.int64)
    n = flat.size
    n_tiles = -(-n // K3_TILE)
    keys = (flat.astype(np.uint64) << np.uint64(32)) | np.arange(
        n, dtype=np.uint64)
    buf = np.full(n_tiles * K3_TILE, np.iinfo(np.uint64).max, np.uint64)
    buf[:n] = keys
    buf = buf.reshape(n_tiles, K3_TILE)
    lane = np.arange(K3_TILE)
    k = 2
    while k <= K3_TILE:
        j = k // 2
        while j > 0:
            other = buf[:, lane ^ j]
            keep_min = ((lane & j) == 0) == ((lane & k) == 0)
            buf = np.where(keep_min, np.minimum(buf, other),
                           np.maximum(buf, other))
            j //= 2
        k *= 2
    assert (buf[:, 1:] >= buf[:, :-1]).all()   # ~0 padding repeats
    key = buf.reshape(-1)
    g = np.repeat(np.arange(n_tiles), K3_TILE)
    jj = np.tile(lane, n_tiles)
    dst = jj.copy()
    has_pred = jj > 0
    pred = np.where(has_pred, key[np.maximum(np.arange(key.size) - 1, 0)],
                    0).astype(np.uint64)
    for h in range(n_tiles):
        other = g != h
        lo = np.zeros(key.size, np.int64)
        step = K3_TILE
        while step > 0:
            probe = lo + step
            hit = (probe <= K3_TILE) & (
                buf[h][np.minimum(probe, K3_TILE) - 1] < key)
            lo = np.where(hit, probe, lo)
            step //= 2
        assert (lo == np.searchsorted(buf[h], key)).all()
        take = other & (lo > 0)
        dst = np.where(other, dst + lo, dst)
        below = buf[h][np.maximum(lo - 1, 0)]
        better = take & (~has_pred | (below > pred))
        pred = np.where(better, below, pred)
        has_pred |= take
    real = g * K3_TILE + jj < n
    assert sorted(dst[real]) == list(range(n))
    rows = np.empty(n, np.int32)
    keep = np.empty(n, bool)
    rows[dst[real]] = (key[real] >> np.uint64(32)).astype(np.int32)
    keep[dst[real]] = (~has_pred | ((pred >> np.uint64(32))
                                    != (key >> np.uint64(32))))[real]
    return rows, keep


def _jax_merge(cand, masked0, k_cand):
    """The reference's merge (nomad_tpu/scheduler/kernels.py:444-506) on
    the candidate rows, in jnp: a stable argsort by row, first-occurrence
    keep and, when T * k_trim < n_cand, each key's lax.top_k of the
    window-start scores with duplicates at -inf, re-sorted by row with keep
    rebuilt."""
    import jax

    rows_g = jnp.asarray(np.asarray(cand).reshape(-1))
    rows_s = rows_g[jnp.argsort(rows_g, stable=True)]
    keep = jnp.concatenate([jnp.ones((1,), bool), rows_s[1:] != rows_s[:-1]])
    n_keys, n_cand = masked0.shape[0], rows_g.shape[0]
    k_trim = min(k_cand, n_cand)
    if n_keys * k_trim < n_cand:
        masked0c = jnp.where(keep[None, :],
                             jnp.asarray(np.asarray(masked0))[:, rows_s],
                             -jnp.inf)
        _, tidx = jax.lax.top_k(masked0c, k_trim)
        sel = tidx.reshape(-1)
        sel = sel[jnp.argsort(rows_s[sel], stable=True)]
        rows_s = rows_s[sel]
        keep = jnp.concatenate([jnp.ones((1,), bool),
                                rows_s[1:] != rows_s[:-1]])
    return np.asarray(rows_s), np.asarray(keep)


def _k3_case(n, t, k_cand, seed):
    """K2's plain outputs over a varied fleet: masked0 [T, n] and each
    key's top-min(k, n) rows (keys share rows: duplicates across keys)."""
    _, d = _keyed_inputs(n=n, t=t, seed=seed)
    masked0, _, cand = tk.score_topk_plain(
        *[_t(d[k]) for k in ("capacity", "score_cap", "usage", "tg_masks",
                             "job_counts", "key_demands", "noise")],
        10.0, False, _t(d["banned0"]), k_cand)
    return cand, masked0


# (rows, keys, k): the served window (T = 1, 4,096 candidates, 4 tiles),
# one tile, T > 1 with rows shared across keys, n_cand no multiple of the
# tile, 8 tiles (k3_place stages 4 at a time), 12 tiles, and k above the
# rows (kc = n).
K3_CASES = [(16384, 1, 4096), (2048, 1, 64), (1024, 3, 256),
            (4096, 3, 700), (8192, 2, 4096), (8192, 3, 4096),
            (300, 2, 512)]


@pytest.mark.parametrize("n,t,k", K3_CASES)
def test_merge_model_matches_plain_and_reference(n, t, k):
    cand, masked0 = _k3_case(n, t, k, seed=n + t)
    rows, keep = tk.merge_candidates_plain(cand, masked0, k)
    model = _k3_model(cand.numpy())
    ref = _jax_merge(cand.numpy(), masked0.numpy(), k)
    assert rows.numel() == cand.numel()   # the trim does not fire
    for got in (model, (rows.numpy(), keep.numpy())):
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
    if t > 1:
        assert 0 < keep.sum() < keep.numel()   # duplicates across keys


def test_merge_trim_matches_reference():
    """The per-key trim (csrc/keyed.cu k3_merge), which no path of the port
    runs: candidates of 8 row shards' own top-64 for 2 keys."""
    n, t, k = 4096, 2, 64
    cand0, masked0 = _k3_case(n, t, n, seed=5)
    shard = n // 8
    cand = torch.cat([
        torch.sort(masked0[:, i * shard:(i + 1) * shard], dim=1,
                   descending=True, stable=True).indices[:, :k] + i * shard
        for i in range(8)]).to(torch.int32)
    rows, keep = tk.merge_candidates_plain(cand, masked0, k)
    assert rows.numel() == t * k
    ref = _jax_merge(cand.numpy(), masked0.numpy(), k)
    np.testing.assert_array_equal(rows.numpy(), ref[0])
    np.testing.assert_array_equal(keep.numpy(), ref[1])


class TestWrapperRouting:
    def test_cpu_tensors_take_the_plain_version(self):
        native.reset_counts()
        rng, d = _keyed_inputs(n=128, t=2)
        tg_ids = np.zeros(8, np.int32)
        valid = np.ones(8, bool)
        tk.place_batch_keyed(
            None, *[_t(d[k]) for k in ("capacity", "score_cap", "usage",
                                       "tg_masks", "job_counts",
                                       "key_demands")],
            _t(tg_ids), _t(valid), _t(d["noise"]), 10.0, False,
            _t(d["banned0"]), _t(np.zeros(8, bool)), 8)
        assert native.PLAIN_CALLS["score_topk"] == 1
        assert native.PLAIN_CALLS["merge_candidates"] == 1
        assert native.PLAIN_CALLS["placement_chain"] == 1
        assert not any(native.LAUNCHES.values())

    def test_plain_versions_switch_is_scoped(self):
        assert not native.plain_on_card
        with pytest.raises(RuntimeError):
            with native.plain_versions():
                assert native.plain_on_card
                raise RuntimeError("leaves the block")
        assert not native.plain_on_card

    def test_mixed_devices_raise(self):
        with pytest.raises(ValueError):
            tk._on_cuda(torch.zeros(1), torch.zeros(1, device="meta"))

    def test_mesh_waits_for_its_slice(self):
        """Logical shards of one device run (tests/test_torch_mesh.py); a
        mesh over distinct devices waits for the multi-card mesh item and
        raises instead of folding onto one device."""
        from nomad_tpu_torch.parallel import SchedulingMesh

        with pytest.raises(NotImplementedError, match="multi-card"):
            tk.place_batch_keyed(SchedulingMesh(["cpu", "cuda:1"]),
                                 *([None] * 13), n_valid=1)


# ------------------------------------------------ kernels on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,p,n_valid,distinct,starved",
                         [(16384, 1, 64, 50, False, False),
                          (1024, 3, 256, 250, True, False),
                          (4096, 2, 1024, 1000, False, False),
                          (64, 2, 128, 128, True, False),    # K > N rows
                          (1024, 2, 64, 64, False, True)])   # -inf ties
def test_keyed_kernels_match_plain_on_card(cuda_device, n, t, p, n_valid,
                                           distinct, starved):
    rng, d = _keyed_inputs(n=n, t=t, seed=n)
    if starved:
        d["tg_masks"][0] = False
        d["tg_masks"][0, [5, 700]] = True
    tg_ids = rng.integers(0, t, p).astype(np.int32)
    valid = np.zeros(p, bool)
    valid[:n_valid] = True
    reset = np.zeros(p, bool)
    reset[::32] = True
    args = [_t(d[k], cuda_device) for k in (
        "capacity", "score_cap", "usage", "tg_masks", "job_counts",
        "key_demands")] + [_t(tg_ids, cuda_device), _t(valid, cuda_device),
                           _t(d["noise"], cuda_device)]
    tail = (10.0, distinct, _t(d["banned0"], cuda_device),
            _t(reset, cuda_device), n_valid)
    got = tk.place_batch_keyed(None, *args, *tail)
    with native.plain_versions():
        ref = tk.place_batch_keyed(None, *args, *tail)
    torch.cuda.synchronize()
    assert torch.equal(got.packed, ref.packed)
    assert torch.equal(got.usage_after, ref.usage_after)


@pytest.mark.cuda
@pytest.mark.parametrize("multi", [False, True])
def test_scan_kernel_matches_plain_on_card(cuda_device, multi):
    rng, d = _keyed_inputs(n=2048, t=3, seed=5)
    p = 128
    tg_ids = rng.integers(0, 3, p).astype(np.int32)
    demands = d["key_demands"][tg_ids]
    valid = np.ones(p, bool)
    reset = np.zeros(p, bool)
    reset[::32] = True
    args = [_t(a, cuda_device) for a in (
        d["capacity"], d["score_cap"], d["usage"], d["tg_masks"],
        d["job_counts"], demands, tg_ids, valid, d["noise"])]
    extra = (_t(reset, cuda_device),) if multi else ()
    fn = tk.place_batch_multi if multi else tk.place_batch
    got = fn(*args, 10.0, True, _t(d["banned0"], cuda_device), *extra)
    with native.plain_versions():
        ref = fn(*args, 10.0, True, _t(d["banned0"], cuda_device), *extra)
    assert torch.equal(got.packed, ref.packed)
    assert torch.equal(got.usage_after, ref.usage_after)


# ---------------------------------------------------------------- K5


def _compact_inputs(e, p, seed):
    """A window's packed3 as the placement programs leave it: chosen rows
    (some -1 = no row), scores (-inf where no row), n_feasible counts; an
    invalid tail per eval and last_idx at each eval's last valid step."""
    rng = np.random.default_rng(seed)
    n_valid = rng.integers(1, p + 1, e)
    valid = np.arange(p)[None, :] < n_valid[:, None]
    rows = rng.integers(0, 4096, (e, p)).astype(np.float32)
    failed = rng.random((e, p)) < 0.1
    if e > 1:
        failed[0] = False   # one eval that placed everything
        failed[-1, 0] = True  # and one whose first placement found no row
    rows[failed] = -1.0
    rows[~valid] = -1.0     # padding steps choose no row
    scores = rng.uniform(0, 18, (e, p)).astype(np.float32)
    scores[rows < 0] = -np.inf
    nf = rng.integers(0, 4096, (e, p)).astype(np.float32)
    packed3 = np.stack([rows, scores, nf], axis=-1).astype(np.float32)
    last_idx = (n_valid - 1).astype(np.int32)
    return packed3, valid, last_idx


@pytest.mark.parametrize("e", [1, 3, 64])
@pytest.mark.parametrize("p", [8, 64])
def test_compact_window_plain_matches_jax(e, p):
    """K5's plain version equals the JAX compact_window exactly: chosen,
    nf_last and ok equal, scores bit-identical (-inf included)."""
    packed3, valid, last_idx = _compact_inputs(e, p, seed=e * 100 + p)
    ref = jk.compact_window(jnp.asarray(packed3), jnp.asarray(valid),
                            jnp.asarray(last_idx))
    before = native.PLAIN_CALLS["compact_window"]
    got = tk.compact_window(_t(packed3), _t(valid), _t(last_idx))
    assert native.PLAIN_CALLS["compact_window"] == before + 1
    r_chosen, r_scores, r_nf, r_ok = (np.asarray(a) for a in ref)
    g_chosen, g_scores, g_nf, g_ok = (a.numpy() for a in got)
    assert g_chosen.dtype == np.int32 and g_nf.dtype == np.int32
    assert g_ok.dtype == np.bool_ and g_scores.dtype == np.float32
    np.testing.assert_array_equal(g_chosen, r_chosen)
    np.testing.assert_array_equal(g_scores.view(np.uint32),
                                  r_scores.view(np.uint32))
    np.testing.assert_array_equal(g_nf, r_nf)
    np.testing.assert_array_equal(g_ok, r_ok)
    if e > 1:   # non-vacuous: both outcomes of ok occur
        assert r_ok.any() and not r_ok.all()


def test_compact_window_matches_compact_host_per_eval():
    """The window reduction and the numpy mirror of one eval agree."""
    packed3, valid, last_idx = _compact_inputs(5, 16, seed=9)
    chosen, scores, nf, ok = tk.compact_window(_t(packed3), _t(valid),
                                               _t(last_idx))
    for k in range(5):
        cr = tk.compact_host(packed3[k], int(last_idx[k]) + 1)
        np.testing.assert_array_equal(cr.chosen, chosen[k].numpy())
        np.testing.assert_array_equal(cr.scores, scores[k].numpy())
        assert cr.nf_last == int(nf[k]) and cr.ok == bool(ok[k])


def _split_block(block, e, p):
    """K5's output block split back into its four parts by byte offset:
    chosen and scores [E, P] at 0 and the next 16-byte boundary, then
    nf_last [E] and ok [E] each on its own 16-byte boundary."""
    raw = block.numpy()

    def align(x):
        return (x + 15) // 16 * 16

    o_scores = align(4 * e * p)
    o_nf = align(o_scores + 4 * e * p)
    o_ok = align(o_nf + 4 * e)
    assert block.numel() == align(o_ok + e)
    return (raw[:4 * e * p].view(np.int32).reshape(e, p),
            raw[o_scores:o_scores + 4 * e * p].view(np.float32).reshape(e, p),
            raw[o_nf:o_nf + 4 * e].view(np.int32),
            raw[o_ok:o_ok + e].view(np.bool_))


@pytest.mark.parametrize("e", [1, 16, 64])
@pytest.mark.parametrize("p", [16, 64, 4096])
def test_compact_block_matches_plain_and_jax(e, p):
    """compact_window into one output block (what the served drain hands
    K5): the block split back into its four parts equals the plain version
    and the JAX compact_window, scores bit for bit, the rest exactly; the
    returned tensors are views of the block."""
    packed3, valid, last_idx = _compact_inputs(e, p, seed=7 * e + p)
    block = tk.compact_block(e, p, torch.device("cpu"))
    got = tk.compact_window(_t(packed3), _t(valid), _t(last_idx), out=block)
    base = block.untyped_storage().data_ptr()
    assert all(v.untyped_storage().data_ptr() == base for v in got)
    plain = tk.compact_window_plain(_t(packed3), _t(valid), _t(last_idx))
    ref = jk.compact_window(jnp.asarray(packed3), jnp.asarray(valid),
                            jnp.asarray(last_idx))
    parts = _split_block(block, e, p)
    for part, view, pl, r in zip(parts, got, plain, ref):
        r = np.asarray(r)
        assert part.dtype == r.dtype and part.shape == r.shape
        if part.dtype == np.float32:
            part, r = part.view(np.uint32), r.view(np.uint32)
            pl = pl.numpy().view(np.uint32)
        np.testing.assert_array_equal(part, r)
        np.testing.assert_array_equal(part, pl)
        np.testing.assert_array_equal(view.numpy().view(part.dtype), part)


@pytest.mark.cuda
@pytest.mark.parametrize("e,p", [(64, 64), (16, 64), (64, 4096), (1, 8)])
def test_compact_window_kernel_matches_plain_on_card(cuda_device, e, p):
    packed3, valid, last_idx = _compact_inputs(e, p, seed=e + p)
    args = (_t(packed3, cuda_device), _t(valid, cuda_device),
            _t(last_idx, cuda_device))
    before = native.LAUNCHES["compact_window"]
    got = tk.compact_window(*args)
    assert native.LAUNCHES["compact_window"] == before + 1
    ref = tk.compact_window_plain(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.is_contiguous()
        assert torch.equal(g.view(torch.int32) if g.dtype == torch.float32
                           else g,
                           r.view(torch.int32) if r.dtype == torch.float32
                           else r)


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,k", K3_CASES)
def test_merge_kernel_matches_plain_and_model_on_card(cuda_device, n, t, k):
    cand, masked0 = _k3_case(n, t, k, seed=n + t)
    got = tk.merge_candidates(cand.to(cuda_device), masked0.to(cuda_device),
                              k)
    torch.cuda.synchronize()
    ref = tk.merge_candidates_plain(cand, masked0, k)
    model = _k3_model(cand.numpy())
    for g, r, m in zip(got, ref, model):
        np.testing.assert_array_equal(g.cpu().numpy(), r.numpy())
        np.testing.assert_array_equal(g.cpu().numpy(), m)


@pytest.mark.cuda
def test_merge_trim_kernel_matches_plain_on_card(cuda_device):
    n, t, k = 4096, 2, 64
    _, masked0 = _k3_case(n, t, n, seed=5)
    shard = n // 8
    cand = torch.cat([
        torch.sort(masked0[:, i * shard:(i + 1) * shard], dim=1,
                   descending=True, stable=True).indices[:, :k] + i * shard
        for i in range(8)]).to(torch.int32)
    got = tk.merge_candidates(cand.to(cuda_device), masked0.to(cuda_device),
                              k)
    torch.cuda.synchronize()
    ref = tk.merge_candidates_plain(cand, masked0, k)
    assert got[0].numel() == t * k
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.cpu().numpy(), r.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("e,p", [(64, 64), (16, 64), (64, 4096), (1, 8)])
def test_compact_window_kernel_writes_a_pinned_block(cuda_device, e, p):
    """K5 writes its outputs in place into one pinned host block, which is
    ready after an event recorded behind it: bit for bit the plain
    version. A pageable block raises."""
    packed3, valid, last_idx = _compact_inputs(e, p, seed=3 * e + p)
    args = (_t(packed3, cuda_device), _t(valid, cuda_device),
            _t(last_idx, cuda_device))
    block = tk.compact_block(e, p, cuda_device)
    assert block.is_pinned()
    before = native.LAUNCHES["compact_window"]
    got = tk.compact_window(*args, out=block)
    assert native.LAUNCHES["compact_window"] == before + 1
    ready = torch.cuda.Event()
    ready.record()
    ready.synchronize()
    ref = [r.cpu() for r in tk.compact_window_plain(*args)]
    for g, r in zip(got, ref):
        assert g.device.type == "cpu" and g.dtype == r.dtype
        assert torch.equal(g.view(torch.int32) if g.dtype == torch.float32
                           else g,
                           r.view(torch.int32) if r.dtype == torch.float32
                           else r)
    with pytest.raises(ValueError, match="pageable"):
        tk.compact_window(*args, out=torch.empty(block.numel(),
                                                 dtype=torch.uint8))
