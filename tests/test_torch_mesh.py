"""The port's shard-local keyed mesh pipeline held against nomad_tpu's.

The JAX side runs on the 8 virtual CPU devices tests/conftest.py forces. On
this jax, `_MeshKeyedProgram` passes `check_rep=` to `shard_map`, whose
keyword is now `check_vma=`; the `jax_mesh` fixture renames it for the
duration of one test by patching `nomad_tpu.scheduler.kernels._shard_map`
(nothing in nomad_tpu changes), and clears the reference's mesh program
cache before and after, so no program built under the shim outlives the
test. The port's mesh is 8 logical shards of the CPU (`scheduling_mesh(
["cpu"] * 8)`), where every wrapper runs its plain PyTorch version; the
tests marked `cuda` hold K6-K10 against those plain versions on the card.

Tolerances: chosen rows, n_feasible, usage, keep, tau, nf0, the ring and
the flags are exact; scores agree with JAX within 4e-6 absolute (see
test_torch_kernels.py). Against the port's own single-device keyed path
the mesh is bit for bit on every output.
"""

import inspect
import sys
import threading

import numpy as np
import pytest
import torch

import jax

from nomad_tpu.parallel import mesh as jparallel
from nomad_tpu.scheduler import kernels as jk

import nomad_tpu_torch.scheduler.stack as tstack
from nomad_tpu_torch import mock as tmock
from nomad_tpu_torch import native
from nomad_tpu_torch.convert import mesh_state_from_numpy
from nomad_tpu_torch.parallel import (
    SchedulingMesh,
    node_shards,
    place_batch_sharded,
    pow2_prefix,
    scheduling_mesh,
)
from nomad_tpu_torch.resilience import failpoints as tfailpoints
from nomad_tpu_torch.scheduler import kernels as tk
from nomad_tpu_torch.server import Server as TServer
from nomad_tpu_torch.server import ServerConfig as TServerConfig
from nomad_tpu_torch.server.pipelined_worker import PipelinedWorker
from nomad_tpu_torch.tensor import NodeTensor
from nomad_tpu_torch.tensor.node_table import alloc_vec, resources_vec

from helpers import wait_for

SCORE_TOL = 4e-6
SHARDS = 8
PEN = np.float32(10.0)
# The reference's warm path pins its static inputs by object identity, so
# every window of a chain passes these same objects.
_DISTINCT = np.asarray(True)
PARKED_TTL = dict(min_heartbeat_ttl=3600.0, heartbeat_grace=3600.0)


@pytest.fixture
def jax_mesh(monkeypatch):
    """The reference's 8-device CPU mesh with its mesh program buildable:
    `check_rep` renamed to `check_vma` where shard_map takes the latter."""
    orig = jk._shard_map
    params = inspect.signature(jax.shard_map).parameters \
        if hasattr(jax, "shard_map") else {}

    def shard_map(*args, **kwargs):
        if "check_rep" in kwargs and "check_vma" in params \
                and "check_rep" not in params:
            kwargs["check_vma"] = kwargs.pop("check_rep")
        return orig(*args, **kwargs)

    monkeypatch.setattr(jk, "_shard_map", shard_map)
    jk._mesh_keyed_program.cache_clear()
    tk._mesh_keyed_program.cache_clear()
    jk.mesh_stats_drain()
    tk.mesh_stats_drain()
    yield jparallel.scheduling_mesh(jax.devices()[:SHARDS])
    jk._mesh_keyed_program.cache_clear()
    tk._mesh_keyed_program.cache_clear()


def _tmesh(n=SHARDS):
    return scheduling_mesh(["cpu"] * n)


def _t(a):
    return torch.tensor(np.asarray(a))


def _fleet(n, t, seed, distinct_bans=True):
    rng = np.random.default_rng(seed)
    return dict(
        capacity=rng.uniform(1000, 4000, (n, 5)).astype(np.float32),
        score_cap=rng.uniform(800, 3800, (n, 2)).astype(np.float32),
        usage=rng.uniform(0, 300, (n, 5)).astype(np.float32),
        tg_masks=rng.random((t, n)) < 0.9,
        job_counts=rng.integers(0, 3, n).astype(np.int32),
        key_demands=rng.uniform(10, 60, (t, 5)).astype(np.float32),
        noise=(rng.random(n) * 1e-3).astype(np.float32),
        banned0=(rng.random(n) < 0.05) if distinct_bans
        else np.zeros(n, bool),
    )


def _steps(t, p, n_valid, seed, reset_every=16):
    rng = np.random.default_rng(seed)
    tg_ids = rng.integers(0, t, p).astype(np.int32)
    valid = np.zeros(p, bool)
    valid[:n_valid] = True
    reset = np.zeros(p, bool)
    reset[::reset_every] = True
    return tg_ids, valid, reset


def _ring(cap, n, seed, filled):
    """A pending ring [cap, 6] with `filled` entries: rows over every
    shard, some repeated (last write must win), the rest -1."""
    rng = np.random.default_rng(seed)
    ring = np.full((cap, 6), -1.0, np.float32)
    rows = rng.integers(0, n, filled)
    rows[filled // 2:filled // 2 + 8] = rows[:8]        # repeats
    ring[:filled, 0] = rows
    ring[:filled, 1:] = rng.uniform(0, 500, (filled, 5))
    return ring


def _scores_close(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(fin, np.isfinite(got))
    np.testing.assert_allclose(got[fin], ref[fin], rtol=0, atol=SCORE_TOL)


def _assert_packed(ref, got, valid=None):
    ref, got = np.asarray(ref), np.asarray(got)
    v = np.ones(len(ref), bool) if valid is None else np.asarray(valid)
    np.testing.assert_array_equal(ref[:, 0], got[:, 0])
    np.testing.assert_array_equal(ref[v, 2], got[v, 2])
    _scores_close(ref[:, 1], got[:, 1])


class _Jax:
    """The reference's stages on its 8-device mesh, inputs committed the
    way _place_batch_keyed_mesh commits them."""

    def __init__(self, mesh, k_cand, d):
        self.prog = jk._mesh_keyed_program(mesh, k_cand)
        p = self.prog
        put = jax.device_put
        self.cap = put(d["capacity"], p.node_sharding)
        self.sc = put(d["score_cap"], p.node_sharding)
        self.usage = put(d["usage"], p.node_sharding)
        self.counts = put(d["job_counts"], p.node_sharding)
        self.noise = put(d["noise"], p.node_sharding)
        self.banned = put(d["banned0"], p.node_sharding)
        self.masks = put(d["tg_masks"], p.mask_sharding)
        self.kd = put(d["key_demands"], p.rep_sharding)
        self.pen = put(PEN, p.rep_sharding)
        self.table = p.pack_fn(self.cap, self.sc, self.counts, self.noise,
                               self.banned)

    def cold(self, distinct, ring):
        p = self.prog
        return p.a_cold(self.table, self.usage, self.masks, self.kd,
                        self.pen, jax.device_put(np.asarray(distinct),
                                                 p.rep_sharding),
                        jax.device_put(ring, p.rep_sharding))


class _Port:
    def __init__(self, k_cand, d):
        self.prog = tk._mesh_keyed_program(_tmesh(), k_cand)
        self.d = {k: _t(v) for k, v in d.items()}
        d = self.d
        self.table = self.prog.table(d["capacity"], d["score_cap"],
                                     d["job_counts"], d["noise"],
                                     d["banned0"])


# ------------------------------------------------------------- stages


def test_pack_matches_reference(jax_mesh):
    d = _fleet(1024, 2, 1)
    j, p = _Jax(jax_mesh, 64, d), _Port(64, d)
    np.testing.assert_array_equal(np.asarray(j.table), p.table.numpy())
    assert p.table.shape == (1024, 10)


def test_ring_apply_matches_reference(jax_mesh):
    n = 1024
    d = _fleet(n, 2, 2)
    j, p = _Jax(jax_mesh, 64, d), _Port(64, d)
    ring = _ring(j.prog.ring_cap, n, 3, 300)
    ref = j.prog.apply_fn(j.usage, jax.device_put(ring,
                                                  j.prog.rep_sharding))
    got = p.prog.apply_fn(p.d["usage"], _t(ring))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    # Last write wins on a repeated row.
    row = int(ring[0, 0])
    last = np.nonzero(ring[:, 0] == row)[0][-1]
    np.testing.assert_array_equal(got[row].numpy(), ring[last, 1:])


@pytest.mark.parametrize("distinct", [False, True])
def test_cold_stage_matches_reference(jax_mesh, distinct):
    n, t = 4096, 2
    d = _fleet(n, t, 4)
    j, p = _Jax(jax_mesh, 64, d), _Port(64, d)
    ring = _ring(j.prog.ring_cap, n, 5, 200)
    pkt, usage_tail, nf, vals = j.cold(distinct, ring)
    pkts, tail, nfs, tvals = p.prog.a_cold(
        p.table, p.d["usage"], p.d["tg_masks"], p.d["key_demands"],
        float(PEN), distinct, _t(ring))
    b = 128  # min(2k, n_loc)
    # One call over every shard, already in the exchange's layout.
    assert pkts.shape == (SHARDS * t * b, 6 + 10 + t)
    np.testing.assert_array_equal(np.asarray(pkt), pkts.numpy())
    np.testing.assert_array_equal(np.asarray(usage_tail), tail.numpy())
    np.testing.assert_array_equal(np.asarray(nf), nfs.numpy())
    _scores_close(np.asarray(vals), tvals.numpy())
    # The exchange lands every shard's packet on the lead device.
    cand, nf_all, vals_all = p.prog.exchange(pkts, nfs, tvals)
    assert cand.shape == (SHARDS * t * b, 18)
    assert nf_all.shape == (SHARDS, t) and vals_all.shape == (SHARDS, t, b)


def test_pool_build_matches_reference(jax_mesh):
    n, t = 4096, 2
    d = _fleet(n, t, 6)
    j = _Jax(jax_mesh, 64, d)
    pkt, _, nf, vals = j.cold(False, jk._ring_zero(j.prog.ring_cap, 5))
    ref = j.prog.pool_build(pkt, nf, vals, np.asarray(d["key_demands"]))
    st = mesh_state_from_numpy(
        {"packet": np.asarray(pkt), "nf": np.asarray(nf),
         "vals": np.asarray(vals)}, device="cpu")
    got = tk.pool_build(st["packet"], st["nf"], st["vals"],
                        _t(d["key_demands"]))
    for name, a, b in zip(("pool_use", "keep", "tau", "nf0"), ref[1:],
                          got[:4]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    # The columns K2 and K4a read are the reference pool's.
    cols = tk.pool_columns(_t(ref[0]), _t(ref[2]), 5, t)
    for name, want in cols.items():
        np.testing.assert_array_equal(want.numpy(),
                                      getattr(got, name).numpy(),
                                      err_msg=name)
    # Duplicates across keys exist and only first occurrences are kept.
    keep = got.keep.numpy()
    assert 0 < keep.sum() < len(keep)
    # The table columns mask eligibility with keep.
    assert not got.elig[:, ~got.keep].any()


@pytest.mark.parametrize("ring_n", [0, 448])
def test_warm_step_matches_reference(jax_mesh, ring_n):
    n, t, p_pad, n_valid = 4096, 2, 64, 60
    d = _fleet(n, t, 7)
    k = tk.keyed_cand_count(n_valid)
    j = _Jax(jax_mesh, k, d)
    pkt, _, nf, vals = j.cold(True, jk._ring_zero(j.prog.ring_cap, 5))
    pool = j.prog.pool_build(pkt, nf, vals, np.asarray(d["key_demands"]))
    ring = _ring(j.prog.ring_cap, n, 8, ring_n)
    tg_ids, valid, reset = _steps(t, p_pad, n_valid, 9)
    ref = j.prog.warm_step(*pool, ring, np.int32(ring_n),
                           np.asarray(d["key_demands"]), tg_ids, valid,
                           reset, PEN, np.asarray(True))
    st = mesh_state_from_numpy(dict(zip(
        ("pool", "pool_use", "keep", "tau", "nf0"),
        (np.asarray(a) for a in pool)), ring=ring), device="cpu")
    prog = tk._mesh_keyed_program(_tmesh(), k)
    got = prog.warm_step(st["pool_state"], st["pool_use"], st["nf0"],
                         st["ring"], ring_n, _t(d["key_demands"]),
                         _t(tg_ids), _t(valid), _t(reset), float(PEN), True)
    packed, pool_use2, nf0_2, ring2, flag = got
    _assert_packed(ref[0], packed)
    np.testing.assert_array_equal(np.asarray(ref[1]), pool_use2.numpy())
    np.testing.assert_array_equal(np.asarray(ref[2]), nf0_2.numpy())
    np.testing.assert_array_equal(np.asarray(ref[3]), ring2.numpy())
    assert float(ref[4]) == float(flag) == 0.0
    assert (packed[:n_valid, 0] >= 0).all()
    # The pool is a true subset of the table here: the certificate mattered.
    assert st["pool_state"].keep.sum() < n


def _jax_chain(mesh, d, steps, windows, n_valid):
    usage, outs = d["usage"], []
    for _ in range(windows):
        res = jk.place_batch_keyed(
            mesh, d["capacity"], d["score_cap"], usage, d["tg_masks"],
            d["job_counts"], d["key_demands"], *steps[:2], d["noise"],
            PEN, _DISTINCT, d["banned0"], steps[2], n_valid)
        outs.append(np.asarray(res.packed))
        usage = res.usage_after
    return outs, np.asarray(usage)


def _port_chain(mesh, d, steps, windows, n_valid):
    d = {k: _t(v) for k, v in d.items()}
    steps = [_t(s) for s in steps]
    usage, outs, flags = d["usage"], [], []
    for _ in range(windows):
        res = tk.place_batch_keyed(
            mesh, d["capacity"], d["score_cap"], usage, d["tg_masks"],
            d["job_counts"], d["key_demands"], *steps[:2], d["noise"],
            float(PEN), True, d["banned0"], steps[2], n_valid)
        outs.append(res.packed.numpy())
        usage = res.usage_after
        flags.append(getattr(usage, "flag", None))
    return outs, np.asarray(usage), flags


def test_chain_cold_warm_overflow_matches_reference(jax_mesh):
    """Six chained windows of 256 padded steps: cold, three warm, a cold
    rebuild when the ring (16 k = 1024 rows) cannot take a fifth window's
    delta (applying the chain's ring on the way), and warm again."""
    n, t, p_pad, n_valid = 4096, 2, 256, 60
    d = _fleet(n, t, 10)
    steps = _steps(t, p_pad, n_valid, 11, reset_every=32)
    ref, ref_u = _jax_chain(jax_mesh, d, steps, 6, n_valid)
    j_stats = jk.mesh_stats_drain()
    one, one_u, _ = _port_chain(None, d, steps, 6, n_valid)
    got, got_u, flags = _port_chain(_tmesh(), d, steps, 6, n_valid)
    t_stats = tk.mesh_stats_drain()
    assert (t_stats["windows"], t_stats["warm_windows"]) == (6, 4)
    assert (j_stats["windows"], j_stats["warm_windows"]) == (6, 4)
    assert t_stats["candidate_bytes"] == j_stats["candidate_bytes"]
    valid = steps[1]
    for w, (r, a, b) in enumerate(zip(ref, one, got)):
        np.testing.assert_array_equal(a, b, err_msg=f"window {w}")
        _assert_packed(r, b, valid)
    np.testing.assert_array_equal(one_u, got_u)
    np.testing.assert_array_equal(ref_u, got_u)
    # Cold windows carry no flag; warm ones carry a certified 0.
    assert [f is None for f in flags] == [True, False, False, False, True,
                                          False]
    assert all(float(f) == 0.0 for f in flags if f is not None)


# ------------------------------------------ K7 and K9 as the card runs them


def _k9_model(cand, nf_all, vals_all, n_keys, r):
    """K9's algorithm (csrc/mesh.cu k9_sort, k9_place) in numpy. One sort
    per segment of B packet rows: keys (row ^ sign bit) << 32 | position,
    padded with ~0 to ld = next_pow2(B), through the bitonic network stage
    by stage. Then each row's final index is its rank in its own segment
    plus, per other segment, the count of keys below it (a search by powers
    of two from the largest power of two <= B); the largest such key over
    all segments is its predecessor in the merged order, which decides
    keep. Returns a PoolState of numpy arrays."""
    s_, _, b = vals_all.shape
    n_seg = s_ * n_keys
    ld = 1 << max(0, (b - 1).bit_length())
    rows = cand[:, 0].astype(np.int32)
    hi = (rows.view(np.uint32) ^ np.uint32(0x80000000)).astype(np.uint64)
    keys = (hi << np.uint64(32)) | np.arange(len(cand), dtype=np.uint64)
    buf = np.full((n_seg, ld), np.iinfo(np.uint64).max, np.uint64)
    buf[:, :b] = keys.reshape(n_seg, b)
    idx = np.arange(ld)
    k = 2
    while k <= ld:
        j = k // 2
        while j > 0:
            ixj = idx ^ j
            lo = idx[ixj > idx]
            a, c = buf[:, lo], buf[:, lo ^ j]
            up = (lo & k) == 0
            swap = (a > c) == up
            buf[:, lo] = np.where(swap, c, a)
            buf[:, lo ^ j] = np.where(swap, a, c)
            j //= 2
        k *= 2
    seg = buf[:, :b]
    assert (seg[:, 1:] > seg[:, :-1]).all()
    top = ld if ld == b else ld // 2
    key = seg.reshape(-1)
    g = np.repeat(np.arange(n_seg), b)
    jj = np.tile(np.arange(b), n_seg)
    dst = jj.copy()
    has_pred = jj > 0
    pred = np.where(has_pred, seg.reshape(-1)[np.maximum(
        np.arange(n_seg * b) - 1, 0)], 0).astype(np.uint64)
    for h in range(n_seg):
        other = g != h
        cnt = np.zeros(n_seg * b, np.int64)
        step = top
        while step > 0:
            probe = cnt + step
            ok = probe <= b
            hit = ok & (seg[h][np.minimum(probe, b) - 1] < key)
            cnt = np.where(hit, probe, cnt)
            step //= 2
        assert (cnt == np.searchsorted(seg[h], key)).all()
        take = other & (cnt > 0)
        dst = np.where(other, dst + cnt, dst)
        below = seg[h][np.maximum(cnt - 1, 0)]
        better = take & (~has_pred | (below > pred))
        pred = np.where(better, below, pred)
        has_pred |= take
    assert sorted(dst) == list(range(n_seg * b))
    kept = ~has_pred | ((pred >> np.uint64(32)) != (key >> np.uint64(32)))
    src = cand[(key & np.uint64(0xffffffff)).astype(np.int64)]
    pool = np.empty_like(cand)
    pool[dst] = src
    keep = np.empty(n_seg * b, bool)
    keep[dst] = kept
    cols = tk.pool_columns(_t(pool), _t(keep), r, n_keys)
    state = tk.PoolState(
        pool_use=pool[:, 3 + r:3 + 2 * r], keep=keep,
        tau=vals_all[:, :, -1].max(axis=0),
        nf0=nf_all.sum(axis=0).astype(np.int32),
        **{name: v.numpy() for name, v in cols.items()})
    return state


def _packets(s, t, b, n_loc, seed, overlap=False, r=5):
    """Exchanged packets [S*T*B, 6+2R+T] as the cold stage lays them: per
    shard and key a segment of B distinct rows of the shard (so the keys of
    one shard share rows), in no row order; every packet row's columns
    differ, so a wrong copy shows. overlap=True draws every shard's rows
    from one range: duplicates across segments of different shards too."""
    rng = np.random.default_rng(seed)
    w = 6 + 2 * r + t
    cand = rng.uniform(0, 100, (s * t * b, w)).astype(np.float32)
    for sh in range(s):
        base = 0 if overlap else sh * n_loc
        for q in range(t):
            seg = slice((sh * t + q) * b, (sh * t + q + 1) * b)
            cand[seg, 0] = base + rng.choice(n_loc, b, replace=False)
    cand[:, 3 + 2 * r] = rng.integers(0, 4, len(cand))
    cand[:, 4 + 2 * r] = rng.random(len(cand)) < 0.2
    cand[:, 6 + 2 * r:] = rng.random((len(cand), t)) < 0.7
    vals = -np.sort(-rng.uniform(-5, 5, (s, t, b)), axis=2).astype(np.float32)
    vals[0, 0, -1] = -np.inf
    nf = rng.integers(0, n_loc + 1, (s, t)).astype(np.int32)
    return cand, nf, vals, rng.uniform(5, 40, (t, r)).astype(np.float32)


# (S, T, B, rows a shard, overlap): T = 3 keys sharing a shard's rows,
# S = 1, 2, 4, 8, B = 1, B = the shard's rows, B not a power of two, rows
# repeated across shards, and a segment beyond K9's shared-memory sort
# (over 16,384 keys, csrc/mesh.cu kSmemSortKeys).
POOL_CASES = [(8, 3, 48, 64, False), (1, 1, 64, 256, False),
              (2, 2, 128, 512, False), (4, 1, 256, 1024, False),
              (8, 1, 2048, 131072, False), (8, 2, 1, 16, False),
              (4, 3, 256, 256, False), (2, 3, 100, 300, False),
              (4, 2, 96, 200, True), (2, 1, 32768, 65536, False)]


@pytest.mark.parametrize("s,t,b,n_loc,overlap", POOL_CASES)
def test_pool_build_model_matches_plain_and_reference(jax_mesh, s, t, b,
                                                      n_loc, overlap):
    cand, nf, vals, kd = _packets(s, t, b, n_loc, s * 100 + t * 10 + b,
                                  overlap)
    model = _k9_model(cand, nf, vals, t, 5)
    plain = tk.pool_build_plain(_t(cand), _t(nf), _t(vals), _t(kd))
    for name in tk.PoolState._fields:
        np.testing.assert_array_equal(getattr(model, name),
                                      getattr(plain, name).numpy(),
                                      err_msg=name)
    mesh = jparallel.scheduling_mesh(jax.devices()[:s])
    ref = jk._mesh_keyed_program(mesh, max(1, b // 2)).pool_build(
        cand, nf, vals, kd)
    for name, a in zip(("pool_use", "keep", "tau", "nf0"), ref[1:]):
        np.testing.assert_array_equal(np.asarray(a), getattr(model, name),
                                      err_msg=name)
    cols = tk.pool_columns(_t(np.asarray(ref[0])), _t(np.asarray(ref[2])),
                           5, t)
    for name, want in cols.items():
        np.testing.assert_array_equal(want.numpy(), getattr(model, name),
                                      err_msg=name)
    # One kept copy per distinct row; more rows than a shard has make
    # copies.
    assert model.keep.sum() == len(np.unique(cand[:, 0]))
    if t * b > n_loc or overlap:
        assert model.keep.sum() < len(cand)


def _k7_model(usage, ring, row_base, pos):
    """K7's two passes (csrc/mesh.cu k7_mark, k7_write) in numpy over the
    int scratch `pos` (-1 in every entry on entry, checked so on exit)."""
    n = usage.shape[0]
    assert (pos == -1).all()
    for i, rf in enumerate(ring[:, 0]):
        if rf >= 0 and 0 <= int(rf) - row_base < n:
            pos[int(rf) - row_base] = max(pos[int(rf) - row_base], i)
    out = usage.copy()
    marked = pos >= 0
    out[marked] = ring[pos[marked], 1:]
    pos[marked] = -1
    return out


def _ring_case(kind, cap, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "empty":
        return np.full((cap, 6), -1.0, np.float32)
    if kind == "repeats":
        ring = _ring(cap, n, seed, cap * 3 // 4)
        ring[cap // 2:cap // 2 + 64, 0] = ring[:64, 0]   # later writes win
        return ring
    if kind == "holes":
        ring = _ring(cap, n, seed, cap)
        ring[rng.random(cap) < 0.3, 0] = -1.0
        return ring
    # "every_shard": each shard's first and last rows, and a full ring of
    # rows drawn from fewer rows than it has entries (65,536 entries over
    # 16,384 rows in "outnumbers").
    ring = _ring(cap, n, seed, cap)
    n_loc = n // SHARDS
    edges = np.array([[sh * n_loc, sh * n_loc + n_loc - 1]
                      for sh in range(SHARDS)]).reshape(-1)
    ring[-len(edges):, 0] = edges
    return ring


# (kind, usage rows, ring rows); "outnumbers" is mesh-served's shape.
RING_CASES = [("repeats", 2048, 1024), ("holes", 2048, 1024),
              ("every_shard", 2048, 1024), ("empty", 2048, 1024),
              ("outnumbers", 16384, 65536)]


@pytest.mark.parametrize("kind,n,cap", RING_CASES)
def test_all_shard_ring_apply_matches_per_shard_and_reference(
        jax_mesh, kind, n, cap):
    """One apply over every shard's rows (row_base 0), as the cold stage
    and apply_fn now call K7, equals the per-shard applications laid end to
    end, the reference's apply_ring_full under shard_map, and K7's model."""
    rng = np.random.default_rng(n + cap)
    usage = rng.uniform(0, 300, (n, 5)).astype(np.float32)
    ring = _ring_case(kind, cap, n, n + cap)
    n_loc = n // SHARDS
    whole = tk.apply_ring_plain(_t(usage), _t(ring), 0).numpy()
    per = np.concatenate([
        tk.apply_ring_plain(_t(usage[sh * n_loc:(sh + 1) * n_loc]), _t(ring),
                            sh * n_loc).numpy() for sh in range(SHARDS)])
    np.testing.assert_array_equal(whole, per)
    j = jk._mesh_keyed_program(jax_mesh, 64)
    ref = j.apply_fn(jax.device_put(usage, j.node_sharding),
                     jax.device_put(ring, j.rep_sharding))
    np.testing.assert_array_equal(np.asarray(ref), whole)
    pos = np.full(n, -1, np.int64)
    np.testing.assert_array_equal(_k7_model(usage, ring, 0, pos), whole)
    assert (pos == -1).all()
    # The port's mesh program makes that one call.
    before = native.PLAIN_CALLS["apply_ring"]
    got = tk._mesh_keyed_program(_tmesh(), 64).apply_fn(_t(usage), _t(ring))
    assert native.PLAIN_CALLS["apply_ring"] == before + 1
    np.testing.assert_array_equal(got.numpy(), whole)
    if kind == "repeats":
        row = int(ring[0, 0])
        last = np.nonzero(ring[:, 0] == row)[0][-1]
        np.testing.assert_array_equal(whole[row], ring[last, 1:])
        assert last >= cap // 2
    if kind == "empty":
        np.testing.assert_array_equal(whole, usage)


# ------------------------------------------ K6 and K8 as the card runs them


def _k6_model(capacity, score_cap, counts, noise, banned, tile=256):
    """K6's tile copy (csrc/mesh.cu k6_pack) in numpy. Per tile of `tile`
    rows a staging buffer [rows, R + 5] takes capacity's contiguous rows * R
    floats (flat index e to row e // R, column e % R), then score_cap's
    pairs, counts, noise and banned per row; the tile's floats go out flat,
    whole 16-byte vectors first (each tile starts on one) and scalars past
    the last. Every output float must be written exactly once."""
    n, r = capacity.shape
    w = r + 5
    out = np.zeros(n * w, np.float32)
    writes = np.zeros(n * w, np.int64)
    for row0 in range(0, n, tile):
        rows = min(tile, n - row0)
        stage = np.full(rows * w, np.nan, np.float32)
        e = np.arange(rows * r)
        stage[(e // r) * w + e % r] = capacity[row0:row0 + rows].reshape(-1)
        j = np.arange(rows) * w + r
        stage[j] = score_cap[row0:row0 + rows, 0]
        stage[j + 1] = score_cap[row0:row0 + rows, 1]
        stage[j + 2] = counts[row0:row0 + rows].astype(np.float32)
        stage[j + 3] = noise[row0:row0 + rows]
        stage[j + 4] = banned[row0:row0 + rows].astype(np.float32)
        assert not np.isnan(stage).any()
        base = row0 * w
        assert base % 4 == 0
        n_vec = rows * w // 4
        for lo, hi in ((0, 4 * n_vec), (4 * n_vec, rows * w)):
            out[base + lo:base + hi] = stage[lo:hi]
            writes[base + lo:base + hi] += 1
    assert (writes == 1).all()
    return out.reshape(n, w)


@pytest.mark.parametrize("n,r", [(1, 2), (255, 5), (257, 7), (1000, 5),
                                 (513, 2)])
def test_pack_model_matches_plain_and_reference(jax_mesh, n, r):
    """K6's plain version against the reference's pack_fn and against the
    model of K6's tile copy, at row counts no multiple of the tile."""
    rng = np.random.default_rng(n + r)
    cols = (rng.uniform(1e3, 4e3, (n, r)).astype(np.float32),
            rng.uniform(8e2, 4e3, (n, 2)).astype(np.float32),
            rng.integers(0, 9, n).astype(np.int32),
            (rng.random(n) * 1e-3).astype(np.float32), rng.random(n) < 0.3)
    ref = np.asarray(jk._mesh_keyed_program(jax_mesh, 64).pack_fn(*cols))
    plain = tk.mesh_pack_plain(*map(_t, cols)).numpy()
    np.testing.assert_array_equal(ref, plain)
    np.testing.assert_array_equal(_k6_model(*cols), plain)
    assert plain.shape == (n, r + 5)


def _k8_model(table, usage, masks, masked0, n_shards, b):
    """K8's index mapping (csrc/mesh.cu k8_score, k8_packet) in numpy, over
    the masked scores [T, N] of its one score pass. Read as [T*S, n_loc],
    segment g = t*S + s holds shard s's rows of key t; the select gives each
    segment its feasible count (nf_sel, in segment order) and its top-B
    local rows by (score desc, row asc). Packet row i = (s*T + t)*B + b is
    segment g's b-th row (global row s*n_loc + that local row), vals
    [S, T, B] in the same order, and nf_all[s, t] = nf_sel[t*S + s]."""
    t_, n = masked0.shape
    n_loc = n // n_shards
    r = usage.shape[1]
    seg = masked0.reshape(t_ * n_shards, n_loc)
    nf_sel = (seg != -np.inf).sum(axis=1).astype(np.int32)
    local = np.stack([np.lexsort((np.arange(n_loc), -row))[:b]
                      for row in seg])
    i = np.arange(n_shards * t_ * b)
    st, bb = np.divmod(i, b)
    s, t = np.divmod(st, t_)
    g = t * n_shards + s
    row = s * n_loc + local[g, bb]
    pkt = np.concatenate([
        row[:, None].astype(np.float32), table[row, :r],
        table[row, r:r + 2], usage[row], table[row, r + 2:r + 3],
        (table[row, r + 4:r + 5] > 0.5).astype(np.float32),
        table[row, r + 3:r + 4], masks[:, row].T.astype(np.float32)], axis=1)
    vals = masked0[t, row].reshape(n_shards, t_, b)
    nf_all = np.empty((n_shards, t_), np.int32)
    first = bb == 0
    nf_all[s[first], t[first]] = nf_sel[g[first]]
    return pkt, nf_all, vals


@pytest.mark.parametrize("distinct", [False, True])
@pytest.mark.parametrize("b_kind", ["one", "shard"])
@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_all_shard_cold_stage_matches_per_shard_and_reference(
        jax_mesh, s, b_kind, distinct):
    """K8 over every shard in one call (the plain version the CPU runs)
    equals the per-shard plain versions laid end to end and the model of
    the kernel's index mapping, bit for bit, and the reference's a_cold
    under shard_map on the packets and feasible counts, at T = 3 with B = 1
    and B = a whole shard. The top-B values are the scores: on this fleet
    JAX's and torch's exp2 leave them up to 5.7e-6 apart, above SCORE_TOL
    (ROADMAP C5), so they are held bit for bit to the per-shard plain
    versions, which test_cold_stage_matches_reference holds to the
    reference."""
    n_loc, t = 96, 3
    n = s * n_loc
    d = _fleet(n, t, 40 + s)
    b = 1 if b_kind == "one" else n_loc
    k = 1 if b == 1 else n_loc // 2
    dt = {key: _t(v) for key, v in d.items()}
    table = tk.mesh_pack_plain(dt["capacity"], dt["score_cap"],
                               dt["job_counts"], dt["noise"], dt["banned0"])
    args = (table, dt["usage"], dt["tg_masks"], dt["key_demands"],
            float(PEN), distinct)
    got = tk.cold_packets_plain(*args, s, b)
    assert got[0].shape == (s * t * b, 6 + 10 + t)
    assert got[1].shape == (s, t) and got[2].shape == (s, t, b)
    per = [tk.cold_packet_plain(
        table[q * n_loc:(q + 1) * n_loc], dt["usage"][q * n_loc:(q + 1)
                                                      * n_loc],
        dt["tg_masks"][:, q * n_loc:(q + 1) * n_loc], dt["key_demands"],
        float(PEN), distinct, q * n_loc, b) for q in range(s)]
    want = (torch.cat([x[0] for x in per]), torch.stack([x[1] for x in per]),
            torch.stack([x[2] for x in per]))
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    # On CPU tensors the wrapper runs the plain version, counted once.
    before = native.PLAIN_CALLS["cold_packet"]
    wrapped = tk.cold_packets(*args, s, b)
    assert native.PLAIN_CALLS["cold_packet"] == before + 1
    for a, w in zip(wrapped, want):
        assert torch.equal(a, w)
    masked0 = tk.score_topk_plain(
        dt["capacity"], dt["score_cap"], dt["usage"], dt["tg_masks"],
        dt["job_counts"], dt["key_demands"], dt["noise"], float(PEN),
        distinct, dt["banned0"], 1)[0].numpy()
    model = _k8_model(table.numpy(), d["usage"], d["tg_masks"], masked0, s,
                      b)
    for a, w in zip(model, got):
        np.testing.assert_array_equal(a, w.numpy())
    # The reference (its B is 2k; B = 1 is the first of each segment).
    j = _Jax(jparallel.scheduling_mesh(jax.devices()[:s]), k, d)
    pkt_r, _, nf_r, vals_r = j.cold(distinct,
                                    jk._ring_zero(j.prog.ring_cap, 5))
    b_r = np.asarray(vals_r).shape[2]
    assert b_r == (2 if b == 1 else n_loc)
    first = np.arange(s * t * b_r) % b_r < b
    np.testing.assert_array_equal(np.asarray(pkt_r)[first], got[0].numpy())
    np.testing.assert_array_equal(np.asarray(nf_r), got[1].numpy())
    np.testing.assert_array_equal(np.isfinite(np.asarray(vals_r)[:, :, :b]),
                                  np.isfinite(got[2].numpy()))
    # The mesh program's cold stage is that one call.
    if b == n_loc:
        prog = tk._mesh_keyed_program(_tmesh(s), k)
        before = native.PLAIN_CALLS["cold_packet"]
        cand, tail, nf_all, vals_all = prog.a_cold(
            table, dt["usage"], dt["tg_masks"], dt["key_demands"],
            float(PEN), distinct, prog.ring_zero(5))
        assert native.PLAIN_CALLS["cold_packet"] == before + 1
        for a, w in zip((cand, nf_all, vals_all), want):
            assert torch.equal(a, w)


# ------------------------------- tests/test_mesh_keyed_equivalence.py cases


def test_sharded_matches_single_device_bit_for_bit(jax_mesh):
    d = _fleet(2048, 4, 42, distinct_bans=False)
    steps = _steps(4, 64, 60, 3)
    one, u_one, _ = _port_chain(None, d, steps, 4, 60)
    shd, u_shd, _ = _port_chain(_tmesh(), d, steps, 4, 60)
    for w, (a, b) in enumerate(zip(one, shd)):
        np.testing.assert_array_equal(a, b, err_msg=f"window {w}")
        assert tk.compact_host(a, 60).ok == tk.compact_host(b, 60).ok
    np.testing.assert_array_equal(u_one, u_shd)
    stats = tk.mesh_stats_drain()
    assert stats["windows"] == 4 and stats["warm_windows"] == 3


def test_matches_exact_scan_selection(jax_mesh):
    d = _fleet(1024, 4, 11, distinct_bans=False)
    tg_ids, valid, reset = _steps(4, 128, 120, 5)
    demands = d["key_demands"][tg_ids] * valid[:, None]
    ref = jk.place_batch_multi(
        d["capacity"], d["score_cap"], d["usage"], d["tg_masks"],
        d["job_counts"], demands, tg_ids, valid, d["noise"], PEN,
        np.asarray(False), d["banned0"], reset)
    res = tk.place_batch_keyed(
        _tmesh(), *(_t(d[k]) for k in ("capacity", "score_cap", "usage",
                                       "tg_masks", "job_counts",
                                       "key_demands")),
        _t(tg_ids), _t(valid), _t(d["noise"]), 10.0, False, _t(d["banned0"]),
        _t(reset), 120)
    rp, mp = np.asarray(ref.packed), res.packed.numpy()
    np.testing.assert_array_equal(rp[valid, 0], mp[valid, 0])
    np.testing.assert_array_equal(rp[valid, 2], mp[valid, 2])
    _scores_close(rp[valid, 1], mp[valid, 1])
    np.testing.assert_array_equal(np.asarray(ref.usage_after),
                                  np.asarray(res.usage_after))


def test_tie_breaks_to_lowest_global_row_across_shards(jax_mesh):
    """Identical rows and zero noise: every placement ties across all
    shards, and the penalty walks the winners over rows 0, 1, 2, ...,
    crossing shard boundaries (256 rows per shard at 2048 rows)."""
    n, t, p = 2048, 1, 16
    d = dict(capacity=np.full((n, 5), 4000, np.float32),
             score_cap=np.full((n, 2), 3800, np.float32),
             usage=np.zeros((n, 5), np.float32),
             tg_masks=np.ones((t, n), bool),
             job_counts=np.zeros(n, np.int32),
             key_demands=np.full((t, 5), 10, np.float32),
             noise=np.zeros(n, np.float32), banned0=np.zeros(n, bool))
    args = [_t(d[k]) for k in ("capacity", "score_cap", "usage", "tg_masks",
                               "job_counts", "key_demands")]
    steps = [_t(np.zeros(p, np.int32)), _t(np.ones(p, bool))]
    for mesh in (None, _tmesh()):
        res = tk.place_batch_keyed(mesh, *args, *steps, _t(d["noise"]), 10.0,
                                   False, _t(d["banned0"]),
                                   _t(np.zeros(p, bool)), p)
        np.testing.assert_array_equal(res.packed[:, 0].numpy(),
                                      np.arange(p))
    jres = jk.place_batch_keyed(
        jax_mesh, d["capacity"], d["score_cap"], d["usage"], d["tg_masks"],
        d["job_counts"], d["key_demands"], np.zeros(p, np.int32),
        np.ones(p, bool), d["noise"], PEN, np.asarray(False), d["banned0"],
        np.zeros(p, bool), p)
    np.testing.assert_array_equal(np.asarray(jres.packed)[:, 0],
                                  np.arange(p))


def test_failed_placements_and_success_mask(jax_mesh):
    d = _fleet(1024, 4, 23, distinct_bans=False)
    d["key_demands"][1] = 1e9  # infeasible everywhere
    p = 32
    tg_ids = (np.arange(p) % 4).astype(np.int32)
    valid, reset = np.ones(p, bool), np.zeros(p, bool)
    ref = jk.place_batch(
        d["capacity"], d["score_cap"], d["usage"], d["tg_masks"],
        d["job_counts"], d["key_demands"][tg_ids], tg_ids, valid, d["noise"],
        PEN, np.asarray(False), d["banned0"])
    packs = [np.asarray(ref.packed)]
    for mesh in (None, _tmesh()):
        res = tk.place_batch_keyed(
            mesh, *(_t(d[k]) for k in ("capacity", "score_cap", "usage",
                                       "tg_masks", "job_counts",
                                       "key_demands")),
            _t(tg_ids), _t(valid), _t(d["noise"]), 10.0, False,
            _t(d["banned0"]), _t(reset), p)
        packs.append(res.packed.numpy())
    failed = tg_ids == 1
    for pk in packs:
        assert (pk[failed, 0] == -1).all()
        assert np.isneginf(pk[failed, 1]).all()
        assert not tk.compact_host(pk, p).ok
    np.testing.assert_array_equal(packs[0][:, 0], packs[1][:, 0])
    np.testing.assert_array_equal(packs[1], packs[2])


# ------------------------------------------------ K10 as the card runs it


K10_ROWS = 1024          # csrc/mesh.cu kFinishRows: pool rows a block counts
K10_BLOCK_FLOATS = 4096  # kCopyVecs 16-byte vectors: ring floats a block copies


def _k10_model(masked0, n_fin, packed_loc, win, c_use, pool_rows, cap,
               pool_use2, elig, ban, key_demands, distinct, tau, nf0, ring,
               ring_n, k_sel, order_seed=0):
    """K10 (csrc/mesh.cu k10_finish) in numpy, one launch's three kinds of
    block. Reduce blocks count, per key and tile of 1,024 pool rows, the
    scores above tau and the rows feasible after the window, and add them
    into the scratch in a shuffled block order (integer sums: the order
    cannot matter); the block taking the last ticket writes nf0_2 and the
    flag. Copy blocks move the ring as 16-byte vectors when it is aligned
    (ring_rows * (1 + R) a multiple of 4), a vector that straddles the
    delta float by float; one thread per step writes the delta and packed.
    Every float of ring2 must be written exactly once. Returns (packed,
    nf0_2, ring2, flag) as numpy arrays."""
    a = [np.asarray(x) for x in (masked0, n_fin, packed_loc, win, c_use,
                                 pool_rows, cap, pool_use2, elig, ban,
                                 key_demands, tau, nf0, ring)]
    (masked0, n_fin, packed_loc, win, c_use, pool_rows, cap, pool_use2, elig,
     ban, kd, tau, nf0, ring) = a
    t, c = masked0.shape
    r = cap.shape[1]
    steps, ring_rows = len(packed_loc), len(ring)
    start = 0 if ring_n < 0 else min(ring_n, ring_rows - steps)
    tiles = max(1, -(-c // K10_ROWS))
    n_red = t * tiles if t > 0 else 1
    scratch = np.zeros(2 * t + 1, np.int64)
    nf0_2 = flag = None
    for b in np.random.default_rng(order_seed).permutation(n_red):
        q = b // tiles
        c0 = (b - q * tiles) * K10_ROWS
        c1 = min(c0 + K10_ROWS, c)
        if q < t:
            scratch[2 * q] += (masked0[q, c0:c1] > tau[q]).sum()
            fits = (cap[c0:c1] - pool_use2[c0:c1] >= kd[q]).all(axis=1)
            ok = elig[q, c0:c1] & fits & ~(distinct & ban[c0:c1])
            scratch[2 * q + 1] += ok.sum()
        scratch[2 * t] += 1
        if scratch[2 * t] == n_red:
            above, n_ok = scratch[0:2 * t:2], scratch[1:2 * t:2]
            nf0_2 = (nf0 + (n_ok - n_fin)).astype(np.int32)
            flag = np.float32(
                (~((above >= k_sel) | (n_fin >= nf0))).any())
    w1 = r + 1
    flat = ring.reshape(-1)
    total = flat.size
    d0, d1 = start * w1, (start + steps) * w1
    out = np.zeros(total, np.float32)
    writes = np.zeros(total, np.int64)
    f = np.arange(total)
    outside = (f < d0) | (f >= d1)
    if total % 4 == 0:
        vec_out = outside.reshape(-1, 4).all(axis=1)
        whole = np.repeat(vec_out, 4)
        writes += whole
        writes += ~whole & outside   # a straddling vector, float by float
    else:
        writes += outside
    out[outside] = flat[outside]
    loc = packed_loc[:, 0]
    rows_g = np.where(loc >= 0, pool_rows[np.maximum(loc, 0).astype(
        np.int64)].astype(np.float32), np.float32(-1.0))
    delta = np.concatenate([rows_g[:, None], c_use[win]], axis=1)
    out[d0:d1] = delta.reshape(-1)
    writes[d0:d1] += 1
    assert (writes == 1).all()
    assert n_red == 0 or scratch[2 * t] == n_red
    packed = packed_loc.copy()
    packed[:, 0] = rows_g
    return packed, nf0_2, out.reshape(ring_rows, w1), flag


def _finish_case(seed, c, t, p, ring_rows, ring_n, distinct, flag, r=5):
    """warm_finish's arguments (numpy) made from a seed, as chip_smoke.py's
    warm_finish_case makes them: flag 0 certifies every key, flag 1 fails
    the last key's certificate (tau above every score, n_fin below nf0)."""
    rng = np.random.default_rng(seed)
    masked0 = rng.uniform(0, 18, (t, c)).astype(np.float32)
    masked0[rng.random((t, c)) < 0.3] = -np.inf
    tau = np.full(t, 0.5, np.float32)
    k_sel = min(4096, c)
    n_fin = rng.integers(0, c + 1, t).astype(np.int32)
    nf0 = (n_fin + rng.integers(1, 1000, t)).astype(np.int32)
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
    return (masked0, n_fin, packed_loc, win, c_use, pool_rows, cap, use2,
            elig, ban, kd, bool(distinct), tau, nf0, ring, int(ring_n), k_sel)


# (seed, pool rows C, keys T, steps P, ring rows, ring_n, distinct, flag):
# the mesh-served storm's shape, its delta clamped at the ring's end with a
# failed certificate, three keys with a pool and a ring of no round size
# (float-by-float copy), one key of two uncertified, and a one-row ring.
FINISH_CASES = [(101, 16384, 1, 4096, 65536, 8192, False, 0),
                (102, 16384, 1, 4096, 65536, 65500, False, 1),
                (103, 5003, 3, 777, 12437, -5, True, 1),
                (105, 3000, 2, 64, 1024, 960, False, 1),
                (104, 1, 2, 1, 1, 0, False, 0)]


def _finish_equal(got, want):
    for g, w in zip(got, want):
        g = np.asarray(g.cpu() if isinstance(g, torch.Tensor) else g)
        np.testing.assert_array_equal(np.asarray(w).view(np.int32)
                                      if g.dtype == np.float32
                                      else np.asarray(w),
                                      g.view(np.int32)
                                      if g.dtype == np.float32 else g)


@pytest.mark.parametrize("case", FINISH_CASES)
def test_warm_finish_model_matches_plain(case):
    arrs = _finish_case(*case)
    args = tuple(_t(a) if isinstance(a, np.ndarray) else a for a in arrs)
    plain = tk.warm_finish_plain(*args)
    for seed in (0, 1):
        model = _k10_model(*arrs, order_seed=seed)
        _finish_equal(plain, model)
    assert float(plain[3]) == case[-1]


@pytest.mark.parametrize("ring_n,miss", [(0, False), (448, False),
                                         (1 << 20, False), (64, True)])
def test_warm_finish_model_matches_reference(jax_mesh, ring_n, miss):
    """The reference's warm step on a pool from its own cold stage; K10's
    model fed the port's K2-K4a plain outputs over the same pool gives the
    reference's packed rows, nf0_2, ring and flag. miss=True raises the
    pool's tau above every score and nf0 above what the pool holds, so
    both keys' certificates fail; ring_n beyond the ring clamps."""
    n, t, p_pad, n_valid = 4096, 2, 64, 60
    d = _fleet(n, t, 7)
    k = tk.keyed_cand_count(n_valid)
    j = _Jax(jax_mesh, k, d)
    pkt, _, nf, vals = j.cold(True, jk._ring_zero(j.prog.ring_cap, 5))
    pool = [np.asarray(a) for a in j.prog.pool_build(
        pkt, nf, vals, np.asarray(d["key_demands"]))]
    if miss:
        pool[3] = np.full_like(pool[3], 1e9)
        pool[4] = pool[4] + n
    ring = _ring(j.prog.ring_cap, n, 8, min(ring_n, j.prog.ring_cap))
    tg_ids, valid, reset = _steps(t, p_pad, n_valid, 9)
    ref = j.prog.warm_step(*pool, ring, np.int32(ring_n),
                           np.asarray(d["key_demands"]), tg_ids, valid,
                           reset, PEN, np.asarray(True))
    st = mesh_state_from_numpy(dict(zip(
        ("pool", "pool_use", "keep", "tau", "nf0"), pool), ring=ring),
        device="cpu")
    ps, kd = st["pool_state"], _t(d["key_demands"])
    masked0, n_fin, cand = tk.score_topk_plain(
        ps.cap, ps.sc, st["pool_use"], ps.elig, ps.cnt, kd, ps.noise,
        float(PEN), True, ps.ban, k)
    sel, keep_sel = tk.merge_candidates_plain(cand, masked0, k)
    packed_loc, pool_use2, win, c_use = tk.placement_chain_plain(
        ps.cap, ps.sc, st["pool_use"], ps.elig, ps.cnt, kd, _t(tg_ids),
        _t(valid), ps.noise, float(PEN), True, ps.ban, reset=_t(reset),
        rows=sel, keep=keep_sel, masked0=masked0, nf0=st["nf0"],
        winners=True)
    args = (masked0, n_fin, packed_loc, win, c_use, ps.rows, ps.cap,
            pool_use2, ps.elig, ps.ban, kd, True, ps.tau, st["nf0"],
            st["ring"], ring_n, min(k, ps.rows.shape[0]))
    model = _k10_model(*args)
    _finish_equal(tk.warm_finish_plain(*args), model)
    _assert_packed(ref[0], model[0])
    np.testing.assert_array_equal(np.asarray(ref[2]), model[1])
    np.testing.assert_array_equal(np.asarray(ref[3]), model[2])
    assert float(ref[4]) == float(model[3]) == float(miss)


# ------------------------------------------------------ the certificate


def test_warm_certificate_failure_raises_the_flag(jax_mesh):
    """Shard 0's rows are nearly full (one placement each, scoring high),
    every other shard is empty: tau is shard 0's 128th score, so only its
    top 127 pool rows lie above tau. The cold window fills 64 of them; the
    next (warm) window finds 63 above tau, fewer than k = 64, and the pool
    does not hold every feasible row: the certificate fails on both
    packages."""
    n, t, p = 4096, 1, 64
    rng = np.random.default_rng(31)
    usage = np.zeros((n, 5), np.float32)
    usage[:n // SHARDS, 0] = 950 + rng.uniform(0, 5, n // SHARDS)
    d = dict(capacity=np.full((n, 5), 1000, np.float32),
             score_cap=np.full((n, 2), 1000, np.float32), usage=usage,
             tg_masks=np.ones((t, n), bool),
             job_counts=np.zeros(n, np.int32),
             key_demands=np.full((t, 5), 40, np.float32),
             noise=(rng.random(n) * 1e-3).astype(np.float32),
             banned0=np.zeros(n, bool))
    steps = (np.zeros(p, np.int32), np.ones(p, bool), np.zeros(p, bool))
    usage_j, flags_j = d["usage"], []
    for _ in range(2):
        res = jk.place_batch_keyed(
            jax_mesh, d["capacity"], d["score_cap"], usage_j, d["tg_masks"],
            d["job_counts"], d["key_demands"], *steps[:2], d["noise"], PEN,
            _DISTINCT, d["banned0"], steps[2], p)
        usage_j = res.usage_after
        flags_j.append(usage_j.flag)
    _, _, flags = _port_chain(_tmesh(), d, steps, 2, p)
    assert flags_j[0] is None and flags[0] is None
    assert float(flags_j[1]) == float(flags[1]) == 1.0


# ----------------------------------------------------------- the audit


def test_collective_audit_exchange_bytes_match_reference(jax_mesh):
    jmesh4 = jparallel.scheduling_mesh(jax.devices()[:4])
    ref = jk.mesh_collective_audit(jmesh4, 64)
    got = tk.mesh_collective_audit(_tmesh(4), 64)
    assert ref["exchange_bytes"] == got["exchange_bytes"] == 172_096
    for stage in ("cold", "pool_build", "warm", "apply"):
        assert ref[stage] == got[stage] == 0
    # One K7 call and one K8 call per stage cover every shard (they share
    # one device).
    launches = got["launches"]
    assert launches["cold"] == {"mesh_pack": 1, "apply_ring": 1,
                                "cold_packet": 1}
    assert launches["pool_build"] == {"pool_build": 1}
    assert launches["warm"] == {"score_topk": 1, "merge_candidates": 1,
                                "placement_chain": 1, "warm_finish": 1}
    assert launches["apply"] == {"apply_ring": 1}


def test_place_batch_sharded_matches_reference():
    d = _fleet(1024, 3, 13)
    tg_ids, valid, _ = _steps(3, 64, 64, 14)
    demands = d["key_demands"][tg_ids]
    args = (d["capacity"], d["score_cap"], d["usage"], d["tg_masks"],
            d["job_counts"], demands, tg_ids, valid, d["noise"])
    ref = jparallel.place_batch_sharded(
        jparallel.scheduling_mesh(jax.devices()[:SHARDS]), *args, PEN,
        np.asarray(True), d["banned0"])
    got = place_batch_sharded(_tmesh(), *(_t(a) for a in args), 10.0, True,
                              _t(d["banned0"]))
    _assert_packed(ref.packed, got.packed)
    np.testing.assert_array_equal(np.asarray(ref.usage_after),
                                  got.usage_after.numpy())


# ------------------------------------------------------------ the mesh


def test_mesh_shapes_and_set_mesh_rejections():
    mesh = _tmesh()
    assert mesh.size == SHARDS and mesh == _tmesh() and hash(mesh) == \
        hash(_tmesh())
    assert pow2_prefix(list(range(7))) == [0, 1, 2, 3]
    t = torch.arange(64 * 5, dtype=torch.float32).reshape(64, 5)
    shards = node_shards(mesh, t)
    assert [s.shape for s in shards] == [(8, 5)] * SHARDS
    assert shards[3].data_ptr() == t[24].data_ptr()   # a view, no copy
    masks = torch.ones(2, 64, dtype=torch.bool)
    assert node_shards(mesh, masks, dim=1)[1].shape == (2, 8)

    nt = NodeTensor(device="cpu")
    with pytest.raises(ValueError, match="power-of-two"):
        nt.set_mesh(SchedulingMesh(["cpu"] * 3))
    with pytest.raises(ValueError, match="not divisible"):
        nt.set_mesh(_tmesh(128))
    with pytest.raises(NotImplementedError, match="multi-card"):
        nt.set_mesh(SchedulingMesh(["cuda:0", "cuda:1"]))
    with pytest.raises(NotImplementedError, match="multi-card"):
        node_shards(SchedulingMesh(["cpu", "meta"]), t)
    with pytest.raises(ValueError, match="mesh on"):
        nt.set_mesh(SchedulingMesh(["meta"] * 2))
    nt.set_mesh(mesh)
    assert nt.mesh is mesh
    # The mesh survives table growth (rows stay a power of two).
    for _ in range(100):
        nt.upsert_node(tmock.node())
    assert nt.n_rows == 128 and nt.mesh is mesh
    assert nt.device_arrays()["usage"].shape == (128, 5)


def test_snapshots_share_static_tables_until_they_change():
    nt = NodeTensor(device="cpu")
    node = tmock.node()
    nt.upsert_node(node)
    a = nt.device_snapshot()
    b = nt.device_snapshot()
    assert a["capacity"] is b["capacity"] and a["usage"] is not b["usage"]
    nt.upsert_node(node)            # capacity tier dirty: a new clone
    c = nt.device_snapshot()
    assert c["capacity"] is not a["capacity"]
    np.testing.assert_array_equal(c["capacity"].numpy(), nt.capacity)


def test_server_mesh_all_on_the_cpu_is_one_shard():
    srv = TServer(TServerConfig(device="cpu", scheduler_mesh="all",
                                num_schedulers=0, **PARKED_TTL))
    try:
        assert srv.tindex.nt.mesh.size == 1
    finally:
        srv.shutdown()


# ------------------------------------------------------- served windows


def _fixed_noise(n_rows, rng):
    return (np.random.default_rng(77).random(n_rows) * 1e-3).astype(
        np.float32)


def _served_job(count, cpu=50):
    job = tmock.job()
    tg = job.TaskGroups[0]
    tg.Count = count
    task = tg.Tasks[0]
    task.Resources.CPU = cpu
    task.Resources.MemoryMB = 64
    task.Resources.Networks = []
    task.Services = []
    return job


def _served_run(nodes, windows, mesh):
    """A dev server (CPU), one pipelined worker driven by hand: every
    window is dispatched before the previous one finishes, so each chains
    on its predecessor's tail; then all drain and finish in order."""
    srv = TServer(TServerConfig(device="cpu", num_schedulers=0,
                                scheduler_window=16, host_placement=False,
                                **PARKED_TTL))
    if mesh is not None:
        srv.tindex.nt.set_mesh(mesh)
    srv.establish_leadership()
    try:
        for node in nodes:
            srv.node_register(node.copy())
        w = PipelinedWorker(srv.raft, srv.eval_broker, srv.plan_queue,
                            srv.blocked_evals, srv.tindex,
                            ["service", "batch", "system"], window=16)
        works = []
        for jobs in windows:
            for j in jobs:
                srv.job_register(j.copy())
            batch = w._dequeue_window()
            assert len(batch) == len(jobs)
            batch.sort(key=lambda pair: pair[0].JobID)
            works.append(w._dispatch_window(batch))
        for work in works:
            work.packed = w._drain_window(work)
            w._finish_fast(work)
            for ev, token in work.slow:
                w._process_slow(ev, token)
            w._arbiter.mark_settled(work.chain_seq)
            w._arbiter.finish_window()
        live = {(a.JobID, a.Name): a.NodeID for a in srv.state.allocs()
                if not a.terminal_status()}
        statuses = {e.Status for e in srv.state.evals()}
        nt = srv.tindex.nt
        np.testing.assert_array_equal(nt.device_arrays()["usage"].numpy(),
                                      nt.usage)
        return live, statuses, nt.usage.copy(), dict(w.stats)
    finally:
        srv.shutdown()


def test_served_windows_on_logical_shards_match_one_device(monkeypatch):
    monkeypatch.setattr(tstack, "make_noise_vec", _fixed_noise)
    tk.mesh_stats_drain()
    nodes = []
    for i in range(48):
        node = tmock.node()
        node.Meta["rack"] = f"r{i % 8}"
        node.Resources.CPU = 2000 + 400 * (i % 3)
        node.Resources.MemoryMB = 4096
        nodes.append(node)
    windows = [[_served_job(6) for _ in range(6)],
               [_served_job(6) for _ in range(6)],
               [_served_job(5, cpu=70) for _ in range(4)]]
    one = _served_run(nodes, windows, None)
    shd = _served_run(nodes, windows, _tmesh())
    assert one[0] == shd[0] and len(one[0]) == 6 * 6 * 2 + 4 * 5
    assert one[1] == shd[1] == {"complete"}
    np.testing.assert_array_equal(one[2], shd[2])
    stats = shd[3]
    assert stats["mesh_windows"] == 3 and stats["mesh_shards"] == SHARDS
    assert stats["mesh_warm"] >= 1 and stats["mesh_bytes"] > 0
    assert stats["fallback"] == 0 and stats["mesh_cert_miss"] == 0
    assert one[3]["mesh_windows"] == 0


def test_exchange_drop_nacks_rebases_and_redelivers_exactly_once():
    """The port's counterpart of tests/test_chaos_schedules.py's mesh
    exchange schedule: a silently lost exchange (`drop` poisons the
    window's certificate) fails the drain, nacks the whole window, taints
    the chain and redelivers every eval exactly once."""
    per_job = 3
    srv = TServer(TServerConfig(device="cpu", num_schedulers=1,
                                scheduler_window=8, host_placement=False,
                                **PARKED_TTL))
    srv.tindex.nt.set_mesh(_tmesh())
    srv.establish_leadership()
    tfailpoints.arm("tensor.mesh.exchange", "drop", count=1)
    try:
        nodes = [tmock.node() for _ in range(8)]
        for node in nodes:
            srv.node_register(node)
        jobs = [_served_job(per_job, cpu=20) for _ in range(6)]
        eval_ids = [srv.job_register(j)[0] for j in jobs]
        assert wait_for(lambda: all(
            (e := srv.state.eval_by_id(eid)) is not None
            and e.Status in ("complete", "failed", "canceled")
            for eid in eval_ids), timeout=60, interval=0.05)
        assert srv.workers[0].quiesce(60)
        snap = tfailpoints.snapshot()
        assert snap["tensor.mesh.exchange"]["fired"] == 1
        stats = srv.workers[0].stats
        assert stats["mesh_windows"] >= 1, stats
        assert stats["mesh_cert_miss"] >= 1, stats
        assert stats["rebases"] >= 1, stats
        assert all(srv.state.eval_by_id(e).Status == "complete"
                   for e in eval_ids)
        live = [a for a in srv.state.allocs() if not a.terminal_status()]
        assert len({a.ID for a in live}) == len(live)
        for job in jobs:
            mine = [a for a in live if a.JobID == job.ID]
            assert len(mine) == per_job, job.ID
            assert len({a.Name for a in mine}) == per_job
        used = {}
        for a in live:
            used[a.NodeID] = used.get(a.NodeID, 0) + alloc_vec(a)
        for node in nodes:
            assert np.all(used.get(node.ID, 0) + resources_vec(node.Reserved)
                          <= resources_vec(node.Resources))
    finally:
        tfailpoints.disarm_all()
        srv.shutdown()


# --------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _bits(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,p,n_valid", [(4096, 3, 256, 200),
                                           (1 << 17, 1, 1024, 800)])
def test_mesh_kernels_match_plain_on_card(cuda_device, n, t, p, n_valid):
    d = {k: torch.tensor(v, device=cuda_device)
         for k, v in _fleet(n, t, n + t).items()}
    tg_ids, valid, reset = (torch.tensor(a, device=cuda_device)
                            for a in _steps(t, p, n_valid, 5))
    mesh = scheduling_mesh([cuda_device] * SHARDS)
    prog = tk._mesh_keyed_program(mesh, tk.keyed_cand_count(n_valid))
    pack = (d["capacity"], d["score_cap"], d["job_counts"], d["noise"],
            d["banned0"])
    table = tk.mesh_pack(*pack)
    assert _bits(table, tk.mesh_pack_plain(*pack))
    ring = tk._ring_zero(prog.ring_cap, 5, cuda_device)
    ring[:100] = torch.tensor(_ring(100, n, 6, 100), device=cuda_device)
    n_loc = n // SHARDS
    b_buf = min(2 * prog.k_cand, n_loc)
    for s in (0, SHARDS - 1):
        rows = slice(s * n_loc, (s + 1) * n_loc)
        u_s = d["usage"][rows]
        assert _bits(tk.apply_ring(u_s, ring, s * n_loc),
                     tk.apply_ring_plain(u_s, ring, s * n_loc))
        args = (table[rows], u_s, d["tg_masks"][:, rows], d["key_demands"],
                10.0, True, s * n_loc, b_buf)
        assert all(_bits(a, b) for a, b in zip(tk.cold_packet(*args),
                                               tk.cold_packet_plain(*args)))
    pkts, _, nfs, vals = prog.a_cold(table, d["usage"], d["tg_masks"],
                                     d["key_demands"], 10.0, True, ring)
    ex = prog.exchange(pkts, nfs, vals)
    pool = tk.pool_build(*ex, d["key_demands"])
    assert all(_bits(a, b) for a, b in zip(
        pool, tk.pool_build_plain(*ex, d["key_demands"])))
    warm = (pool, pool.pool_use, pool.nf0, ring, 100, d["key_demands"],
            tg_ids, valid, reset, 10.0, True)
    got = prog.warm_step(*warm)
    with native.plain_versions():
        ref = prog.warm_step(*warm)
    assert all(_bits(a, b) for a, b in zip(got, ref))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_mesh_chain_matches_single_device_on_card(cuda_device):
    d = {k: torch.tensor(v, device=cuda_device)
         for k, v in _fleet(1 << 16, 2, 3).items()}
    tg_ids, valid, reset = (torch.tensor(a, device=cuda_device)
                            for a in _steps(2, 512, 400, 4))
    mesh = scheduling_mesh([cuda_device] * SHARDS)
    u1 = um = d["usage"]
    for _ in range(4):
        args = (d["capacity"], d["score_cap"], None, d["tg_masks"],
                d["job_counts"], d["key_demands"], tg_ids, valid, d["noise"],
                10.0, True, d["banned0"], reset, 400)
        r1 = tk.place_batch_keyed(None, *args[:2], u1, *args[3:])
        rm = tk.place_batch_keyed(mesh, *args[:2], um, *args[3:])
        assert _bits(r1.packed, rm.packed)
        u1, um = r1.usage_after, rm.usage_after
    assert _bits(u1, um.materialize())
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("s,t,b,n_loc,overlap", POOL_CASES)
def test_pool_build_matches_plain_and_model_on_card(cuda_device, s, t, b,
                                                    n_loc, overlap):
    arrs = _packets(s, t, b, n_loc, s * 100 + t * 10 + b, overlap)
    args = tuple(torch.tensor(a, device=cuda_device) for a in arrs)
    got = tk.pool_build(*args)
    assert all(_bits(a, b) for a, b in zip(got,
                                           tk.pool_build_plain(*args)))
    model = _k9_model(*arrs[:3], t, 5)
    for name in tk.PoolState._fields:
        np.testing.assert_array_equal(getattr(model, name),
                                      getattr(got, name).cpu().numpy(),
                                      err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n,cap",
                         RING_CASES + [("outnumbers", 1 << 20, 65536)])
def test_all_shard_ring_apply_matches_plain_on_card(cuda_device, kind, n,
                                                    cap):
    rng = np.random.default_rng(n + cap)
    usage = torch.tensor(rng.uniform(0, 300, (n, 5)).astype(np.float32),
                         device=cuda_device)
    ring = torch.tensor(_ring_case(kind, cap, n, n + cap),
                        device=cuda_device)
    n_loc = n // SHARDS
    per = torch.cat([tk.apply_ring_plain(usage[q * n_loc:(q + 1) * n_loc],
                                         ring, q * n_loc)
                     for q in range(SHARDS)])
    prog = tk._mesh_keyed_program(scheduling_mesh([cuda_device] * SHARDS),
                                  64)
    # The program's scratch twice: the first call must leave it at -1.
    assert _bits(prog.apply_fn(usage, ring), per)
    assert _bits(prog.apply_fn(usage, ring), per)
    assert _bits(tk.apply_ring(usage, ring, 0), per)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_apply_fn_threads_share_the_scratch_on_card(cuda_device):
    """Threads applying different rings through one program share its K7
    scratch: each call's mark and write launches must not interleave with
    another's."""
    n, cap, workers = 1 << 16, 4096, 8
    prog = tk._mesh_keyed_program(scheduling_mesh([cuda_device] * SHARDS),
                                  64)
    cases = []
    for i in range(workers):
        rng = np.random.default_rng(i)
        usage = torch.tensor(rng.uniform(0, 300, (n, 5)).astype(np.float32),
                             device=cuda_device)
        ring = torch.tensor(_ring_case("holes", cap, n, i), device=cuda_device)
        cases.append((usage, ring, tk.apply_ring_plain(usage, ring, 0)))
    bad = []

    def work(i):
        usage, ring, want = cases[i]
        for _ in range(30):
            if not _bits(prog.apply_fn(usage, ring), want):
                bad.append(i)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(workers)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not bad


@pytest.mark.cuda
@pytest.mark.parametrize("case", FINISH_CASES)
def test_warm_finish_matches_plain_and_model_on_card(cuda_device, case):
    arrs = _finish_case(*case)
    args = tuple(torch.tensor(a, device=cuda_device)
                 if isinstance(a, np.ndarray) else a for a in arrs)
    # Twice: the first call must leave its scratch at zero.
    for _ in range(2):
        got = tk.warm_finish(*args)
        assert all(_bits(a, b) for a, b in zip(got,
                                               tk.warm_finish_plain(*args)))
    _finish_equal(got, _k10_model(*arrs))
    # A ring that is a view at an odd float offset takes the float-by-float
    # copy.
    ring = args[14]
    odd = torch.empty(ring.numel() + 1, device=cuda_device)[1:].view_as(ring)
    odd.copy_(ring)
    args = args[:14] + (odd,) + args[15:]
    assert all(_bits(a, b) for a, b in zip(tk.warm_finish(*args),
                                           tk.warm_finish_plain(*args)))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("r", [2, 5, 7])
@pytest.mark.parametrize("n", [1, 255, 257, 1 << 20])
def test_pack_matches_plain_on_card(cuda_device, n, r):
    """K6's tile copy at row counts around its 256-row tile, the 1M-row
    table, and 2, 5 and 7 resource dimensions; then with a score_cap at an
    odd float offset, which K6 reads as two floats instead of a float2."""
    rng = np.random.default_rng(n + r)
    args = tuple(torch.tensor(a, device=cuda_device) for a in (
        rng.uniform(1e3, 4e3, (n, r)).astype(np.float32),
        rng.uniform(8e2, 4e3, (n, 2)).astype(np.float32),
        rng.integers(0, 9, n).astype(np.int32),
        (rng.random(n) * 1e-3).astype(np.float32), rng.random(n) < 0.3))
    before = native.LAUNCHES["mesh_pack"]
    assert _bits(tk.mesh_pack(*args), tk.mesh_pack_plain(*args))
    assert native.LAUNCHES["mesh_pack"] == before + 1
    odd = torch.empty(2 * n + 1, device=cuda_device)[1:].view(n, 2)
    odd.copy_(args[1])
    args = (args[0], odd) + args[2:]
    assert _bits(tk.mesh_pack(*args), tk.mesh_pack_plain(*args))
    torch.cuda.synchronize()


# (rows a shard, keys, B, distinct): the 1M-row window's shard, mesh-served's
# (B = 2,048 = a whole shard), the certificate-miss shape (256 rows a shard,
# B = 128), and B = 1 with three keys.
COLD_CARD_CASES = [(1 << 17, 1, 2048, False), (2048, 1, 2048, False),
                   (256, 4, 128, True), (512, 3, 1, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_loc,t,b,distinct", COLD_CARD_CASES)
def test_all_shard_cold_packet_matches_plain_on_card(cuda_device, n_loc, t,
                                                     b, distinct):
    """K8 over all 8 shards in one call against the per-shard plain
    versions laid end to end (twice through one select scratch), its S = 1
    form against the per-shard plain version on every shard, and the mesh
    program's cold stage making that one launch."""
    n = SHARDS * n_loc
    d = {k: torch.tensor(v, device=cuda_device)
         for k, v in _fleet(n, t, n_loc + t).items()}
    table = tk.mesh_pack(d["capacity"], d["score_cap"], d["job_counts"],
                         d["noise"], d["banned0"])
    args = (table, d["usage"], d["tg_masks"], d["key_demands"], 10.0,
            distinct)
    want = tk.cold_packets_plain(*args, SHARDS, b)
    work = tk.cold_select_work(cuda_device, SHARDS, t)
    for _ in range(2):
        before = native.LAUNCHES["cold_packet"]
        got = tk.cold_packets(*args, SHARDS, b, work=work)
        assert native.LAUNCHES["cold_packet"] == before + 1
        assert all(_bits(a, w) for a, w in zip(got, want))
    for q in range(SHARDS):
        rows = slice(q * n_loc, (q + 1) * n_loc)
        one = (table[rows], d["usage"][rows], d["tg_masks"][:, rows],
               d["key_demands"], 10.0, distinct, q * n_loc, b)
        assert all(_bits(a, w) for a, w in zip(tk.cold_packet(*one),
                                               tk.cold_packet_plain(*one)))
    if b > 1:
        # The program's k whose B = min(2k, n_loc) is this b.
        k = b // 2 if b < n_loc else n_loc
        prog = tk._mesh_keyed_program(
            scheduling_mesh([cuda_device] * SHARDS), k)
        before = native.LAUNCHES["cold_packet"]
        cand, _, nf_all, vals_all = prog.a_cold(*args, prog.ring_zero(5))
        assert native.LAUNCHES["cold_packet"] == before + 1
        assert all(_bits(a, w) for a, w in zip((cand, nf_all, vals_all),
                                               want))
    torch.cuda.synchronize()
