"""nomad_tpu_torch's NodeTensor and TensorIndex held against nomad_tpu's.

The same upsert / alloc / remove / restore sequence runs on both tables: the
rows, row_of, host columns, epochs and the device usage after each refresh
must be identical. Port objects come from the reference's through
nomad_tpu_torch.convert (plain data, no shared objects).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu import mock as jmock
from nomad_tpu.state.state_store import StateStore as JStore
from nomad_tpu.structs import to_dict
from nomad_tpu.tensor import NodeTensor as JNodeTensor
from nomad_tpu.tensor import TensorIndex as JTensorIndex
from nomad_tpu_torch import native
from nomad_tpu_torch.convert import (
    NODE_TENSOR_COLUMNS, from_plain, node_tensor_from_columns)
from nomad_tpu_torch.state.state_store import StateStore as TStore
from nomad_tpu_torch.tensor import NodeTensor as TNodeTensor
from nomad_tpu_torch.tensor import TensorIndex as TTensorIndex
from nomad_tpu_torch.tensor.node_table import alloc_vec


def port(kind, obj):
    return from_plain(kind, to_dict(obj))


def varied_node(rng):
    n = jmock.node()
    n.Resources.CPU = int(rng.integers(1000, 8000))
    n.Resources.MemoryMB = int(rng.integers(2048, 16384))
    n.Reserved.CPU = int(rng.integers(0, 200))
    return n


def assert_tables_equal(ref, got):
    assert got.n_rows == ref.n_rows
    assert got.row_of == ref.row_of
    assert got.node_of == ref.node_of
    assert (got.row_epoch, got.node_version) == (ref.row_epoch,
                                                 ref.node_version)
    for name in NODE_TENSOR_COLUMNS:
        np.testing.assert_array_equal(getattr(ref, name), getattr(got, name),
                                      err_msg=name)


def assert_device_equal(ref, got):
    rd, gd = ref.device_arrays(), got.device_arrays()
    for name in ("capacity", "score_cap", "usage"):
        np.testing.assert_array_equal(np.asarray(rd[name]),
                                      gd[name].cpu().numpy(), err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_same_sequence_same_table(seed):
    rng = np.random.default_rng(seed)
    ref, got = JNodeTensor(capacity_hint=2), TNodeTensor(capacity_hint=2,
                                                         device="cpu")
    nodes = [varied_node(rng) for _ in range(100)]
    for n in nodes:                       # grows 64 -> 128 rows
        ref.upsert_node(n)
        got.upsert_node(port("node", n))
    assert_tables_equal(ref, got)
    assert_device_equal(ref, got)

    allocs = []
    for i in range(300):
        a = jmock.alloc()
        a.NodeID = nodes[int(rng.integers(0, len(nodes)))].ID
        a.Resources.CPU = int(rng.integers(10, 300))
        allocs.append(a)
        ref.add_alloc_usage(a)
        got.add_alloc_usage(port("alloc", a))
    for a in allocs[::7]:
        ref.remove_alloc_usage(a)
        got.remove_alloc_usage(port("alloc", a))
    assert_tables_equal(ref, got)
    assert_device_equal(ref, got)        # dirty-row refresh (K4b)

    for n in nodes[:5]:
        ref.remove_node(n.ID)
        got.remove_node(n.ID)
    n2 = nodes[10].copy()
    n2.Reserved.CPU += 50                # reserved change keeps alloc usage
    ref.upsert_node(n2)
    got.upsert_node(port("node", n2))
    ref.set_node_readiness(nodes[11].ID, False)
    got.set_node_readiness(nodes[11].ID, False)
    fresh = [varied_node(rng) for _ in range(3)]   # reuse freed rows
    for n in fresh:
        ref.upsert_node(n)
        got.upsert_node(port("node", n))
    assert_tables_equal(ref, got)
    assert_device_equal(ref, got)

    ref.reset()
    got.reset()
    assert_tables_equal(ref, got)
    assert_device_equal(ref, got)


def test_index_follows_store_and_restore():
    """Both TensorIndexes attached to their stores see the same writes,
    then the same snapshot restore."""
    rng = np.random.default_rng(4)
    js, ts = JStore(), TStore()
    ji = JTensorIndex.attach(js)
    ti = TTensorIndex.attach(ts, device="cpu")
    nodes = [varied_node(rng) for _ in range(40)]
    for i, n in enumerate(nodes):
        js.upsert_node(i + 1, n)
        ts.upsert_node(i + 1, port("node", n))
    allocs = []
    for i in range(60):
        a = jmock.alloc()
        a.NodeID = nodes[i % len(nodes)].ID
        allocs.append(a)
    js.upsert_allocs(100, allocs)
    ts.upsert_allocs(100, [port("alloc", a) for a in allocs])
    assert_tables_equal(ji.nt, ti.nt)
    assert_device_equal(ji.nt, ti.nt)
    ji.on_restore(js)
    ti.on_restore(ts)
    assert_tables_equal(ji.nt, ti.nt)
    assert_device_equal(ji.nt, ti.nt)
    assert ti.allow_host_select is False


def test_convert_carries_the_table_over():
    rng = np.random.default_rng(2)
    ref = JNodeTensor()
    nodes = [varied_node(rng) for _ in range(70)]
    for n in nodes:
        ref.upsert_node(n)
    ref.remove_node(nodes[3].ID)
    cols = {name: getattr(ref, name) for name in NODE_TENSOR_COLUMNS}
    cols.update(node_of=ref.node_of, free=ref._free,
                class_names=ref.class_names, dc_names=ref.dc_names,
                reserved=ref._reserved_cache, row_epoch=ref.row_epoch,
                node_version=ref.node_version)
    got = node_tensor_from_columns(cols, device="cpu")
    assert_tables_equal(ref, got)
    assert_device_equal(ref, got)
    extra = varied_node(rng)              # the next upsert lands alike
    ref.upsert_node(extra)
    got.upsert_node(port("node", extra))
    assert_tables_equal(ref, got)


def test_refresh_runs_the_plain_version_on_cpu():
    nt = TNodeTensor(device="cpu")
    n = port("node", jmock.node())
    nt.upsert_node(n)
    nt.device_arrays()
    native.reset_counts()
    a = port("alloc", jmock.alloc())
    a.NodeID = n.ID
    nt.add_alloc_usage(a)
    d = nt.device_arrays()
    row = nt.row_of[n.ID]
    assert float(d["usage"][row][0]) == nt.usage[row][0] == 600
    assert native.PLAIN_CALLS["scatter_refresh"] == 1
    assert native.LAUNCHES["scatter_refresh"] == 0
    nt.warm_device()
    assert native.PLAIN_CALLS["scatter_refresh"] == 5


def test_device_tensors_do_not_alias_the_host_mirror():
    nt = TNodeTensor(device="cpu")
    n = port("node", jmock.node())
    nt.upsert_node(n)
    d = nt.device_arrays()
    nt.usage[nt.row_of[n.ID], 0] += 1000   # host write without dirtying
    assert float(d["usage"][nt.row_of[n.ID], 0]) == 100


def test_mesh_waits_for_its_slice():
    """A mesh of logical shards of the table's device is accepted; one over
    distinct devices waits for the multi-card mesh item and raises."""
    from nomad_tpu_torch.parallel import SchedulingMesh

    nt = TNodeTensor(device="cpu")
    nt.set_mesh(None)
    nt.set_mesh(SchedulingMesh(["cpu"] * 4))
    assert nt.mesh.size == 4
    with pytest.raises(NotImplementedError, match="multi-card"):
        nt.set_mesh(SchedulingMesh(["cpu", "cuda:1"]))


@pytest.mark.cuda
def test_refresh_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from nomad_tpu_torch.tensor.node_table import (
        scatter_refresh, scatter_refresh_plain)

    rng = np.random.default_rng(8)
    n, k = 4096, 128
    tabs = [torch.tensor(rng.random(s).astype(np.float32), device="cuda")
            for s in ((n, 5), (n, 2), (n, 5))]
    rows = rng.permutation(n)[:k].astype(np.float32)
    rows[-8:] = rows[0]                   # padding repeats a row
    vals = rng.random((k, 12)).astype(np.float32)
    vals[-8:] = vals[0]
    pk = torch.tensor(np.concatenate([rows[:, None], vals], 1), device="cuda")
    a = [t.clone() for t in tabs]
    b = [t.clone() for t in tabs]
    scatter_refresh(*a, pk)
    scatter_refresh_plain(*b, pk)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_skip_usage_tier_matches_the_reference():
    """device_arrays(skip_usage=True) refreshes capacity/readiness rows and
    leaves usage-only dirty rows queued, as the reference's two dirty tiers
    do; the next full call flushes them."""
    rng = np.random.default_rng(7)
    ref, got = JNodeTensor(), TNodeTensor(device="cpu")
    nodes = [varied_node(rng) for _ in range(40)]
    for n in nodes:
        ref.upsert_node(n)
        got.upsert_node(port("node", n))
    assert_device_equal(ref, got)
    a = jmock.alloc()
    a.NodeID = nodes[3].ID
    a.Resources.CPU = 250
    pa = port("alloc", a)
    ref.add_alloc_usage(a)
    got.add_alloc_usage(pa)
    bigger = nodes[5].copy()
    bigger.Resources.CPU += 1000
    ref.upsert_node(bigger)
    got.upsert_node(port("node", bigger))
    stale = got.usage.copy()   # integral values: the subtraction is exact
    stale[got.row_of[nodes[3].ID]] -= alloc_vec(pa)
    rd = ref.device_arrays(skip_usage=True)
    gd = got.device_arrays(skip_usage=True)
    # The capacity tier refreshed (the reference's device usage on the CPU
    # backend may alias its host mirror, so usage is checked on the port
    # alone): the alloc's usage-only row is still queued.
    for name in ("capacity", "score_cap"):
        np.testing.assert_array_equal(np.asarray(rd[name]),
                                      gd[name].numpy(), err_msg=name)
    np.testing.assert_array_equal(gd["usage"].numpy(), stale)
    assert gd["capacity"][got.row_of[bigger.ID], 0].item() == \
        got.capacity[got.row_of[bigger.ID], 0]
    assert_device_equal(ref, got)                            # flushed


def test_device_snapshot_is_not_rewritten_by_a_refresh():
    """A placement's snapshot keeps the rows it was taken with while the
    live tensors take the next refresh in place."""
    rng = np.random.default_rng(8)
    nt = TNodeTensor(device="cpu")
    nodes = [port("node", varied_node(rng)) for _ in range(10)]
    for n in nodes:
        nt.upsert_node(n)
    snap = nt.device_snapshot()
    live = nt.device_arrays()
    before = {k: v.clone() for k, v in snap.items()}
    a = port("alloc", jmock.alloc())
    a.NodeID = nodes[0].ID
    nt.add_alloc_usage(a)
    live2 = nt.device_arrays()
    assert live2["usage"] is live["usage"]        # refreshed in place
    np.testing.assert_array_equal(live2["usage"].numpy(), nt.usage)
    for k in snap:
        assert torch.equal(snap[k], before[k])
    assert not torch.equal(snap["usage"], live2["usage"])


# ------------------------------------------ K4b's pinned staging ring

def _seeded_table(n, seed, device="cpu"):
    """A full table of n rows whose columns come from a numpy seed."""
    rng = np.random.default_rng(seed)
    cap = rng.integers(1000, 9000, (n, 5)).astype(np.float32)
    cols = dict(capacity=cap,
                score_cap=(cap[:, :2] - rng.integers(0, 500, (n, 2))
                           ).astype(np.float32),
                usage=rng.integers(0, 900, (n, 5)).astype(np.float32),
                ready=np.ones(n, bool), class_ids=np.zeros(n, np.int32),
                dc_ids=np.zeros(n, np.int32),
                node_of=[f"node-{i}" for i in range(n)], free=[],
                class_names=["c"], dc_names=["dc1"], reserved={},
                row_epoch=0, node_version=0)
    return node_tensor_from_columns(cols, device=device), rng


def _concatenated_block(nt, chunk, size):
    """The refresh block as the table built it before the staging ring: a
    chunk padded with its first row, then one np.concatenate of the four
    column groups."""
    if len(chunk) < size:
        chunk = np.concatenate([chunk, np.full(size - len(chunk), chunk[0],
                                               dtype=np.int32)])
    return np.concatenate([chunk[:, None].astype(np.float32),
                           nt.capacity[chunk], nt.score_cap[chunk],
                           nt.usage[chunk]], axis=1)


@pytest.mark.parametrize("n_dirty", [5, 8, 100, 2000, 16384, 20000])
def test_staged_chunks_refresh_like_the_reference(n_dirty, monkeypatch):
    """Every _REFRESH_CHUNKS bucket (padded and exact) and a dirty set of
    two 16,384-row chunks: each chunk the host packs into its staging slot
    is byte for byte today's np.concatenate block, padded tail included,
    and the refreshed tables equal the reference's _scatter_refresh of
    those blocks on the same fleet, exactly."""
    from nomad_tpu.tensor.node_table import _scatter_refresh

    n = 32768 if n_dirty > 16384 else 16384
    nt, rng = _seeded_table(n, seed=n_dirty)
    nt.device_arrays()                       # the full upload
    ref = [jnp.asarray(getattr(nt, k).copy())   # no alias of the mirror
           for k in ("capacity", "score_cap", "usage")]
    rows = np.sort(rng.permutation(n)[:n_dirty]).astype(np.int64)
    nt.capacity[rows] += 7.0                 # refreshed with the rows
    nt.score_cap[rows] -= 3.0
    assert nt.apply_row_usage_deltas(
        rows, rng.integers(1, 50, (n_dirty, 5)).astype(np.float32),
        nt.row_epoch)
    staged = []
    pack = nt.pack_chunk

    def recording_pack(out, chunk, size):
        pack(out, chunk, size)
        staged.append((chunk.copy(), size, out[:size].copy()))

    monkeypatch.setattr(nt, "pack_chunk", recording_pack)
    got = nt.device_arrays()
    assert len(staged) == -(-n_dirty // 16384)
    assert sorted(np.concatenate([c for c, _, _ in staged]).tolist()) \
        == rows.tolist()
    for slot, (chunk, size, block) in enumerate(staged):
        want = _concatenated_block(nt, chunk, size)
        assert size == next(s for s in (8, 128, 2048, 16384)
                            if min(n_dirty, 16384) <= s)
        np.testing.assert_array_equal(block.view(np.uint32),
                                      want.view(np.uint32))
        np.testing.assert_array_equal(
            nt._ring.views[slot][:size].view(np.uint32), want.view(np.uint32))
        ref = list(_scatter_refresh(*ref, want))
    for name, r in zip(("capacity", "score_cap", "usage"), ref):
        np.testing.assert_array_equal(np.asarray(r), got[name].numpy(),
                                      err_msg=name)
        np.testing.assert_array_equal(getattr(nt, name), got[name].numpy(),
                                      err_msg=name)


def test_plain_refresh_drops_rows_past_the_table_as_the_reference_does():
    """Rows at and past n drop in K4b's plain version as in the
    reference's scatter; repeated padding rows are benign."""
    from nomad_tpu.tensor.node_table import _scatter_refresh
    from nomad_tpu_torch.tensor.node_table import scatter_refresh_plain

    rng = np.random.default_rng(31)
    n, k = 256, 128
    tabs = [rng.random(s).astype(np.float32) for s in ((n, 5), (n, 2),
                                                        (n, 5))]
    rows = rng.permutation(n)[:k].astype(np.float32)
    rows[:4] = [n, n + 1, n + 1000, 2 * n]   # past the table
    rows[-8:] = rows[10]                     # padding repeats a row
    vals = rng.random((k, 12)).astype(np.float32)
    vals[-8:] = vals[10]
    block = np.concatenate([rows[:, None], vals], 1)
    want = _scatter_refresh(*[jnp.asarray(t) for t in tabs], block)
    got = [torch.tensor(t) for t in tabs]
    scatter_refresh_plain(*got, torch.tensor(block))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("size", [8, 128, 2048, 16384])
def test_refresh_kernel_reads_a_pinned_block(cuda_device, size):
    """K4b reads its block in place from pinned host memory: bit for bit
    its plain version, with rows past the table and repeated padding rows,
    and no copy of the block."""
    from nomad_tpu_torch.tensor.node_table import (
        scatter_refresh, scatter_refresh_plain)

    rng = np.random.default_rng(size)
    n = 16384
    tabs = [torch.tensor(rng.random(s).astype(np.float32),
                         device=cuda_device)
            for s in ((n, 5), (n, 2), (n, 5))]
    rows = rng.permutation(n)[:size].astype(np.float32)
    rows[1] = n + 3                          # past the table
    rows[-size // 4:] = rows[0]              # padding repeats a row
    vals = rng.random((size, 12)).astype(np.float32)
    vals[-size // 4:] = vals[0]
    block = torch.empty((size, 13), dtype=torch.float32, pin_memory=True)
    block.numpy()[:] = np.concatenate([rows[:, None], vals], 1)
    a = [t.clone() for t in tabs]
    b = [t.clone() for t in tabs]
    before = native.LAUNCHES["scatter_refresh"]
    scatter_refresh(*a, block)
    assert native.LAUNCHES["scatter_refresh"] == before + 1
    scatter_refresh_plain(*b, block.to(cuda_device))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_a_pageable_block_raises(cuda_device):
    """Nothing copies a pageable host block behind the caller's back."""
    from nomad_tpu_torch.tensor.node_table import scatter_refresh

    tabs = [torch.zeros(s, device=cuda_device)
            for s in ((64, 5), (64, 2), (64, 5))]
    with pytest.raises(ValueError, match="pageable"):
        native.device_address(torch.zeros(8), cuda_device)
    with pytest.raises(ValueError, match="pageable"):
        scatter_refresh(*tabs, torch.zeros((8, 13)))
    pinned = torch.zeros((8, 13), pin_memory=True)
    assert native.device_address(pinned, cuda_device) != 0


@pytest.mark.cuda
def test_two_threads_refresh_through_the_ring_behind_a_long_kernel(
        cuda_device):
    """Two threads refresh one table through its staging ring while a long
    kernel holds the stream, so every slot of the ring is queued unread
    and later refreshes wait for their slot's event: the tables end equal
    to a serial run of the same deltas on the CPU (integral deltas, so
    the order of the adds cannot matter)."""
    import threading

    nt, _ = _seeded_table(4096, seed=5, device=cuda_device)
    serial, _ = _seeded_table(4096, seed=5, device="cpu")
    nt.device_arrays()
    serial.device_arrays()
    rng = np.random.default_rng(6)
    work = [[(np.sort(rng.permutation(4096)[:int(rng.integers(1, 300))]),
              None) for _ in range(12)] for _ in range(2)]
    work = [[(rows, rng.integers(-5, 6, (len(rows), 5)).astype(np.float32))
             for rows, _ in part] for part in work]
    torch.cuda._sleep(200_000_000)           # ~0.1 s of the stream

    def refresh(part):
        for rows, vecs in part:
            assert nt.apply_row_usage_deltas(rows, vecs, nt.row_epoch)
            nt.device_arrays()

    threads = [threading.Thread(target=refresh, args=(p,)) for p in work]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for part in work:
        for rows, vecs in part:
            assert serial.apply_row_usage_deltas(rows, vecs,
                                                 serial.row_epoch)
    want = serial.device_arrays()
    got = nt.device_arrays()
    torch.cuda.synchronize()
    for name in ("capacity", "score_cap", "usage"):
        assert torch.equal(got[name].cpu(), want[name]), name
