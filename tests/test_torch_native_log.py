"""The port's raft and its native log store (nomad_tpu_torch/raft) under
the reference's tests/test_raft.py, replayed by tests/port_replay.py;
then one raft log on disk between the two packages: written by either
package's store, read by the other's `make_log_store`, under
`NOMAD_TPU_LOGSTORE=python` and with `native/bin/liblogstore.so`."""

import msgpack
import pytest
from port_replay import no_cloud_metadata, replay  # noqa: F401

from nomad_tpu.raft import log as ref_log
from nomad_tpu.raft import native_log as ref_native
from nomad_tpu_torch.raft import log as port_log
from nomad_tpu_torch.raft import native_log as port_native

globals().update(replay("test_raft.py"))

PACKAGES = {"reference": (ref_log, ref_native), "port": (port_log,
                                                         port_native)}


@pytest.fixture(params=["python", "native"])
def store_kind(request, monkeypatch):
    """Both packages' `make_log_store` open the store this kind names:
    the env var forces the Python store, as it does for a user."""
    for _, native in PACKAGES.values():
        monkeypatch.setattr(native, "_LIB", None)
        monkeypatch.setattr(native, "_LIB_TRIED", False)
    if request.param == "python":
        monkeypatch.setenv("NOMAD_TPU_LOGSTORE", "python")
    else:
        monkeypatch.delenv("NOMAD_TPU_LOGSTORE", raising=False)
        if port_native.load_liblogstore() is None:
            pytest.skip("native/bin/liblogstore.so is not built")
    return request.param


def _open(package, directory, kind):
    log, native = PACKAGES[package]
    store = native.make_log_store(str(directory))
    expected = native.NativeLogStore if kind == "native" else \
        log.FileLogStore
    assert type(store) is expected, type(store)
    return store


def _write(package, directory, kind):
    log = PACKAGES[package][0]
    store = _open(package, directory, kind)
    store.store_entries([
        log.LogEntry(Index=i, Term=1 + i // 8, Type=i % 3,
                     Data=msgpack.packb({"i": i, "pad": "x" * (i * 13)}))
        for i in range(1, 41)])
    store.set_stable("CurrentTerm", 6)
    store.set_stable("LastVoteCand", "127.0.0.1:4647")
    store.store_snapshot(12, 2, b"snapshot-bytes")
    store.delete_range(1, 12)   # compaction rewrites the segment
    store.delete_range(39, 40)  # a conflict truncates the tail
    store.store_entries([log.LogEntry(Index=39, Term=7, Data=b"new")])
    store.close()


def _read(package, directory, kind):
    store = _open(package, directory, kind)
    out = {"first": store.first_index(), "last": store.last_index(),
           "entries": [(e.Index, e.Term, int(e.Type), e.Data)
                       for e in store.get_range(store.first_index(),
                                                store.last_index())],
           "term": store.get_stable("CurrentTerm"),
           "vote": store.get_stable("LastVoteCand"),
           "snapshot": store.latest_snapshot()}
    store.close()
    return out


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_a_log_written_by_one_package_reads_in_the_other(
        store_kind, writer, reader, tmp_path):
    _write(writer, tmp_path, store_kind)
    got = _read(reader, tmp_path, store_kind)
    assert got == _read(writer, tmp_path, store_kind)
    assert (got["first"], got["last"]) == (13, 39)
    assert got["entries"][-1] == (39, 7, 0, b"new")
    assert got["term"] == 6 and got["snapshot"] == (12, 2, b"snapshot-bytes")


def test_the_segment_files_are_byte_identical(store_kind, tmp_path):
    _write("reference", tmp_path / "ref", store_kind)
    _write("port", tmp_path / "port", store_kind)
    for name in ("raft.log", "stable.mp", "snapshot.mp"):
        assert (tmp_path / "ref" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name
