"""`unacked` reads the durable raft log back from disk: an acknowledged
registration counts unless the log entry at its index, or the snapshot
that compaction folded it into, holds that job."""

import msgpack

from portbench.harness import check


def _store(path):
    from nomad_tpu_torch.raft.log import FileLogStore

    return FileLogStore(str(path))


def _register(index, job_id):
    from nomad_tpu_torch.raft.log import EntryType, LogEntry
    from nomad_tpu_torch.server.fsm import MessageType

    data = msgpack.packb((int(MessageType.JobRegister),
                          {"Job": {"ID": job_id}}), use_bin_type=True)
    return LogEntry(Index=index, Term=1, Type=EntryType.Command, Data=data)


def _other(index):
    from nomad_tpu_torch.raft.log import EntryType, LogEntry
    from nomad_tpu_torch.server.fsm import MessageType

    data = msgpack.packb((int(MessageType.EvalUpdate), {"Evals": []}),
                         use_bin_type=True)
    return LogEntry(Index=index, Term=1, Type=EntryType.Command, Data=data)


def test_entries_in_the_log(tmp_path):
    store = _store(tmp_path)
    store.store_entries([_register(1, "j1"), _other(2), _register(3, "j2")])
    store.close()
    assert check.unacked(str(tmp_path), [("j1", 1), ("j2", 3)]) == 0
    # Another job's entry, another command, an index never appended.
    assert check.unacked(str(tmp_path), [("j2", 1), ("j1", 2),
                                         ("j3", 4)]) == 3


def test_entries_folded_into_a_snapshot(tmp_path):
    store = _store(tmp_path)
    store.store_entries([_register(i, f"j{i}") for i in range(1, 7)])
    chunks = [msgpack.packb({"peers": ["s1"]}, use_bin_type=True),
              msgpack.packb({"kind": "header", "indexes": {}},
                            use_bin_type=True),
              msgpack.packb({"kind": "nodes", "items": [{"ID": "n1"}]},
                            use_bin_type=True),
              msgpack.packb({"kind": "jobs", "items": [
                  {"ID": f"j{i}", "JobModifyIndex": i} for i in (1, 2, 4)]},
                  use_bin_type=True)]
    store.store_snapshot_chunks(4, 1, chunks)
    store.delete_range(1, 4)
    store.close()
    acked = [("j1", 1), ("j2", 2), ("j4", 4), ("j5", 5), ("j6", 6)]
    assert check.unacked(str(tmp_path), acked) == 0
    # j3 was acknowledged at 3 but the snapshot at 4 lacks it; j1 is in
    # it only as registered at 1, older than an acknowledgement at 2.
    assert check.unacked(str(tmp_path), [("j3", 3), ("j1", 2)]) == 2
