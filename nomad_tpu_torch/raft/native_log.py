"""Native raft log backend: ctypes over native/liblogstore.so.

Same "NTL2" CRC-framed segment format as FileLogStore (raft/log.py), same
directory layout (stable kv + snapshot side files stay Python — they are
tiny and rewritten whole). The native side owns the hot path: CRC-framed
group appends with one fdatasync per raft batch, mmap-scanned validated
replay, atomic compaction rewrite (reference role: raft-boltdb,
nomad/server.go:640-650 — a native store under a scripting control plane).

`make_log_store(directory)` picks the native backend when the library is
built (make -C native) and falls back to the pure-Python FileLogStore
otherwise; the shared format makes switching free in either direction.

Copied from nomad_tpu/raft/native_log.py; only the imports differ.
"""

from __future__ import annotations

import ctypes
import logging
import os
import struct
from typing import List, Optional

from .log import FileLogStore, LogEntry, _MAGIC

LOG = logging.getLogger("nomad.raft.log")

_U32 = struct.Struct("<I")
_LIB = None
_LIB_TRIED = False


def _lib_path() -> str:
    override = os.environ.get("NOMAD_TPU_LOGSTORE", "")
    if override == "python":
        return ""
    if override:
        return override
    root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "native", "bin", "liblogstore.so")


def load_liblogstore():
    """The loaded library, or None (not built / load failure)."""
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    path = _lib_path()
    if not path or not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        LOG.warning("liblogstore load failed (%s); using Python store", e)
        return None
    lib.lgs_open.restype = ctypes.c_void_p
    lib.lgs_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                             ctypes.c_int]
    lib.lgs_replay.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.lgs_replay.argtypes = [ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_long),
                               ctypes.c_char_p, ctypes.c_int]
    lib.lgs_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.lgs_append.restype = ctypes.c_int
    lib.lgs_append.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_long]
    lib.lgs_rewrite.restype = ctypes.c_int
    lib.lgs_rewrite.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_long]
    lib.lgs_close.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def _frames(entries: List[LogEntry]) -> bytes:
    """[u32 len][payload] concatenation — the native batch input."""
    buf = bytearray()
    for e in entries:
        rec = e.pack()
        buf += _U32.pack(len(rec)) + rec
    return bytes(buf)


class NativeLogStore(FileLogStore):
    """FileLogStore with the segment-file hot path moved into C++."""

    def __init__(self, directory: str, lib=None):
        self._lib = lib or load_liblogstore()
        if self._lib is None:
            raise RuntimeError("liblogstore.so not available")
        self._handle: Optional[ctypes.c_void_p] = None
        super().__init__(directory)
        # The native fd owns all segment writes; a Python append handle
        # would just pin the old inode across native rewrites.
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # ------------------------------------------------------------ internals
    def _open_native(self) -> None:
        err = ctypes.create_string_buffer(256)
        handle = self._lib.lgs_open(self._log_path.encode(), err, 256)
        if not handle:
            raise RuntimeError(
                f"liblogstore open failed: {err.value.decode()}")
        self._handle = ctypes.c_void_p(handle)

    def _replay(self) -> None:
        # Side files (stable kv, snapshot) and LEGACY headerless segments
        # stay on the Python path: upgrade once, then go native.
        if os.path.exists(self._log_path):
            with open(self._log_path, "rb") as fh:
                head = fh.read(4)
            if head and head != _MAGIC:
                super()._replay()  # sets _needs_upgrade
                return
        self._load_side_files()
        self._open_native()
        n = ctypes.c_long()
        err = ctypes.create_string_buffer(256)
        buf = self._lib.lgs_replay(self._handle, ctypes.byref(n), err, 256)
        if not buf:
            raise RuntimeError(
                f"liblogstore replay failed: {err.value.decode()}")
        try:
            raw = ctypes.string_at(buf, n.value)
        finally:
            self._lib.lgs_free(buf)
        entries = []
        off = 0
        while off + 4 <= len(raw):
            (length,) = _U32.unpack_from(raw, off)
            entries.append(LogEntry.unpack(raw[off + 4:off + 4 + length]))
            off += 4 + length
        # InMemLogStore grandparent applies the entries.
        super(FileLogStore, self).store_entries(entries)

    # ------------------------------------------------------------ overrides
    def _append_file(self, entries: List[LogEntry]) -> None:
        frames = _frames(entries)
        rc = self._lib.lgs_append(self._handle, frames, len(frames))
        if rc != 0:
            raise OSError(f"liblogstore append failed (rc={rc})")

    def _rewrite_file(self) -> None:
        if self._handle is None:
            # Constructor path for a legacy upgrade: do the Python rewrite
            # (writes v2 format), then open natively.
            super()._rewrite_file()
            self._fh.close()
            self._fh = None
            self._open_native()
            return
        with self._lock:
            entries = [self._entries[i] for i in sorted(self._entries)]
        frames = _frames(entries)
        rc = self._lib.lgs_rewrite(self._handle, frames, len(frames))
        if rc != 0:
            raise OSError(f"liblogstore rewrite failed (rc={rc})")

    def close(self) -> None:
        if self._handle is not None:
            self._lib.lgs_close(self._handle)
            self._handle = None
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def make_log_store(directory: str):
    """Native when built, Python otherwise — same on-disk format."""
    if load_liblogstore() is not None:
        try:
            return NativeLogStore(directory)
        except Exception:
            LOG.exception("native log store failed; using Python store")
    return FileLogStore(directory)
