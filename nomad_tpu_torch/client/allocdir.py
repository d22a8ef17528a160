"""Allocation directory layout (reference: client/allocdir/alloc_dir.go).

  <alloc_dir>/<alloc_id>/
    alloc/            shared between the alloc's tasks
      logs/ tmp/ data/
    <task>/
      local/          task-private scratch

Also provides the list/stat/read primitives behind the fs API
(reference: AllocDirFS, client/allocdir/alloc_dir.go:303-360) and, when
running as root on Linux, chroot population for the exec driver via
read-only bind mounts of the host system dirs (reference:
alloc_dir_linux.go Embed/MountSpecialDirs).

Copied from nomad_tpu/client/allocdir.py; only the imports differ.
"""

from __future__ import annotations

import logging
import os
import shutil
import stat as statmod
import subprocess
from dataclasses import dataclass
from typing import Dict, List

logger = logging.getLogger("nomad.allocdir")

SHARED_ALLOC_NAME = "alloc"
SHARED_DIRS = ("logs", "tmp", "data")
TASK_LOCAL = "local"

# Host dirs bind-mounted into an exec task's chroot (reference default:
# chrootEnv in client/config, applied by alloc_dir_linux.go Embed). Missing
# sources are skipped.
DEFAULT_CHROOT_ENV = ("/bin", "/etc", "/lib", "/lib32", "/lib64",
                      "/run/resolvconf", "/sbin", "/usr")


@dataclass
class FileInfo:
    Name: str = ""
    IsDir: bool = False
    Size: int = 0
    FileMode: str = ""
    ModTime: float = 0.0


class AllocDir:
    def __init__(self, root: str):
        self.alloc_dir = root
        self.shared_dir = os.path.join(root, SHARED_ALLOC_NAME)
        self.task_dirs: Dict[str, str] = {}
        # Active bind mounts inside task chroots, in mount order. MUST be
        # unmounted before any rmtree: deleting through a live bind mount
        # of /bin would destroy the host's.
        self._mounts: List[str] = []
        self._chroots: set = set()  # tasks whose chroot is already built

    def build(self, tasks: List[str]) -> None:
        os.makedirs(self.alloc_dir, exist_ok=True)
        os.makedirs(self.shared_dir, exist_ok=True)
        for sub in SHARED_DIRS:
            os.makedirs(os.path.join(self.shared_dir, sub), exist_ok=True)
        for task in tasks:
            tdir = os.path.join(self.alloc_dir, task)
            os.makedirs(os.path.join(tdir, TASK_LOCAL), exist_ok=True)
            self.task_dirs[task] = tdir

    def log_dir(self) -> str:
        return os.path.join(self.shared_dir, "logs")

    # ------------------------------------------------------------- chroot
    def build_chroot(self, task: str, chroot_env=DEFAULT_CHROOT_ENV) -> str:
        """Populate the task dir as a chroot: read-only bind mounts of the
        host system dirs plus /dev and /proc (reference:
        alloc_dir_linux.go Embed + MountSpecialDirs). Requires root; the
        task dir itself becomes the chroot root, so the task sees its
        `local/` and the shared `alloc/` at /local and /alloc. Returns the
        chroot path. Raises on mount failure (half-built mounts are torn
        down). Idempotent per task: a restarting task reuses its existing
        chroot instead of stacking a second set of mounts."""
        root = self.task_dirs[task]
        if task in self._chroots:
            return root
        # Roll back only THIS task's mounts on failure: a sibling task of
        # the same alloc may be running out of its own chroot.
        before = len(self._mounts)
        try:
            for src in chroot_env:
                if not os.path.isdir(src):
                    continue
                dest = os.path.join(root, src.lstrip("/"))
                os.makedirs(dest, exist_ok=True)
                self._bind(src, dest, readonly=True)
            # Special dirs: devices and /proc (MountSpecialDirs).
            dev = os.path.join(root, "dev")
            os.makedirs(dev, exist_ok=True)
            self._bind("/dev", dev, readonly=False)
            proc = os.path.join(root, "proc")
            os.makedirs(proc, exist_ok=True)
            subprocess.run(["mount", "-t", "proc", "proc", proc],
                           check=True, capture_output=True)
            self._mounts.append(proc)
            # The shared alloc dir appears at /alloc inside the chroot.
            shared = os.path.join(root, SHARED_ALLOC_NAME)
            os.makedirs(shared, exist_ok=True)
            self._bind(self.shared_dir, shared, readonly=False)
        except Exception:
            mine, self._mounts = self._mounts[before:], self._mounts[:before]
            self._unmount(mine)
            raise
        self._chroots.add(task)
        return root

    def _bind(self, src: str, dest: str, readonly: bool) -> None:
        subprocess.run(["mount", "--bind", src, dest],
                       check=True, capture_output=True)
        self._mounts.append(dest)
        if readonly:
            # A silent failure here would leave host /bin//etc//usr
            # WRITABLE inside the chroot — fail the task start instead.
            r = subprocess.run(
                ["mount", "-o", "remount,ro,bind", dest],
                capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(
                    f"read-only remount of {dest} failed: {r.stderr}")

    @staticmethod
    def _live_mounts() -> set:
        """Mount points from /proc/self/mountinfo. os.path.ismount is blind
        to bind mounts on the same filesystem (equal st_dev), which is
        exactly what /bin-into-allocdir binds are — the rmtree safety check
        must use the kernel's own table."""
        points = set()
        try:
            with open("/proc/self/mountinfo") as f:
                for line in f:
                    fields = line.split()
                    if len(fields) >= 5:
                        # Field 5 is the mount point, octal-escaped.
                        points.add(
                            fields[4].encode().decode("unicode_escape"))
        except OSError:
            pass
        return points

    @staticmethod
    def _unmount(dests) -> None:
        for dest in reversed(list(dests)):
            r = subprocess.run(["umount", dest], capture_output=True)
            if r.returncode != 0:
                # Busy mount: detach lazily; callers re-verify via
                # /proc/self/mountinfo.
                subprocess.run(["umount", "-l", dest], capture_output=True)

    def unmount_all(self) -> bool:
        """Tear down chroot mounts in reverse order — the tracked list PLUS
        anything /proc/self/mountinfo shows under the alloc dir. The kernel
        table is authoritative: after an agent restart the in-memory list
        is empty but the previous process's chroot mounts are still live,
        and destroy()'s rmtree through a live /dev or /bin bind would
        delete host files. Returns True when nothing remains mounted under
        the alloc dir."""
        root = os.path.realpath(self.alloc_dir)

        def under_alloc(points) -> List[str]:
            # Deepest-first so nested mounts unwind in order.
            return sorted(
                (p for p in points
                 if p == root or p.startswith(root + os.sep)),
                key=len, reverse=True)

        self._unmount(self._mounts)
        untracked = under_alloc(self._live_mounts())
        if untracked:
            logger.info("unmounting %d untracked chroot mounts under %s "
                        "(previous agent run)", len(untracked), root)
            self._unmount(untracked)
        remaining = under_alloc(self._live_mounts())
        for dest in remaining:
            logger.error("chroot mount still active: %s", dest)
        self._mounts = remaining
        if not remaining:
            self._chroots.clear()
        return not remaining

    def destroy(self) -> None:
        # Refuse to delete while any bind mount is live: an rmtree through
        # a mounted /bin or /usr would delete the HOST's files.
        if not self.unmount_all():
            logger.error("alloc dir %s NOT removed: chroot mounts could "
                         "not be unmounted", self.alloc_dir)
            return
        shutil.rmtree(self.alloc_dir, ignore_errors=True)

    # ------------------------------------------------------------ fs API
    def _resolve(self, path: str) -> str:
        """Resolve a relative path, refusing escapes from the alloc dir."""
        root = os.path.normpath(self.alloc_dir)
        full = os.path.normpath(os.path.join(root, path.lstrip("/")))
        # Separator-anchored check: a sibling like <root>-evil must not pass.
        if full != root and not full.startswith(root + os.sep):
            raise PermissionError(f"path escapes alloc dir: {path}")
        return full

    def list_dir(self, path: str) -> List[FileInfo]:
        full = self._resolve(path)
        out = []
        for name in sorted(os.listdir(full)):
            st = os.stat(os.path.join(full, name))
            out.append(FileInfo(
                Name=name, IsDir=statmod.S_ISDIR(st.st_mode),
                Size=st.st_size, FileMode=statmod.filemode(st.st_mode),
                ModTime=st.st_mtime))
        return out

    def stat(self, path: str) -> FileInfo:
        full = self._resolve(path)
        st = os.stat(full)
        return FileInfo(
            Name=os.path.basename(full), IsDir=statmod.S_ISDIR(st.st_mode),
            Size=st.st_size, FileMode=statmod.filemode(st.st_mode),
            ModTime=st.st_mtime)

    def read_at(self, path: str, offset: int = 0, limit: int = -1) -> bytes:
        full = self._resolve(path)
        with open(full, "rb") as f:
            f.seek(offset)
            return f.read(limit if limit >= 0 else -1)
