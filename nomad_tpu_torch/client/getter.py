"""Artifact download (reference: client/getter/getter.go).

http/https fetch with optional sha256 checksum verification and
escape-prevention on the destination, plus env interpolation of the source.

Copied from nomad_tpu/client/getter.py; only the imports differ.
"""

from __future__ import annotations

import hashlib
import os
import urllib.parse
import urllib.request

from nomad_tpu_torch.structs import TaskArtifact

from .env import TaskEnv


class ArtifactError(Exception):
    pass


def get_artifact(artifact: TaskArtifact, task_dir: str,
                 task_env: TaskEnv) -> str:
    """Fetch into the task dir; returns the destination path."""
    source = task_env.replace(artifact.GetterSource)
    parsed = urllib.parse.urlparse(source)
    if parsed.scheme not in ("http", "https", "file"):
        raise ArtifactError(f"unsupported artifact scheme: {parsed.scheme!r}")

    root = os.path.normpath(task_dir)
    dest_dir = os.path.normpath(os.path.join(root, artifact.RelativeDest))
    if dest_dir != root and not dest_dir.startswith(root + os.sep):
        raise ArtifactError("artifact destination escapes task directory")
    os.makedirs(dest_dir, exist_ok=True)
    filename = os.path.basename(parsed.path) or "artifact"
    dest = os.path.join(dest_dir, filename)

    try:
        with urllib.request.urlopen(source, timeout=300) as resp, \
                open(dest, "wb") as out:
            while True:
                chunk = resp.read(65536)
                if not chunk:
                    break
                out.write(chunk)
    except Exception as e:
        raise ArtifactError(f"failed to fetch {source!r}: {e}") from e

    checksum = artifact.GetterOptions.get("checksum", "")
    if checksum:
        algo, _, want = checksum.partition(":")
        h = hashlib.new(algo or "sha256")
        with open(dest, "rb") as f:
            for chunk in iter(lambda: f.read(65536), b""):
                h.update(chunk)
        if h.hexdigest() != want:
            raise ArtifactError(
                f"checksum mismatch for {source!r}: got {h.hexdigest()}")
    if os.name == "posix":
        os.chmod(dest, 0o755)
    return dest
