"""Checker framework: per-file AST contexts with caching, a checker
registry, and the runner behind both the CLI and the tier-1 gate.

One parse per file per process (keyed on path + mtime/size), shared by
every checker — the lint subcommand and the test gate both complete in
one walk of the tree.

Copied from nomad_tpu/analysis/framework.py; only the imports and
the package root (the port's own) differ.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, Iterator, List, Optional, Tuple, Type

import nomad_tpu_torch

from .findings import Finding, is_suppressed, parse_suppressions

PKG_ROOT = os.path.dirname(os.path.abspath(nomad_tpu_torch.__file__))


class FileContext:
    """Parsed view of one source file, cached across runs."""

    __slots__ = ("path", "source", "tree", "allows")

    def __init__(self, path: str, source: str, tree: ast.AST,
                 allows: Dict[int, set]):
        self.path = path
        self.source = source
        self.tree = tree
        self.allows = allows

    def rel(self, root: str = PKG_ROOT) -> str:
        return os.path.relpath(self.path, root)


# (path) -> (mtime_ns, size, FileContext)
_CACHE: Dict[str, Tuple[int, int, FileContext]] = {}


def load_file(path: str) -> Optional[FileContext]:
    """Parse (or fetch from cache) one file; None if it doesn't parse —
    syntax errors are the interpreter's job, not the linter's."""
    path = os.path.abspath(path)
    try:
        st = os.stat(path)
    except OSError:
        return None
    cached = _CACHE.get(path)
    if cached is not None and cached[0] == st.st_mtime_ns \
            and cached[1] == st.st_size:
        return cached[2]
    try:
        with open(path, encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=path)
    except (OSError, SyntaxError, ValueError):
        return None
    ctx = FileContext(path, source, tree, parse_suppressions(source))
    _CACHE[path] = (st.st_mtime_ns, st.st_size, ctx)
    return ctx


def iter_py_files(root: str) -> Iterator[str]:
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


class Checker:
    """Base checker. Subclasses set `id` and implement `check_file`;
    checkers needing cross-file state override `finalize` too."""

    id: str = ""
    description: str = ""

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        return ()

    def finalize(self, full_tree: bool) -> Iterable[Finding]:
        """Called once after every file; `full_tree` is True when the scan
        covered the whole package (registry-completeness checks only make
        sense there)."""
        return ()


_REGISTRY: List[Type[Checker]] = []


def register(cls: Type[Checker]) -> Type[Checker]:
    _REGISTRY.append(cls)
    return cls


def all_checkers() -> List[Type[Checker]]:
    from . import checkers as _  # noqa: F401  (populate the registry)

    return list(_REGISTRY)


def run_checks(paths: Optional[List[str]] = None,
               checker_ids: Optional[List[str]] = None,
               include_suppressed: bool = False) -> List[Finding]:
    """Run checkers over `paths` (files or directories; default: the
    installed nomad_tpu_torch tree). Suppressed findings are dropped unless
    `include_suppressed`, in which case they carry suppressed=True."""
    full_tree = not paths
    files: List[str] = []
    for p in (paths or [PKG_ROOT]):
        p = os.path.abspath(p)
        if os.path.isdir(p):
            files.extend(iter_py_files(p))
        else:
            files.append(p)

    classes = all_checkers()
    if checker_ids is not None:
        unknown = set(checker_ids) - {c.id for c in classes}
        if unknown:
            raise ValueError(f"unknown checker ids: {sorted(unknown)}")
        classes = [c for c in classes if c.id in checker_ids]
    instances = [cls() for cls in classes]

    raw: List[Finding] = []
    contexts = [ctx for ctx in (load_file(f) for f in files)
                if ctx is not None]
    for checker in instances:
        for ctx in contexts:
            raw.extend(checker.check_file(ctx))
        raw.extend(checker.finalize(full_tree))

    out: List[Finding] = []
    for f in raw:
        ctx = _CACHE.get(os.path.abspath(f.path))
        allows = ctx[2].allows if ctx is not None else {}
        if is_suppressed(allows, f.checker, f.line):
            if include_suppressed:
                f.suppressed = True
                out.append(f)
        else:
            out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.checker))
    return out
