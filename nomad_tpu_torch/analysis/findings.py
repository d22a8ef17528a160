"""Finding objects + the suppression-comment grammar.

A finding is one checker hit at one source location. Suppression is a
trailing comment on the offending line (or the line directly above)::

    # lint: allow(<checker-id>, <free-text reason>)

The reason is mandatory by grammar — an allow() without a reason does
not parse, so every suppression documents itself.

Copied from nomad_tpu/analysis/findings.py; only the imports differ.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

_ALLOW_RE = re.compile(
    r"#\s*lint:\s*allow\(\s*([a-z0-9_-]+)\s*,\s*([^)]+?)\s*\)")


@dataclass
class Finding:
    checker: str            # checker id, e.g. "swallow"
    path: str               # absolute path of the offending file
    line: int               # 1-indexed line number
    message: str
    suppressed: bool = False

    def to_dict(self) -> Dict[str, object]:
        return {"checker": self.checker, "path": self.path,
                "line": self.line, "message": self.message,
                "suppressed": self.suppressed}

    def render(self, relative_to: str = "") -> str:
        path = self.path
        if relative_to and path.startswith(relative_to):
            path = path[len(relative_to):].lstrip("/")
        sup = " (suppressed)" if self.suppressed else ""
        return f"{path}:{self.line}: [{self.checker}] {self.message}{sup}"


def parse_suppressions(source: str) -> Dict[int, Set[str]]:
    """Map of line number -> checker ids allowed on that line."""
    allows: Dict[int, Set[str]] = {}
    for lineno, text in enumerate(source.splitlines(), start=1):
        if "lint:" not in text:
            continue
        for m in _ALLOW_RE.finditer(text):
            allows.setdefault(lineno, set()).add(m.group(1))
    return allows


def parse_suppression_details(source: str
                              ) -> List[Tuple[int, str, str]]:
    """Every allow() in `source` as (line, checker id, reason) — the
    purity-boundary audit behind `nomad-tpu lint -suppressions`."""
    out: List[Tuple[int, str, str]] = []
    for lineno, text in enumerate(source.splitlines(), start=1):
        if "lint:" not in text:
            continue
        for m in _ALLOW_RE.finditer(text):
            out.append((lineno, m.group(1), m.group(2)))
    return out


def is_suppressed(allows: Dict[int, Set[str]], checker: str,
                  line: int) -> bool:
    """A finding at `line` is suppressed by an allow() for its checker on
    the same line or the line directly above it."""
    for candidate in (line, line - 1):
        if checker in allows.get(candidate, ()):
            return True
    return False
