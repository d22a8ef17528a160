"""Minimal HCL (HashiCorp Configuration Language v1) parser.

Standalone tokenizer + recursive-descent parser covering the subset the job
spec and agent config files use (reference grammar: hashicorp/hcl as consumed
by jobspec/parse.go and command/agent/config_parse.go): blocks with string
labels, assignments, strings with escapes, heredocs, numbers, booleans,
lists, objects, and `#`, `//`, `/* */` comments.

Parses to plain Python dicts; repeated blocks accumulate into lists.

Copied from nomad_tpu/jobspec/hcl.py; only the imports differ.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>\#[^\n]*|//[^\n]*|/\*.*?\*/)
  | (?P<heredoc><<-?(?P<tag>[A-Za-z0-9_]+)\n(?P<body>.*?)\n\s*(?P=tag))
  | (?P<string>"(?:\\.|[^"\\])*")
  | (?P<number>-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)
  | (?P<bool>\btrue\b|\bfalse\b)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_\-.]*)
  | (?P<punct>[{}\[\],=:])
""", re.VERBOSE | re.DOTALL)


class HCLParseError(ValueError):
    def __init__(self, msg: str, pos: int, text: str):
        line = text.count("\n", 0, pos) + 1
        col = pos - (text.rfind("\n", 0, pos) + 1) + 1
        super().__init__(f"{msg} at line {line}, column {col}")
        self.line = line
        self.column = col


def _tokenize(text: str) -> List[Tuple[str, Any, int]]:
    tokens: List[Tuple[str, Any, int]] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise HCLParseError(f"unexpected character {text[pos]!r}", pos, text)
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            pass
        elif kind == "heredoc":
            tokens.append(("string", m.group("body"), pos))
        elif kind == "string":
            raw = m.group("string")[1:-1]
            tokens.append(("string", _unescape(raw), pos))
        elif kind == "number":
            raw = m.group("number")
            val = float(raw) if ("." in raw or "e" in raw or "E" in raw) else int(raw)
            tokens.append(("number", val, pos))
        elif kind == "bool":
            tokens.append(("bool", m.group("bool") == "true", pos))
        elif kind == "ident":
            tokens.append(("ident", m.group("ident"), pos))
        elif kind == "punct":
            # The heredoc regex consumes its own match; `tag` group overlap is
            # impossible here.
            tokens.append((m.group("punct"), m.group("punct"), pos))
        pos = m.end()
    tokens.append(("eof", None, len(text)))
    return tokens


def _unescape(raw: str) -> str:
    out = []
    i = 0
    while i < len(raw):
        c = raw[i]
        if c == "\\" and i + 1 < len(raw):
            nxt = raw[i + 1]
            out.append({"n": "\n", "t": "\t", "r": "\r", '"': '"',
                        "\\": "\\"}.get(nxt, "\\" + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.tokens = _tokenize(text)
        self.i = 0

    def peek(self) -> Tuple[str, Any, int]:
        return self.tokens[self.i]

    def next(self) -> Tuple[str, Any, int]:
        tok = self.tokens[self.i]
        self.i += 1
        return tok

    def expect(self, kind: str) -> Any:
        tok = self.next()
        if tok[0] != kind:
            raise HCLParseError(f"expected {kind}, got {tok[0]} ({tok[1]!r})",
                                tok[2], self.text)
        return tok[1]

    # ------------------------------------------------------------- grammar
    def parse_body(self, terminator: Optional[str]) -> Dict[str, Any]:
        """A sequence of attributes and blocks until terminator/eof."""
        out: Dict[str, Any] = {}
        while True:
            kind, value, pos = self.peek()
            if kind == "eof" or (terminator is not None and kind == terminator):
                return out
            if kind not in ("ident", "string"):
                raise HCLParseError(
                    f"expected identifier, got {kind} ({value!r})", pos, self.text)
            key = self.next()[1]

            kind, value, pos = self.peek()
            if kind == "=":
                self.next()
                _merge(out, key, self.parse_value())
            elif kind in ("string", "ident", "{"):
                # Block, possibly with labels: key "label" ["label2"] { ... }
                labels = []
                while self.peek()[0] in ("string", "ident"):
                    labels.append(self.next()[1])
                self.expect("{")
                body = self.parse_body("}")
                self.expect("}")
                # Nest under the labels so repeated blocks group naturally.
                node: Any = body
                for label in reversed(labels):
                    node = {label: node}
                _merge_block(out, key, node, labeled=bool(labels))
            else:
                raise HCLParseError(
                    f"expected '=' or block after {key!r}", pos, self.text)
            # Optional comma separators between items (objects).
            if self.peek()[0] == ",":
                self.next()

    def parse_value(self) -> Any:
        kind, value, pos = self.next()
        if kind in ("string", "number", "bool"):
            return value
        if kind == "ident":  # bare word treated as string
            return value
        if kind == "[":
            items = []
            while True:
                if self.peek()[0] == "]":
                    self.next()
                    return items
                items.append(self.parse_value())
                if self.peek()[0] == ",":
                    self.next()
        if kind == "{":
            body = self.parse_body("}")
            self.expect("}")
            return body
        raise HCLParseError(f"unexpected {kind} in value", pos, self.text)


def _merge(out: Dict[str, Any], key: str, value: Any) -> None:
    if key in out:
        existing = out[key]
        if isinstance(existing, list):
            existing.append(value)
        else:
            out[key] = [existing, value]
    else:
        out[key] = value


def _merge_block(out: Dict[str, Any], key: str, node: Any, labeled: bool) -> None:
    if key not in out:
        out[key] = node
        return
    existing = out[key]
    if labeled and isinstance(existing, dict) and isinstance(node, dict):
        # Merge label trees: job "a" {...} job "b" {...}
        for label, body in node.items():
            if label in existing:
                _merge_block(existing, label, body, labeled=False)
            else:
                existing[label] = body
        return
    if isinstance(existing, list):
        existing.append(node)
    else:
        out[key] = [existing, node]


def parse(text: str) -> Dict[str, Any]:
    """Parse HCL text into nested dicts/lists."""
    p = _Parser(text)
    return p.parse_body(None)
