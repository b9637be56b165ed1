"""Minimal HOCON-subset parser.

Parses the configuration dialect of the NeuralUDF confs (``confs/*.conf``): nested ``name { ... }`` sections,
``key = value`` pairs, ``#`` and ``//`` comments, optional trailing commas,
bracketed lists, and bare (unquoted) string values.  Only what those files
need — this is not a general HOCON implementation. A frozen copy of
the port's ``hocon.py``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List


def _strip_comment(line: str) -> str:
    # '#' or '//' starts a comment unless inside quotes (confs never quote).
    for marker in ("#", "//"):
        idx = line.find(marker)
        if idx >= 0:
            line = line[:idx]
    return line.rstrip()


def _coerce(token: str) -> Any:
    token = token.strip().rstrip(",").strip()
    if token.startswith('"') and token.endswith('"') and len(token) >= 2:
        return token[1:-1]
    low = token.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(token)
    except ValueError:
        pass
    try:
        return float(token)
    except ValueError:
        pass
    return token


def _parse_list(text: str) -> List[Any]:
    inner = text.strip().rstrip(",").strip()  # tolerate 'skips = [4],'
    assert inner.startswith("[") and inner.endswith("]"), inner
    inner = inner[1:-1]
    items = [t.strip() for t in re.split(r"[,\n]", inner)]
    return [_coerce(t) for t in items if t.strip()]


def _split_top_level(text: str) -> List[str]:
    """Split on commas that are not inside brackets."""
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if "".join(cur).strip():
        parts.append("".join(cur))
    return [p for p in parts if p.strip()]


def parse_string(text: str) -> Dict[str, Any]:
    """Parse HOCON-subset text into a nested dict."""
    root: Dict[str, Any] = {}
    stack: List[Dict[str, Any]] = [root]
    lines = text.split("\n")
    i = 0
    while i < len(lines):
        line = _strip_comment(lines[i]).strip()
        i += 1
        if not line:
            continue
        if line == "}":
            stack.pop()
            continue
        # inline section:  name { k = v, k2 = v2, ... }
        m = re.match(r"^([\w.\-]+)\s*\{(.*)\}\s*$", line)
        if m:
            sec = {}
            for part in _split_top_level(m.group(2)):
                km = re.match(r"^([\w.\-]+)\s*=\s*(.*)$", part.strip())
                if not km:
                    raise ValueError(f"hocon: bad inline entry {part!r}")
                val = km.group(2).strip()
                sec[km.group(1)] = _parse_list(val) if val.startswith("[") else _coerce(val)
            stack[-1][m.group(1)] = sec
            continue
        # section start:  name {
        m = re.match(r"^([\w.\-]+)\s*\{\s*$", line)
        if m:
            sec: Dict[str, Any] = {}
            stack[-1][m.group(1)] = sec
            stack.append(sec)
            continue
        # key = value  (also accepts "key = [" spanning multiple lines)
        m = re.match(r"^([\w.\-]+)\s*=\s*(.*)$", line)
        if m:
            key, val = m.group(1), m.group(2).strip()
            if val.startswith("[") and "]" not in val:
                parts = [val]
                while i < len(lines):
                    nxt = _strip_comment(lines[i]).strip()
                    i += 1
                    parts.append(nxt)
                    if "]" in nxt:
                        break
                val = "\n".join(parts)
            if val.startswith("["):
                stack[-1][key] = _parse_list(val)
            else:
                stack[-1][key] = _coerce(val)
            continue
        raise ValueError(f"hocon: cannot parse line: {line!r}")
    if len(stack) != 1:
        raise ValueError("hocon: unbalanced braces")
    return root


def parse_file(path: str, case: str | None = None) -> Dict[str, Any]:
    """Load a conf file, substituting CASE_NAME like the reference runner
    (ref: exp_runner_blending.py:39-45)."""
    with open(path) as f:
        text = f.read()
    if case is not None:
        text = text.replace("CASE_NAME", case)
    return parse_string(text)
