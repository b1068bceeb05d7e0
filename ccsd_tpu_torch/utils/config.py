"""Config loading with attribute access, without PyYAML.

Port of ccsd_tpu/utils/config.py:17-62.  The card's machine has no PyYAML,
so :func:`load_yaml` reads the YAML subset that ``config/*.yaml`` uses (as
written by ``yaml.safe_dump`` in tools/gen_configs.py): nested block
mappings, block and flow lists, comments, and plain or quoted scalars
resolved by the YAML 1.1 rules PyYAML applies (bool, null, int, float).
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Tuple


class AttrDict(dict):
    """dict with attribute access, recursively applied."""

    def __init__(self, d: dict | None = None, **kwargs):
        super().__init__()
        d = dict(d or {}, **kwargs)
        for k, v in d.items():
            self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, v: Any) -> Any:
        if isinstance(v, dict):
            return cls(v)
        if isinstance(v, (list, tuple)):
            return type(v)(cls._wrap(x) for x in v)
        return v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = self._wrap(v)

    def to_dict(self) -> dict:
        def unwrap(v):
            if isinstance(v, AttrDict):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(unwrap(x) for x in v)
            return v

        return {k: unwrap(v) for k, v in self.items()}


# YAML 1.1 implicit resolvers, as PyYAML's SafeLoader applies them
_BOOL = {"yes": True, "true": True, "on": True,
         "no": False, "false": False, "off": False}
_NULL = {"~", "null", "Null", "NULL", ""}
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"^[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$"
    r"|^[-+]?\.(inf|Inf|INF)$|^\.(nan|NaN|NAN)$"
)


def _scalar(s: str) -> Any:
    s = s.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        body = s[1:-1]
        return body.replace("''", "'") if s[0] == "'" else body
    if s in _NULL:
        return None
    if s in ("yes", "Yes", "YES", "no", "No", "NO", "true", "True", "TRUE",
             "false", "False", "FALSE", "on", "On", "ON", "off", "Off", "OFF"):
        return _BOOL[s.lower()]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s) and s not in (".", "-.", "+."):
        t = s.replace("_", "").lower()
        if t.endswith("inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        if t.endswith("nan"):
            return float("nan")
        return float(t)
    return s


def _split_flow(body: str) -> List[str]:
    """Split the inside of a flow collection at top-level commas."""
    out, depth, cur, quote = [], 0, "", None
    for ch in body:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
            continue
        if ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            out.append(cur)
            cur = ""
            continue
        cur += ch
    if cur.strip():
        out.append(cur)
    return out


def _value(s: str) -> Any:
    s = s.strip()
    if s.startswith("[") and s.endswith("]"):
        return [_value(p) for p in _split_flow(s[1:-1])]
    if s.startswith("{") and s.endswith("}"):
        out = {}
        for p in _split_flow(s[1:-1]):
            k, _, v = p.partition(":")
            out[_scalar(k)] = _value(v)
        return out
    return _scalar(s)


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _key_split(text: str) -> Tuple[str, str] | None:
    """'key: value' -> (key, value); None when the line is not a mapping."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == ":" and (i + 1 == len(text) or text[i + 1] == " "):
            return text[:i].strip(), text[i + 1:].strip()
    return None


def load_yaml(text: str) -> Any:
    """Parse the block-YAML subset of the repo's config files."""
    lines = []
    for raw in text.splitlines():
        body = _strip_comment(raw).rstrip()
        if body.strip() and body.strip() not in ("---", "..."):
            lines.append((len(body) - len(body.lstrip(" ")), body.strip()))

    def block(i: int, indent: int) -> Tuple[Any, int]:
        if lines[i][1].startswith("- ") or lines[i][1] == "-":
            seq = []
            while i < len(lines) and lines[i][0] == indent and (
                lines[i][1].startswith("- ") or lines[i][1] == "-"
            ):
                rest = lines[i][1][1:].strip()
                if not rest:
                    val, i = block(i + 1, lines[i + 1][0])
                elif _key_split(rest) is not None:
                    # "- key: v" opens a mapping indented past the dash
                    lines[i] = (indent + 2, rest)
                    val, i = block(i, indent + 2)
                else:
                    val, i = _value(rest), i + 1
                seq.append(val)
            return seq, i
        out = {}
        while i < len(lines) and lines[i][0] == indent:
            kv = _key_split(lines[i][1])
            if kv is None:
                raise ValueError(f"unsupported YAML line: {lines[i][1]!r}")
            key, rest = kv
            i += 1
            if rest:
                out[_scalar(key)] = _value(rest)
            elif i < len(lines) and (
                lines[i][0] > indent
                or (lines[i][0] == indent and lines[i][1].startswith("-"))
            ):
                out[_scalar(key)], i = block(i, lines[i][0])
            else:
                out[_scalar(key)] = None
        return out, i

    if not lines:
        return None
    data, end = block(0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"unsupported YAML structure at: {lines[end][1]!r}")
    return data


def get_config(config_name: str, seed: int, folder: str = "./") -> AttrDict:
    """Load config/<name>.yaml and inject the seed.  (config.py:54-62)"""
    path = os.path.join(folder, "config", f"{config_name}.yaml")
    with open(path) as f:
        config = AttrDict(load_yaml(f.read()))
    config.config_name = config_name
    config.seed = seed
    config.folder = folder
    return config
