"""Minimal Helm-compatible chart renderer, with a values reader of its own.

The port's counterpart of karpenter_tpu/utils/helmlite.py. The charts
(charts/karpenter-tpu-torch, the port's, and charts/karpenter-tpu) keep
their templates to plain ``{{ .Values.path.to.key }}`` substitutions: no
pipes, conditionals or sprig functions, so that ``helm template`` and this
renderer give byte-identical output. Templates render in sorted filename
order, joined with ``---``; a missing key raises ``KeyError``.

The JAX package reads ``values.yaml`` with PyYAML; the port reads it with
:func:`parse_values`, which takes the small subset of YAML a values file
of these charts uses and raises :class:`ValuesSyntaxError`, naming the
line, on anything else: it never guesses. The subset:

- block mappings by indentation (spaces only), one ``key: value`` or
  ``key:`` opening a nested mapping a line, keys of letters, digits, ``_``,
  ``.`` and ``-`` that start with a letter or ``_`` (and are no YAML bool
  or null word), each key once;
- scalars: double- or single-quoted strings without escapes, and plain
  scalars that YAML 1.1 reads as a decimal int, ``true`` / ``false``, or a
  string (a word of letters, digits and ``_ . / : @ + -`` that starts with a
  letter, ``_`` or ``/``, or a quantity such as ``100m`` or ``1Gi``);
- comments (a line of its own, or after a value and a space) and blank
  lines.

CLI: ``python -m karpenter_tpu_torch.utils.helmlite <chart-dir>
[--set a.b.c=v ...]`` prints the rendered multi-document YAML.
"""

from __future__ import annotations

import os
import re
import sys
from typing import Any, Dict, List, Optional, Tuple

_SUBST = re.compile(r"\{\{\s*\.Values\.([A-Za-z0-9_.]+)\s*\}\}")

_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_.-]*")
_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)")
_WORD = re.compile(r"[A-Za-z_/][A-Za-z0-9_./:@+-]*")
_QUANTITY = re.compile(r"[0-9]+[A-Za-z]+")
# plain words that YAML 1.1 reads as a bool or a null: only true and false
# are in the subset
_RESERVED = {"y", "Y", "yes", "Yes", "YES", "n", "N", "no", "No", "NO", "True", "TRUE",
             "False", "FALSE", "on", "On", "ON", "off", "Off", "OFF", "null", "Null", "NULL"}


_NESTED = object()  # a "key:" line: a nested mapping follows


class ValuesSyntaxError(ValueError):
    """A values file outside the subset :func:`parse_values` reads."""


def _lookup(values: Dict[str, Any], dotted: str):
    cur: Any = values
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            raise KeyError(f"values key not found: .Values.{dotted}")
        cur = cur[part]
    return cur


def _fmt(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"  # Go/Helm bool rendering
    return str(v)


def render_text(template: str, values: Dict[str, Any]) -> str:
    return _SUBST.sub(lambda m: _fmt(_lookup(values, m.group(1))), template)


def _scalar(text: str, where: str):
    """One value's text (comment included) → its Python value."""
    if text[0] in "\"'":
        close = text.find(text[0], 1)
        body = text[1:close]
        rest = text[close + 1:] if close > 0 else ""
        if close < 0 or (text[0] == '"' and "\\" in body) or \
                (rest.strip() and not re.match(r"\s+#", rest)) or \
                (text[0] == "'" and rest.startswith("'")):
            raise ValuesSyntaxError(f"{where}: a quoted scalar outside the subset (escapes, "
                                    "an embedded quote, or text after it)")
        return body
    plain = re.split(r"\s+#", text, maxsplit=1)[0].rstrip()
    if _INT.fullmatch(plain):
        return int(plain)
    if plain in ("true", "false"):
        return plain == "true"
    if plain not in _RESERVED and not plain.endswith(":") and (
            _WORD.fullmatch(plain) or _QUANTITY.fullmatch(plain)):
        return plain
    raise ValuesSyntaxError(f"{where}: {plain!r} is not a scalar of the subset "
                            "(quote a string; anchors, aliases, tags, flow collections, "
                            "block scalars and sequences are not read)")


def parse_values(text: str, name: str = "values.yaml") -> Dict[str, Any]:
    """The mapping a values file in the subset holds (module docstring);
    raises ValuesSyntaxError naming the file and line otherwise."""
    lines: List[Tuple[int, int, str, Any]] = []  # (lineno, indent, key, value)
    for lineno, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{lineno}"
        if "\t" in raw:
            raise ValuesSyntaxError(f"{where}: a tab (indent with spaces)")
        stripped = raw.strip()
        if not stripped or stripped.startswith("#"):
            continue
        indent = len(raw) - len(raw.lstrip(" "))
        key, colon, value = stripped.partition(":")
        if not colon or not _KEY.fullmatch(key) or key in _RESERVED or \
                key in ("true", "false") or (value and not value[0] == " "):
            raise ValuesSyntaxError(f"{where}: expected 'key: value' or 'key:' "
                                    f"(a block mapping), got {stripped!r}")
        value = value.strip()
        nested = not value or value.startswith("#")
        lines.append((lineno, indent, key, _NESTED if nested else _scalar(value, where)))
    if not lines:
        raise ValuesSyntaxError(f"{name}: no mapping (an empty values file)")
    if lines[0][1] != 0:
        raise ValuesSyntaxError(f"{name}:{lines[0][0]}: the top mapping must not be indented")
    return _mapping(lines, 0, 0, name)[0]


def _mapping(lines, i: int, indent: int, name: str):
    """The mapping whose keys sit at ``indent`` from line entry ``i``;
    returns it and the first entry past it."""
    out: Dict[str, Any] = {}
    while i < len(lines):
        lineno, ind, key, value = lines[i]
        where = f"{name}:{lineno}"
        if ind < indent:
            break
        if ind > indent:
            raise ValuesSyntaxError(f"{where}: unexpected indent")
        if key in out:
            raise ValuesSyntaxError(f"{where}: key {key!r} given twice")
        if value is not _NESTED:
            out[key] = value
            i += 1
            continue
        if i + 1 >= len(lines) or lines[i + 1][1] <= indent:
            raise ValuesSyntaxError(f"{where}: {key!r} has no value and no nested mapping")
        out[key], i = _mapping(lines, i + 1, lines[i + 1][1], name)
    return out, i


def load_values(chart_dir: str, overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    path = os.path.join(chart_dir, "values.yaml")
    with open(path) as f:
        values = parse_values(f.read(), path)
    for dotted, v in (overrides or {}).items():
        cur = values
        parts = dotted.split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return values


def render_chart(chart_dir: str, overrides: Optional[Dict[str, Any]] = None) -> str:
    """All templates/*.yaml rendered and joined with '---' separators, in
    sorted filename order (helm renders alphabetically too)."""
    values = load_values(chart_dir, overrides)
    tdir = os.path.join(chart_dir, "templates")
    docs: List[str] = []
    for fname in sorted(os.listdir(tdir)):
        if not fname.endswith((".yaml", ".yml")):
            continue
        with open(os.path.join(tdir, fname)) as f:
            docs.append(render_text(f.read(), values).strip())
    return "\n---\n".join(docs) + "\n"


def main(argv: List[str]) -> int:
    if not argv or argv[0].startswith("-"):
        print("usage: helmlite <chart-dir> [--set a.b=c ...]", file=sys.stderr)
        return 2
    chart_dir = argv[0]
    overrides: Dict[str, Any] = {}
    args = argv[1:]
    while args:
        if args[0] == "--set" and len(args) >= 2:
            k, _, v = args[1].partition("=")
            overrides[k] = v
            args = args[2:]
        else:
            print(f"unknown argument {args[0]}", file=sys.stderr)
            return 2
    sys.stdout.write(render_chart(chart_dir, overrides))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
