"""A reader for the subset of YAML that the stock configs use, resolving
every scalar as ``yaml.safe_load`` (PyYAML, YAML 1.1) does; the port's
machines may lack PyYAML.

The subset:
  * comments (``#`` at the start of a line or after whitespace);
  * block mappings nested by indentation, with plain keys;
  * block sequences whose items are scalars or flow sequences
    (``- [300000, 1.0e-4]``), under a key or at the top;
  * flow sequences, nested (``[320, 448]``, ``[1, [2, 3]]``, a trailing
    comma allowed);
  * plain scalars: ints (decimal, ``0x``, ``0b``, a leading-0 octal,
    ``_`` separators), floats, booleans, null and strings.

Scalars resolve by YAML 1.1's rules, as PyYAML's resolver does: ``5.0e-5``
is a float, but ``1e-4`` (no dot) and ``1.0e4`` (an exponent without a
sign) are strings; ``yes``/``on`` are True and ``~`` is None.

Anything else raises :class:`YAMLSubsetError` naming the line: anchors,
aliases, tags, quoted scalars and keys, block scalars (``|``, ``>``),
flow mappings, several documents, directives, complex keys, mappings
inside a sequence, multi-line plain scalars, tabs in indentation, merge
keys, and the scalars PyYAML would turn into dates or base-60 numbers.
"""

from __future__ import annotations

import re

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|"
                   r"FALSE|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "true", "on"}
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                        |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                        (?:[Tt]|[ \t]+)[0-9][0-9]?
                        :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                        (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                        re.X)
# characters that cannot start a plain scalar here (YAML indicators)
_INDICATORS = set("[]{}#&*!|>'\"%@`,")


class YAMLSubsetError(ValueError):
    """A construct outside the subset this reader accepts."""


def _fail(lineno: int, msg: str):
    raise YAMLSubsetError(f"line {lineno}: {msg} (outside the YAML subset "
                          f"that maskflownet_torch.config reads)")


def resolve_scalar(text: str, lineno: int = 0):
    """A plain scalar's value under PyYAML's YAML 1.1 implicit resolvers."""
    s = text
    if s and (s[0] in _INDICATORS or (s[0] in "-?:" and (
            len(s) == 1 or s[1] == " "))):
        _fail(lineno, f"scalar {s!r} starts with an indicator")
    if ": " in s or s.endswith(":"):
        _fail(lineno, f"a mapping inside the scalar {s!r}")
    if s.startswith("<<") or s == "=":
        _fail(lineno, f"merge key or value tag {s!r}")
    if _BOOL.match(s):
        return s.lower() in _TRUE
    if _FLOAT.match(s):
        if ":" in s:
            _fail(lineno, f"base-60 float {s!r}")
        v = s.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        return sign * float(v)
    if _INT.match(s):
        if ":" in s:
            _fail(lineno, f"base-60 int {s!r}")
        v = s.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _NULL.match(s):
        return None
    if _TIMESTAMP.match(s):
        _fail(lineno, f"timestamp {s!r}")
    return s


def _flow_sequence(text: str, pos: int, lineno: int):
    """Parse the flow sequence starting at text[pos] == '['; returns
    (list, position after its ']')."""
    out = []
    pos += 1
    while True:
        while pos < len(text) and text[pos] == " ":
            pos += 1
        if pos >= len(text):
            _fail(lineno, "unclosed flow sequence (multi-line flow)")
        ch = text[pos]
        if ch == "]":
            return out, pos + 1
        if ch == "[":
            item, pos = _flow_sequence(text, pos, lineno)
        elif ch == "{":
            _fail(lineno, "flow mapping")
        elif ch == ",":
            _fail(lineno, "empty flow sequence entry")
        else:
            end = pos
            while end < len(text) and text[end] not in ",]":
                if text[end] in "[{}":
                    _fail(lineno, f"{text[end]!r} inside a flow scalar")
                end += 1
            item = resolve_scalar(text[pos:end].strip(), lineno)
            pos = end
        out.append(item)
        while pos < len(text) and text[pos] == " ":
            pos += 1
        if pos >= len(text):
            _fail(lineno, "unclosed flow sequence (multi-line flow)")
        if text[pos] == ",":
            pos += 1
        elif text[pos] != "]":
            _fail(lineno, f"expected ',' or ']' at {text[pos:]!r}")


def _inline(text: str, lineno: int):
    """The value written on one line: a flow sequence or a plain scalar."""
    if text.startswith("["):
        value, end = _flow_sequence(text, 0, lineno)
        if text[end:].strip():
            _fail(lineno, f"text after a flow sequence: {text[end:]!r}")
        return value
    if text.startswith("{"):
        _fail(lineno, "flow mapping")
    return resolve_scalar(text, lineno)


def _strip_comment(line: str) -> str:
    for i, ch in enumerate(line):
        if ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _lines(text: str):
    """(lineno, indent, content) of every line that holds something."""
    out = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        body = raw.lstrip(" \t")
        content = _strip_comment(body)
        if not content:
            continue
        if "\t" in raw[:len(raw) - len(body)] or "\t" in content:
            _fail(lineno, "tab")
        indent = len(raw) - len(body)
        if indent == 0 and (content.startswith(("---", "...", "%"))):
            _fail(lineno, "document marker or directive (one document only)")
        out.append((lineno, indent, content))
    return out


def _is_entry(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _split_key(content: str, lineno: int):
    """(key, rest) of a mapping line, or None if it is not one."""
    if content.endswith(":"):
        k, rest = content[:-1], ""
    else:
        i = content.find(": ")
        if i < 0:
            return None
        k, rest = content[:i], content[i + 2:].strip()
    k = k.rstrip()
    if not k:
        _fail(lineno, "empty key")
    if k[0] in "'\"":
        _fail(lineno, f"quoted key {k!r}")
    if k[0] == "?" and (len(k) == 1 or k[1] == " "):
        _fail(lineno, "complex key")
    return resolve_scalar(k, lineno), rest


class _Parser:
    def __init__(self, text: str):
        self.lines = _lines(text)
        self.i = 0

    def _peek(self):
        return self.lines[self.i] if self.i < len(self.lines) else None

    def document(self):
        if not self.lines:
            return None
        lineno, indent, content = self.lines[0]
        if not _is_entry(content) and _split_key(content, lineno) is None:
            if len(self.lines) > 1:
                _fail(self.lines[1][0], "multi-line plain scalar")
            self.i = 1
            return _inline(content, lineno)
        value = self._block(indent)
        if self.i < len(self.lines):
            _fail(self.lines[self.i][0], "bad indentation")
        return value

    def _block(self, indent: int):
        _, _, content = self._peek()
        return (self._sequence(indent) if _is_entry(content)
                else self._mapping(indent))

    def _nested_deeper(self, indent: int) -> bool:
        nxt = self._peek()
        return nxt is not None and nxt[1] > indent

    def _mapping(self, indent: int) -> dict:
        out = {}
        while (line := self._peek()) is not None and line[1] == indent:
            lineno, _, content = line
            if _is_entry(content):
                _fail(lineno, "sequence entry inside a mapping")
            kv = _split_key(content, lineno)
            if kv is None:
                _fail(lineno, f"expected 'key: value', got {content!r}")
            key, rest = kv
            self.i += 1
            nxt = self._peek()
            if rest:
                if self._nested_deeper(indent):
                    _fail(nxt[0], "unexpected indentation (multi-line "
                          "scalar or a value and a block)")
                value = _inline(rest, lineno)
            elif nxt is not None and nxt[1] > indent:
                value = self._block(nxt[1])
            elif nxt is not None and nxt[1] == indent and _is_entry(nxt[2]):
                value = self._sequence(indent)
            else:
                value = None
            try:
                out[key] = value
            except TypeError:
                _fail(lineno, f"unhashable key {key!r}")
        return out

    def _sequence(self, indent: int) -> list:
        out = []
        while ((line := self._peek()) is not None and line[1] == indent
               and _is_entry(line[2])):
            lineno, _, content = line
            rest = content[1:].strip()
            self.i += 1
            if self._nested_deeper(indent):
                _fail(self._peek()[0], "a block inside a sequence entry")
            if not rest:
                out.append(None)
                continue
            if _is_entry(rest) or _split_key(rest, lineno) is not None:
                _fail(lineno, "a mapping or sequence inside a sequence "
                      "entry")
            out.append(_inline(rest, lineno))
        return out


def load(text: str):
    """``yaml.safe_load(text)`` for a document inside the subset; raises
    :class:`YAMLSubsetError` outside it."""
    return _Parser(text).document()
