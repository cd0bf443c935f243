"""YAML for the worker's config file, on the standard library.

The JAX worker reads ``config.yaml`` with PyYAML's ``yaml.safe_load`` and,
after registration, writes the issued credentials back with
``yaml.safe_dump(config, sort_keys=False)``. The card's machine has no
PyYAML, so the port reads and writes the same files with this module:

- :func:`safe_load` gives ``yaml.safe_load``'s answer (PyYAML 6's
  ``SafeLoader``) on what a config uses: block mappings and sequences
  (a sequence may sit at its key's indent), flow ``[...]`` and ``{...}``,
  plain, single- and double-quoted scalars with their escapes and line
  folding, ``|`` and ``>`` block scalars with chomping and indentation
  indicators, comments, and one document with optional ``---`` / ``...``.
  Plain scalars resolve by PyYAML's YAML 1.1 rules (the regexes below are
  those of PyYAML's ``resolver.py`` and ``constructor.py``): ``yes`` /
  ``no`` / ``on`` / ``off`` as bools, ``~``, ``null`` and the empty
  scalar as None, ``0b`` / ``0x`` / leading-zero octal, ``_`` separators
  and base-60 ints and floats, ``.inf`` / ``.nan``, and timestamps as
  ``datetime.date`` / ``datetime.datetime``. It refuses what a config does
  not need (anchors, aliases, tags, merge keys, complex keys, directives,
  a second document; an explicit ``?`` key is read where it is a scalar,
  as PyYAML writes a long, empty or multi-line key), and what PyYAML refuses (tabs outside quoted
  scalars and comments, bad indentation, unclosed quotes), raising
  :class:`ConfigError` that names the construct and its line.
- :func:`safe_dump` is byte-identical to ``yaml.safe_dump(data,
  sort_keys=False)`` for None, bool, int, float, str, lists and dicts of
  them (PyYAML's block style with indentless sequences under keys, its
  choice of plain, single- or double-quoted scalars, its float repr,
  non-ASCII written as escapes, and its folding of long scalars at 80
  columns). A list or dict that appears twice in ``data`` is refused:
  PyYAML would write an anchor.
"""

from __future__ import annotations

import datetime
import math
import re
from typing import Any, Dict, List, Optional, Tuple


class ConfigError(ValueError):
    """A config value that cannot be coerced to its field's type, or a
    config file that cannot be read."""


# ----------------------------------------------------------- the resolver
# PyYAML's implicit resolvers (``yaml/resolver.py``), in its order, by the
# first character of a plain scalar.

_RESOLVERS = (
    ("bool", re.compile(r'''^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$''', re.X), "yYnNtTfFoO"),
    ("float", re.compile(r'''^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$''', re.X), "-+0123456789."),
    ("int", re.compile(r'''^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$''', re.X), "-+0123456789"),
    ("merge", re.compile(r'^(?:<<)$'), "<"),
    ("null", re.compile(r'''^(?: ~
                    |null|Null|NULL
                    | )$''', re.X), ("~", "n", "N", "")),
    ("timestamp", re.compile(r'''^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$''', re.X),
     "0123456789"),
    ("value", re.compile(r'^(?:=)$'), "="),
)
_BY_FIRST: Dict[str, List[Tuple[str, Any]]] = {}
for _kind, _regex, _firsts in _RESOLVERS:
    for _ch in _firsts:
        _BY_FIRST.setdefault(_ch, []).append((_kind, _regex))

# PyYAML's ``SafeConstructor.timestamp_regexp`` (``yaml/constructor.py``)
_TIMESTAMP = re.compile(
    r'''^(?P<year>[0-9][0-9][0-9][0-9])
        -(?P<month>[0-9][0-9]?)
        -(?P<day>[0-9][0-9]?)
        (?:(?:[Tt]|[ \t]+)
        (?P<hour>[0-9][0-9]?)
        :(?P<minute>[0-9][0-9])
        :(?P<second>[0-9][0-9])
        (?:\.(?P<fraction>[0-9]*))?
        (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
        (?::(?P<tz_minute>[0-9][0-9]))?))?)?$''', re.X)

_BOOLS = {"yes": True, "no": False, "true": True, "false": False, "on": True, "off": False}

# PyYAML's ``Reader.NON_PRINTABLE``
_NON_PRINTABLE = re.compile(
    "[^\x09\x0A\x0D\x20-\x7E\x85\xA0-\ud7ff\ue000-\ufffd\U00010000-\U0010ffff]")


def _kind(value: str) -> str:
    """The tag a plain scalar ``value`` resolves to ("str" where none
    matches)."""
    for kind, regex in _BY_FIRST.get(value[:1], ()):
        if regex.match(value):
            return kind
    return "str"


def _sexagesimal(value: str, number: type) -> Any:
    total = number(0)
    for part in value.split(":"):
        total = total * 60 + number(part)
    return total


def _construct(kind: str, value: str) -> Any:
    if kind == "str":
        return value
    if kind == "null":
        return None
    if kind == "bool":
        return _BOOLS[value.lower()]
    if kind in ("int", "float"):
        text = value.replace("_", "")
        if kind == "float":
            text = text.lower()
        sign = -1 if text[0] == "-" else 1
        if text[0] in "+-":
            text = text[1:]
        if kind == "float":
            if text == ".inf":
                return sign * math.inf
            if text == ".nan":
                return math.nan
            return sign * (_sexagesimal(text, float) if ":" in text else float(text))
        if text == "0":
            return 0
        if text.startswith("0b"):
            return sign * int(text[2:], 2)
        if text.startswith("0x"):
            return sign * int(text[2:], 16)
        if text[0] == "0":
            return sign * int(text, 8)
        return sign * (_sexagesimal(text, int) if ":" in text else int(text))
    if kind == "timestamp":
        m = _TIMESTAMP.match(value).groupdict()
        year, month, day = int(m["year"]), int(m["month"]), int(m["day"])
        if not m["hour"]:
            return datetime.date(year, month, day)
        fraction = int((m["fraction"] or "")[:6].ljust(6, "0")) if m["fraction"] else 0
        tz = None
        if m["tz_sign"]:
            delta = datetime.timedelta(hours=int(m["tz_hour"]),
                                       minutes=int(m["tz_minute"] or 0))
            tz = datetime.timezone(-delta if m["tz_sign"] == "-" else delta)
        elif m["tz"]:
            tz = datetime.timezone.utc
        return datetime.datetime(year, month, day, int(m["hour"]), int(m["minute"]),
                                 int(m["second"]), fraction, tzinfo=tz)
    raise AssertionError(kind)


# ------------------------------------------------------------- the loader

_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\x09", "\t": "\x09", "n": "\x0A",
            "v": "\x0B", "f": "\x0C", "r": "\x0D", "e": "\x1B", " ": "\x20", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xA0", "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
_WS = " \t\n\0"     # what ends a token
_END = "\n\0"


class _Loader:
    """A recursive-descent reader of one YAML document. The cursor ``i``
    moves through ``t`` (the text with line breaks normalized and NULs
    after its end); every node leaves it at the start of a line, or at the
    first character of the next content line it looked at."""

    def __init__(self, text: str) -> None:
        text = text.replace("\r\n", "\n").replace("\r", "\n")
        if text.startswith("\ufeff"):
            text = text[1:]
        bad = _NON_PRINTABLE.search(text)
        self.t, self.i = text + "\0" * 4, 0
        if bad:
            self.fail(f"the special character {bad.group()!r}", bad.start())

    # ------------------------------------------------------------ helpers

    def fail(self, what: str, at: Optional[int] = None) -> None:
        at = self.i if at is None else at
        line = self.t.count("\n", 0, at) + 1
        raise ConfigError(f"YAML line {line}: {what} is not supported here")

    def peek(self, k: int = 0) -> str:
        return self.t[self.i + k]

    def col(self, at: Optional[int] = None) -> int:
        at = self.i if at is None else at
        return at - (self.t.rfind("\n", 0, at) + 1)

    def skip_spaces(self) -> None:
        while self.t[self.i] == " ":
            self.i += 1
        if self.t[self.i] == "\t":
            self.fail("a tab outside a quoted scalar")

    def end_line(self) -> None:
        """Spaces and a comment to the end of the line, and its break."""
        self.skip_spaces()
        if self.peek() == "#":
            while self.peek() not in _END:
                self.i += 1
        if self.peek() not in _END:
            self.fail(f"content after a complete node ({self.peek()!r})")
        if self.peek() == "\n":
            self.i += 1

    def next_content(self) -> Optional[int]:
        """Past spaces, comments and blank lines: the column of the next
        content, or None at the end."""
        while True:
            self.skip_spaces()
            ch = self.peek()
            if ch == "#":
                while self.peek() not in _END:
                    self.i += 1
                ch = self.peek()
            if ch == "\n":
                self.i += 1
                continue
            return None if ch == "\0" else self.col()

    def marker(self, text: str) -> bool:
        """A document marker at the cursor, at the start of its line."""
        return (self.col() == 0 and self.t.startswith(text, self.i)
                and self.t[self.i + 3] in _WS)

    def is_entry(self) -> bool:
        return self.peek() == "-" and self.peek(1) in _WS

    def no_properties(self, flow: bool = False, key: bool = False) -> None:
        ch = self.peek()
        names = {"&": "an anchor ('&')", "*": "an alias ('*')", "!": "a tag ('!')",
                 "%": "a directive ('%')", "@": "the reserved indicator '@'",
                 "`": "the reserved indicator '`'"}
        if ch in names:
            self.fail(names[ch])
        if ch == "?" and (flow or self.peek(1) in _WS) and not key:
            self.fail("a complex key ('?')")
        if not flow and ch in ",]}":
            self.fail(f"the flow indicator {ch!r} outside a flow collection")

    # ----------------------------------------------------------- document

    def document(self) -> Any:
        c = self.next_content()
        if c is None:
            return None
        node: Any = None
        if self.marker("---"):
            self.i += 3
            self.skip_spaces()
            if self.peek() in "#\n\0":
                self.end_line()
                node = self.node(-1, inline=False)
            elif self.peek() in "|>":
                node = self.block_scalar(-1)
            else:
                node = self.node(-1, inline=True, on_marker=True)
        elif not self.marker("..."):
            node = self.node(-1, inline=False)
        c = self.next_content()
        if c is not None and self.marker("..."):
            self.i += 3
            self.end_line()
            c = self.next_content()
        if c is not None:
            self.fail("a second document" if self.marker("---")
                      else f"content after the document ({self.peek()!r})")
        return node

    # -------------------------------------------------------- block nodes

    def node(self, indent: int, inline: bool, compact: bool = False, in_map: bool = False,
             on_marker: bool = False) -> Any:
        """The node after an indicator (``inline``: it may start on this
        line) or on the next content line deeper than ``indent``, the
        column of the enclosing block collection. ``compact``: a block
        collection may start on this line (after ``- `` or an explicit
        key's ``: ``, not after an implicit key's)."""
        if inline:
            self.skip_spaces()
            if self.peek() in "#\n\0":
                self.end_line()
                inline = False
        if not inline:
            c = self.next_content()
            if c is None or self.marker("---") or self.marker("..."):
                return None
            if c <= indent:
                if in_map and c == indent and self.is_entry():
                    return self.block_seq(c)    # a sequence at its key's indent
                return None
        c, ch = self.col(), self.peek()
        if ch == "?" and self.peek(1) in _WS:
            if inline and not compact:
                self.fail("a mapping on the line of its key")
            return self.block_map(c)
        self.no_properties()
        if self.is_entry():
            if inline and not compact:
                self.fail("a block sequence on the line of its key")
            return self.block_seq(c)
        if ch in "|>":
            return self.block_scalar(indent)
        if ch in "[{":
            start = self.i
            value = self.flow_collection()
            self.skip_spaces()
            if self.peek() == ":" and self.peek(1) in _WS:
                self.fail("a complex key (a flow collection as a key)", start)
            self.end_line()
            return value
        if self.key_ahead():
            if inline and not compact:
                self.fail("a mapping on the line of its key" if not on_marker
                          else "a mapping on the line of '---'")
            return self.block_map(c)
        if ch in "'\"":
            value = self.quoted()
            self.end_line()
            return value
        return self.plain(indent)

    def key_ahead(self) -> bool:
        """Whether the line from the cursor is an implicit key and ': '."""
        j, t = self.i, self.t
        if t[j] in "'\"":
            q = t[j]
            j += 1
            while True:
                if t[j] in _END:
                    return False          # a quoted scalar over lines is no key
                if q == "'" and t[j] == "'" and t[j + 1] == "'":
                    j += 2
                elif q == '"' and t[j] == "\\":
                    j += 2
                elif t[j] == q:
                    j += 1
                    break
                else:
                    j += 1
            while t[j] == " ":
                j += 1
            return t[j] == ":" and t[j + 1] in _WS
        while t[j] not in _END:
            if t[j] == ":" and t[j + 1] in _WS:
                return True
            if t[j] in " \t" and t[j + 1] == "#":
                return False
            j += 1
        return False

    def block_map(self, c: int) -> Dict[Any, Any]:
        out: Dict[Any, Any] = {}
        while True:
            self.no_properties(key=True)
            if self.peek() == "?" and self.peek(1) in _WS:
                # an explicit key, as PyYAML writes one that is long, empty
                # or over lines; only a scalar key
                self.i += 1
                start = self.i
                key = self.node(c, inline=True)
                if isinstance(key, (list, dict)):
                    self.fail("a complex key (a collection as a key)", start)
                c2 = self.next_content()
                if c2 == c and self.peek() == ":" and self.peek(1) in _WS:
                    self.i += 1
                    out[key] = self.node(c, inline=True, compact=True, in_map=True)
                else:
                    out[key] = None
                c2 = self.next_content()
                if c2 is None or c2 < c or self.marker("---") or self.marker("..."):
                    return out
                if c2 > c:
                    self.fail("a mapping entry at a deeper indent than its mapping")
                continue
            if self.peek() in "[{":
                self.fail("a complex key (a flow collection as a key)")
            if self.is_entry():
                self.fail("a sequence entry among the keys of a mapping")
            if self.peek() in "'\"":
                key: Any = self.quoted()
            else:
                start = self.i
                while not (self.peek() == ":" and self.peek(1) in _WS) \
                        and self.peek() not in _END:
                    self.i += 1
                raw = self.t[start:self.i].rstrip(" ")
                if "\t" in raw:
                    self.fail("a tab outside a quoted scalar", start)
                kind = _kind(raw)
                if kind in ("merge", "value"):
                    self.fail(f"the key {raw!r} (a YAML 1.1 {kind} key)", start)
                key = _construct(kind, raw)
            self.skip_spaces()
            if not (self.peek() == ":" and self.peek(1) in _WS):
                self.fail("a key without ':'")
            self.i += 1
            out[key] = self.node(c, inline=True, in_map=True)
            c2 = self.next_content()
            if c2 is None or c2 < c or self.marker("---") or self.marker("..."):
                return out
            if c2 > c:
                self.fail("a mapping entry at a deeper indent than its mapping")

    def block_seq(self, c: int) -> List[Any]:
        out: List[Any] = []
        while True:
            self.i += 1                          # the '-'
            out.append(self.node(c, inline=True, compact=True))
            c2 = self.next_content()
            if c2 is None or c2 < c or self.marker("---") or self.marker("..."):
                return out
            if c2 > c:
                self.fail("a sequence entry at a deeper indent than its sequence")
            if not self.is_entry():
                return out                       # a key of the mapping around it

    def plain(self, indent: int) -> Any:
        """A plain scalar in block context, over as many lines as are
        deeper than ``indent``, resolved by the YAML 1.1 rules."""
        t, start = self.t, self.i
        chunks: List[str] = []
        spaces: List[str] = []
        while self.peek() != "#":
            j = self.i
            while t[j] not in _WS and not (t[j] == ":" and t[j + 1] in _WS):
                j += 1
            if j == self.i:
                break
            chunks += spaces
            chunks.append(t[self.i:j])
            self.i = j
            spaces = self.plain_spaces()
            if not spaces or self.peek() == "#" or self.col() < indent + 1:
                break
        if self.peek() == ":" and self.peek(1) in _WS and self.col() > indent:
            self.fail("a mapping value after a multi-line plain scalar")
        if self.peek() == "\t":
            self.fail("a tab outside a quoted scalar")
        value = "".join(chunks)
        kind = _kind(value)
        if kind in ("merge", "value"):
            self.fail(f"the plain scalar {value!r} (a YAML 1.1 {kind} tag)", start)
        return _construct(kind, value)

    def plain_spaces(self) -> List[str]:
        """The folding between two chunks of a plain scalar."""
        j = self.i
        while self.t[j] == " ":
            j += 1
        spaces, self.i = self.t[self.i:j], j
        if self.peek() != "\n":
            return [spaces] if spaces else []
        self.i += 1
        if self.marker("---") or self.marker("..."):
            return []
        breaks: List[str] = []
        while self.peek() in " \n":
            if self.peek() == "\n":
                breaks.append("\n")
                self.i += 1
                if self.marker("---") or self.marker("..."):
                    return []
            else:
                self.i += 1
        return breaks or [" "]

    def quoted(self) -> str:
        """A single- or double-quoted scalar, its line breaks folded."""
        q = self.peek()
        double = q == '"'
        start = self.i
        self.i += 1
        chunks = self.quoted_chunk(double)
        while self.peek() != q:
            if self.peek() == "\0":
                self.fail("an unclosed quoted scalar", start)
            j = self.i
            while self.t[j] in " \t":
                j += 1
            spaces, self.i = self.t[self.i:j], j
            if self.peek() == "\n":
                self.i += 1
                breaks = self.quoted_breaks()
                chunks += breaks or [" "]
            elif self.peek() != "\0":
                chunks.append(spaces)
            chunks += self.quoted_chunk(double)
        self.i += 1
        return "".join(chunks)

    def quoted_chunk(self, double: bool) -> List[str]:
        chunks: List[str] = []
        t = self.t
        while True:
            j = self.i
            while t[j] not in "'\"\\\0 \t\n":
                j += 1
            if j > self.i:
                chunks.append(t[self.i:j])
                self.i = j
            ch = self.peek()
            if not double and ch == "'" and self.peek(1) == "'":
                chunks.append("'")
                self.i += 2
            elif (double and ch == "'") or (not double and ch in '"\\'):
                chunks.append(ch)
                self.i += 1
            elif double and ch == "\\":
                self.i += 1
                ch = self.peek()
                if ch in _ESCAPES:
                    chunks.append(_ESCAPES[ch])
                    self.i += 1
                elif ch in _ESCAPE_CODES:
                    n = _ESCAPE_CODES[ch]
                    digits = t[self.i + 1:self.i + 1 + n]
                    if len(digits) < n or any(d not in "0123456789abcdefABCDEF" for d in digits):
                        self.fail(f"the escape '\\{ch}{digits}'")
                    chunks.append(chr(int(digits, 16)))
                    self.i += 1 + n
                elif ch == "\n":
                    self.i += 1
                    chunks += self.quoted_breaks()
                else:
                    self.fail(f"the escape '\\{ch}'")
            else:
                return chunks

    def quoted_breaks(self) -> List[str]:
        breaks: List[str] = []
        while True:
            if self.marker("---") or self.marker("..."):
                self.fail("a document marker inside a quoted scalar")
            while self.peek() in " \t":
                self.i += 1
            if self.peek() != "\n":
                return breaks
            breaks.append("\n")
            self.i += 1

    def block_scalar(self, indent: int) -> str:
        """A ``|`` or ``>`` scalar: its indicators, then its lines."""
        folded = self.peek() == ">"
        self.i += 1
        chomp: Optional[bool] = None
        step: Optional[int] = None
        for _ in range(2):
            ch = self.peek()
            if ch in "+-" and chomp is None:
                chomp = ch == "+"
                self.i += 1
            elif ch in "0123456789" and step is None:
                if ch == "0":
                    self.fail("a block scalar indentation indicator of 0")
                step = int(ch)
                self.i += 1
        if self.peek() not in " \n\0#":
            self.fail(f"the block scalar indicator {self.peek()!r}")
        self.end_line()
        low = max(indent + 1, 1)
        t = self.t
        if step is None:
            breaks: List[str] = []
            deepest = 0
            while self.peek() in " \n":
                if self.peek() == "\n":
                    breaks.append("\n")
                    self.i += 1
                else:
                    self.i += 1
                    deepest = max(deepest, self.col())
            width = max(low, deepest)
        else:
            width = low + step - 1
            breaks = self.block_breaks(width)
        chunks: List[str] = []
        line_break = ""
        while self.col() == width and self.peek() != "\0":
            chunks += breaks
            leading = self.peek() not in " \t"
            j = self.i
            while t[j] not in _END:
                j += 1
            chunks.append(t[self.i:j])
            self.i = j
            line_break = ""
            if self.peek() == "\n":
                line_break = "\n"
                self.i += 1
            breaks = self.block_breaks(width)
            if self.col() == width and self.peek() != "\0":
                if folded and line_break == "\n" and leading and self.peek() not in " \t":
                    if not breaks:
                        chunks.append(" ")
                else:
                    chunks.append(line_break)
            else:
                break
        if chomp is not False:
            chunks.append(line_break)
        if chomp is True:
            chunks += breaks
        self.i -= self.col()          # back to the start of the line it stopped in
        return "".join(chunks)

    def block_breaks(self, width: int) -> List[str]:
        breaks: List[str] = []
        while self.col() < width and self.peek() == " ":
            self.i += 1
        while self.peek() == "\n":
            breaks.append("\n")
            self.i += 1
            while self.col() < width and self.peek() == " ":
                self.i += 1
        return breaks

    # --------------------------------------------------------- flow nodes

    def flow_skip(self) -> None:
        while True:
            self.skip_spaces()
            if self.peek() == "#":
                while self.peek() not in _END:
                    self.i += 1
            if self.peek() != "\n":
                return
            self.i += 1

    def flow_node(self) -> Any:
        self.flow_skip()
        self.no_properties(flow=True)
        ch = self.peek()
        if ch in "[{":
            return self.flow_collection()
        if ch in "'\"":
            return self.quoted()
        if ch in ",]}:\0" and not (ch == ":" and self.peek(1) not in _WS + ",[]{}"):
            self.fail(f"an empty flow entry before {ch!r}")
        return self.flow_plain()

    def flow_collection(self) -> Any:
        closing = "]" if self.peek() == "[" else "}"
        self.i += 1
        items: List[Any] = []
        out: Dict[Any, Any] = {}
        while True:
            self.flow_skip()
            if self.peek() == closing:
                self.i += 1
                return items if closing == "]" else out
            if self.peek() in "[{" and closing == "}":
                self.fail("a complex key (a flow collection as a key)")
            key_start = self.i
            key = self.flow_node()
            self.flow_skip()
            has_value = self.peek() == ":"
            if has_value:
                if isinstance(key, (list, dict)):
                    self.fail("a complex key (a flow collection as a key)", key_start)
                self.i += 1
                self.flow_skip()
                value = None if self.peek() in ",]}" else self.flow_node()
                self.flow_skip()
            if closing == "]":
                items.append({key: value} if has_value else key)
            else:
                out[key] = value if has_value else None
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != closing:
                self.fail(f"{self.peek()!r} where ',' or {closing!r} was expected")

    def flow_plain(self) -> Any:
        t, start = self.t, self.i
        chunks: List[str] = []
        spaces: List[str] = []
        while self.peek() != "#":
            j = self.i
            while t[j] not in _WS and t[j] not in ",?[]{}" \
                    and not (t[j] == ":" and t[j + 1] in _WS + ",[]{}"):
                j += 1
            if j == self.i:
                break
            chunks += spaces
            chunks.append(t[self.i:j])
            self.i = j
            spaces = self.plain_spaces()
            if not spaces or self.peek() == "#":
                break
        if self.peek() == "?":
            self.fail("a complex key ('?')")
        value = "".join(chunks)
        kind = _kind(value)
        if kind in ("merge", "value"):
            self.fail(f"the plain scalar {value!r} (a YAML 1.1 {kind} tag)", start)
        return _construct(kind, value)


def safe_load(text: str) -> Any:
    """``yaml.safe_load(text)`` for one config document (see the module
    docstring); :class:`ConfigError` names what it does not take."""
    return _Loader(text).document()


# ------------------------------------------------------------ the emitter

_BREAK_CHARS = "\n\x85\u2028\u2029"
_SPACE_OR_BREAK = "\0 \t\r\n\x85\u2028\u2029"
_DQ_ESCAPES = {"\0": "0", "\x07": "a", "\x08": "b", "\x09": "t", "\x0A": "n", "\x0B": "v",
               "\x0C": "f", "\x0D": "r", "\x1B": "e", '"': '"', "\\": "\\", "\x85": "N",
               "\xA0": "_", "\u2028": "L", "\u2029": "P"}
_WIDTH, _STEP = 80, 2


class _Scalar:
    """What a scalar's text allows (PyYAML's ``Emitter.analyze_scalar``,
    for ``allow_unicode=False``)."""

    def __init__(self, text: str) -> None:
        self.text = text
        self.empty = not text
        self.multiline = False
        self.flow_plain = self.block_plain = True
        self.single = True
        if not text:
            self.flow_plain = False
            return
        block_ind = flow_ind = text.startswith(("---", "..."))
        special = leading_space = trailing_space = leading_break = trailing_break = False
        break_space = space_break = False
        prev_space = prev_break = False
        before_ws = True
        n = len(text)
        for i, ch in enumerate(text):
            after_ws = i + 1 >= n or text[i + 1] in _SPACE_OR_BREAK
            if i == 0:
                if ch in "#,[]{}&*!|>'\"%@`":
                    flow_ind = block_ind = True
                if ch in "?:":
                    flow_ind = True
                    block_ind = block_ind or after_ws
                if ch == "-" and after_ws:
                    flow_ind = block_ind = True
            else:
                if ch in ",?[]{}":
                    flow_ind = True
                if ch == ":":
                    flow_ind = True
                    block_ind = block_ind or after_ws
                if ch == "#" and before_ws:
                    flow_ind = block_ind = True
            if ch in _BREAK_CHARS:
                self.multiline = True
            if not (ch == "\n" or "\x20" <= ch <= "\x7E"):
                special = True
            if ch == " ":
                leading_space = leading_space or i == 0
                trailing_space = trailing_space or i == n - 1
                break_space = break_space or prev_break
                prev_space, prev_break = True, False
            elif ch in _BREAK_CHARS:
                leading_break = leading_break or i == 0
                trailing_break = trailing_break or i == n - 1
                space_break = space_break or prev_space
                prev_space, prev_break = False, True
            else:
                prev_space = prev_break = False
            before_ws = ch in _SPACE_OR_BREAK
        if leading_space or leading_break or trailing_space or trailing_break:
            self.flow_plain = self.block_plain = False
        if break_space:
            self.flow_plain = self.block_plain = self.single = False
        if space_break or special:
            self.flow_plain = self.block_plain = self.single = False
        if self.multiline:
            self.flow_plain = self.block_plain = False
        if flow_ind:
            self.flow_plain = False
        if block_ind:
            self.block_plain = False


def _represent(value: Any) -> Tuple[str, str]:
    """A scalar's text and tag kind, as PyYAML's ``SafeRepresenter``
    writes them."""
    if value is None:
        return "null", "null"
    if type(value) is bool:
        return ("true" if value else "false"), "bool"
    if type(value) is int:
        return str(value), "int"
    if type(value) is float:
        if value != value:
            return ".nan", "float"
        if value in (math.inf, -math.inf):
            return (".inf" if value > 0 else "-.inf"), "float"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text, "float"
    if type(value) is str:
        return value, "str"
    raise TypeError(f"cannot write {type(value).__name__} to a YAML config")


class _Emitter:
    """PyYAML's emitter for the events of ``safe_dump(data,
    sort_keys=False)``: the same column, whitespace and indentation state
    and the same writing rules, as recursion over the data."""

    def __init__(self) -> None:
        self.out: List[str] = []
        self.column = 0
        self.whitespace = self.indention = True
        self.open_ended = False
        self.indent: Optional[int] = None
        self.indents: List[Optional[int]] = []
        self.flow_level = 0
        self.seen: set = set()

    def write(self, data: str) -> None:
        self.column += len(data)
        self.out.append(data)

    def indicator(self, text: str, need_space: bool, whitespace: bool = False,
                  indention: bool = False) -> None:
        self.write(text if self.whitespace or not need_space else " " + text)
        self.whitespace = whitespace
        self.indention = self.indention and indention
        self.open_ended = False

    def line_break(self) -> None:
        self.whitespace = self.indention = True
        self.column = 0
        self.out.append("\n")

    def write_indent(self) -> None:
        indent = self.indent or 0
        if not self.indention or self.column > indent or \
                (self.column == indent and not self.whitespace):
            self.line_break()
        if self.column < indent:
            self.whitespace = True
            self.write(" " * (indent - self.column))

    def push_indent(self, flow: bool = False, indentless: bool = False) -> None:
        self.indents.append(self.indent)
        if self.indent is None:
            self.indent = _STEP if flow else 0
        elif not indentless:
            self.indent += _STEP

    def pop_indent(self) -> None:
        self.indent = self.indents.pop()

    # -------------------------------------------------------------- nodes

    def node(self, value: Any, root: bool = False, mapping: bool = False,
             simple_key: bool = False) -> None:
        if isinstance(value, (list, dict)):
            if id(value) in self.seen:
                raise ValueError("a list or dict that appears twice: PyYAML would "
                                 "write an anchor and an alias")
            self.seen.add(id(value))
            if self.flow_level or not value:
                self.push_indent(flow=True)
                self.indicator("[" if isinstance(value, list) else "{", True, whitespace=True)
                self.pop_indent()
                self.indicator("]" if isinstance(value, list) else "}", False)
            elif isinstance(value, list):
                self.push_indent(indentless=mapping and not self.indention)
                for item in value:
                    self.write_indent()
                    self.indicator("-", True, indention=True)
                    self.node(item)
                self.pop_indent()
            else:
                self.push_indent()
                for key, item in value.items():
                    self.write_indent()
                    if self.simple_key(key):
                        self.node(key, mapping=True, simple_key=True)
                        self.indicator(":", False)
                    else:
                        self.indicator("?", True, indention=True)
                        self.node(key, mapping=True)
                        self.write_indent()
                        self.indicator(":", True, indention=True)
                    self.node(item, mapping=True)
                self.pop_indent()
        else:
            self.scalar(value, root, simple_key)

    def simple_key(self, key: Any) -> bool:
        """PyYAML's ``check_simple_key``: under 128 characters with the
        tag it counts (``!!str`` and the like, written or not), on one
        line, not empty."""
        if isinstance(key, (list, dict)):
            return not key
        text, kind = _represent(key)
        a = _Scalar(text)
        return len(text) + len("!!" + kind) < 128 and not a.empty and not a.multiline

    def scalar(self, value: Any, root: bool, simple_key: bool) -> None:
        text, kind = _represent(value)
        plain_ok = _kind(text) == kind      # implicit as a plain scalar
        a = _Scalar(text)
        self.push_indent(flow=True)
        if plain_ok and not (simple_key and (a.empty or a.multiline)) and (
                a.flow_plain if self.flow_level else a.block_plain):
            style = ""
        elif a.single and not (simple_key and a.multiline):
            style = "'"
        else:
            style = '"'
        if style == "" and not plain_ok or style != "" and kind != "str":
            raise TypeError(f"{value!r} would need a YAML tag")
        split = not simple_key
        if style == '"':
            self.double_quoted(text, split)
        elif style == "'":
            self.single_quoted(text, split)
        else:
            self.plain(text, split, root)
        self.pop_indent()

    # ------------------------------------------------------------ writers

    def breaks(self, text: str) -> None:
        """A run of line breaks inside a plain or single-quoted scalar (only
        ``\\n`` reaches here: the other break characters are special and
        force double quotes)."""
        if text[0] == "\n":
            self.line_break()
        for _ in text:
            self.line_break()
        self.write_indent()

    def plain(self, text: str, split: bool, root: bool) -> None:
        if root:
            self.open_ended = True
        if not text:
            return
        if not self.whitespace:
            self.write(" ")
        self.whitespace = self.indention = False
        spaces = breaks = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if start + 1 == end and self.column > _WIDTH and split:
                        self.write_indent()
                        self.whitespace = self.indention = False
                    else:
                        self.write(text[start:end])
                    start = end
            elif breaks:
                if ch is None or ch not in _BREAK_CHARS:
                    self.breaks(text[start:end])
                    self.whitespace = self.indention = False
                    start = end
            elif ch is None or ch in " " + _BREAK_CHARS:
                self.write(text[start:end])
                start = end
            if ch is not None:
                spaces, breaks = ch == " ", ch in _BREAK_CHARS
            end += 1

    def single_quoted(self, text: str, split: bool) -> None:
        self.indicator("'", True)
        spaces = breaks = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch is None or ch != " ":
                    if start + 1 == end and self.column > _WIDTH and split \
                            and start != 0 and end != len(text):
                        self.write_indent()
                    else:
                        self.write(text[start:end])
                    start = end
            elif breaks:
                if ch is None or ch not in _BREAK_CHARS:
                    self.breaks(text[start:end])
                    start = end
            elif ch is None or ch in " " + _BREAK_CHARS + "'":
                if start < end:
                    self.write(text[start:end])
                    start = end
            if ch == "'":
                self.write("''")
                start = end + 1
            if ch is not None:
                spaces, breaks = ch == " ", ch in _BREAK_CHARS
            end += 1
        self.indicator("'", False)

    def double_quoted(self, text: str, split: bool) -> None:
        self.indicator('"', True)
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if ch is None or ch in '"\\\x85\u2028\u2029\ufeff' or not "\x20" <= ch <= "\x7E":
                if start < end:
                    self.write(text[start:end])
                    start = end
                if ch is not None:
                    if ch in _DQ_ESCAPES:
                        self.write("\\" + _DQ_ESCAPES[ch])
                    elif ch <= "\xFF":
                        self.write("\\x%02X" % ord(ch))
                    elif ch <= "\uffff":
                        self.write("\\u%04X" % ord(ch))
                    else:
                        self.write("\\U%08X" % ord(ch))
                    start = end + 1
            if 0 < end < len(text) - 1 and (ch == " " or start >= end) \
                    and self.column + (end - start) > _WIDTH and split:
                data = text[start:end] + "\\"
                if start < end:
                    start = end
                self.write(data)
                self.write_indent()
                self.whitespace = self.indention = False
                if text[start] == " ":
                    self.write("\\")
            end += 1
        self.indicator('"', False)


def safe_dump(data: Any) -> str:
    """``yaml.safe_dump(data, sort_keys=False)``, byte for byte, for None,
    bool, int, float, str, lists and dicts of them."""
    e = _Emitter()
    e.node(data, root=True)
    e.write_indent()
    if e.open_ended:
        e.indicator("...", True)
        e.write_indent()
    return "".join(e.out)
