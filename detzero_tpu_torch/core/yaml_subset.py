"""A loader for the subset of YAML that the repo's configs are written in.

The card's machine has no PyYAML, so the port reads its configs with this:
block mappings and block lists (a list item may open a mapping on its own
line), flow lists and flow maps (nested, and spanning lines), quoted and
plain scalars, and comments.  Plain scalars resolve as PyYAML's
`safe_load` resolves them (YAML 1.1): null, bool, int (decimal, octal,
hex, binary, base 60) and float, else a string; quoted scalars are
strings.  Anchors, aliases, tags, block scalars and several documents
raise ValueError rather than load as something else.
"""

from __future__ import annotations

import re

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {**dict.fromkeys("yes Yes YES true True TRUE on On ON".split(), True),
         **dict.fromkeys("no No NO false False FALSE off Off OFF".split(),
                         False)}
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
# indicators that open a construct outside the subset
_UNSUPPORTED = ("&", "*", "!", "|", ">", "%", "@", "`")


def _base60(text, cast):
    sign = -1 if text.startswith("-") else 1
    value = cast(0)
    for part in text.lstrip("+-").split(":"):
        value = value * 60 + cast(part)
    return sign * value


def resolve(text: str):
    """A plain scalar's value, as PyYAML's implicit resolvers give it."""
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        t = text.replace("_", "")
        sign, body = (-1, t[1:]) if t[0] == "-" else (1, t.lstrip("+"))
        if ":" in body:
            return sign * _base60(body, int)
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        if body != "0" and body.startswith("0"):
            return sign * int(body, 8)
        return sign * int(body)
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith(".inf"):
            return float("-inf") if t[0] == "-" else float("inf")
        if t.endswith(".nan"):
            return float("nan")
        if ":" in t:
            return _base60(t, float)
        return float(t)
    if text.startswith(_UNSUPPORTED) or text == "---":
        raise ValueError(f"YAML construct outside the subset: {text!r}")
    return text


def _quoted(text, i):
    """(string, index after the closing quote) of the quoted scalar at i."""
    q = text[i]
    out, i = [], i + 1
    escapes = {"n": "\n", "t": "\t", "\\": "\\", '"': '"', "/": "/",
               "0": "\0", "r": "\r"}
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            out.append(escapes[text[i + 1]])
            i += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), i + 1
        out.append(c)
        i += 1
    raise ValueError(f"unterminated quoted scalar in {text!r}")


def _strip_comment(line):
    """The line without its comment: '#' at the start or after a blank,
    outside quotes."""
    i, q = 0, None
    while i < len(line):
        c = line[i]
        if q:
            if c == q:
                q = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            q = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


class _Flow:
    """Recursive descent over one flow collection (or scalar) of text."""

    def __init__(self, text):
        self.t, self.i = text, 0

    def ws(self):
        while self.i < len(self.t) and self.t[self.i] in " \t\n":
            self.i += 1

    def node(self):
        self.ws()
        c = self.t[self.i]
        if c == "[":
            return self.seq()
        if c == "{":
            return self.map()
        if c in "'\"":
            s, self.i = _quoted(self.t, self.i)
            return s
        start = self.i
        while self.i < len(self.t):
            c = self.t[self.i]
            if c in ",]}":
                break
            if c == ":" and self.t[self.i + 1:self.i + 2] in (" ", "\n", ""):
                break
            self.i += 1
        return resolve(self.t[start:self.i].strip())

    def expect(self, c):
        self.ws()
        if self.t[self.i] != c:
            raise ValueError(f"expected {c!r} at {self.i} in {self.t!r}")
        self.i += 1

    def seq(self):
        self.expect("[")
        out = []
        while True:
            self.ws()
            if self.t[self.i] == "]":
                self.i += 1
                return out
            out.append(self.node())
            self.ws()
            if self.t[self.i] == ",":
                self.i += 1

    def map(self):
        self.expect("{")
        out = {}
        while True:
            self.ws()
            if self.t[self.i] == "}":
                self.i += 1
                return out
            key = self.node()
            self.expect(":")
            self.ws()
            out[key] = None if self.t[self.i] in ",}" else self.node()
            self.ws()
            if self.t[self.i] == ",":
                self.i += 1


def _flow_value(text):
    f = _Flow(text)
    value = f.node()
    f.ws()
    if f.i != len(f.t):
        raise ValueError(f"trailing text after a flow value: {text!r}")
    return value


def _split_key(content):
    """(key, rest) of a block mapping entry 'key: rest', or None."""
    if content[0] in "'\"":
        key, i = _quoted(content, 0)
        if content[i:i + 1] == ":" and content[i + 1:i + 2] in (" ", ""):
            return key, content[i + 1:].strip()
        return None
    m = re.search(r":(?: |$)", content)
    if m is None or content.startswith(("[", "{")):
        return None
    return resolve(content[:m.start()].strip()), content[m.end():].strip()


class _Block:
    def __init__(self, text):
        self.lines = []
        for raw in text.splitlines():
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise ValueError("tabs in indentation")
            line = _strip_comment(raw)
            if line.strip():
                self.lines.append([len(line) - len(line.lstrip()),
                                   line.strip()])
        self.k = 0

    def peek(self):
        return self.lines[self.k] if self.k < len(self.lines) else None

    def value(self, rest, indent, key=True):
        """The value after 'key:' or '- ' on one line: a flow collection
        (with the lines that continue it), a scalar, or the block below
        (after a key, a list may sit at the key's own indent)."""
        if not rest:
            nxt = self.peek()
            if nxt is not None and (nxt[0] > indent or key and (
                    nxt[0] == indent and _is_item(nxt[1]))):
                return self.node(nxt[0])
            return None
        if rest[0] in "[{":
            text = rest
            while _depth(text) > 0:
                if self.peek() is None:
                    raise ValueError(f"unclosed flow collection {rest!r}")
                text += "\n" + self.peek()[1]
                self.k += 1
            return _flow_value(text)
        if rest[0] in "'\"":
            return _flow_value(rest)
        return resolve(rest)

    def node(self, indent):
        first = self.peek()
        if _is_item(first[1]):
            return self.seq(indent)
        return self.map(indent)

    def seq(self, indent):
        out = []
        while (line := self.peek()) is not None and line[0] == indent and \
                _is_item(line[1]):
            rest = line[1][1:]
            body = rest.lstrip()
            if body and (_is_item(body) or _split_key(body) is not None):
                # '- key: v' ('- - v') opens a mapping (a list) whose
                # entries sit at the column of its first: parse this line
                # again as that entry
                line[0] = indent + 1 + len(rest) - len(body)
                line[1] = body
                out.append(self.node(line[0]))
            else:
                self.k += 1
                out.append(self.value(body, indent, key=False))
        return out

    def map(self, indent):
        out = {}
        while (line := self.peek()) is not None and line[0] == indent:
            kv = _split_key(line[1])
            if kv is None or _is_item(line[1]):
                raise ValueError(f"expected 'key: value', got {line[1]!r}")
            self.k += 1
            out[kv[0]] = self.value(kv[1], indent)
        if line is not None and line[0] > indent:
            raise ValueError(f"bad indentation at {line[1]!r}")
        return out


def _is_item(content):
    return content == "-" or content.startswith("- ")


def _depth(text):
    """Open flow brackets in text, outside quotes."""
    d, i = 0, 0
    while i < len(text):
        c = text[i]
        if c in "'\"":
            _, i = _quoted(text, i)
            continue
        d += (c in "[{") - (c in "]}")
        i += 1
    return d


def safe_load(text: str):
    """The document in `text` as dicts, lists and scalars (None if empty)."""
    block = _Block(text)
    if block.peek() is None:
        return None
    first = block.peek()
    if first[1] == "---" or first[1].startswith("--- "):
        raise ValueError("document markers are outside the subset")
    if first[1][0] in "[{\"'" and _split_key(first[1]) is None:
        return _flow_value("\n".join(l[1] for l in block.lines))
    out = block.node(first[0])
    if block.peek() is not None:
        raise ValueError(f"unparsed line {block.peek()[1]!r}")
    return out
