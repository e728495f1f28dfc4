"""TraceQL lexer (reference: pkg/traceql/lexer.go)."""

from __future__ import annotations

import re
from dataclasses import dataclass

KEYWORDS = {
    "true", "false", "nil",
    "ok", "error", "unset",
    "client", "server", "internal", "producer", "consumer", "unspecified",
    "count", "avg", "min", "max", "sum", "coalesce", "by", "select",
    "duration", "name", "status", "kind", "childCount", "parent",
    "resource", "span",
}

_DURATION_RE = re.compile(r"\d+(\.\d+)?(ns|us|µs|ms|s|m|h)")
_NUMBER_RE = re.compile(r"\d+(\.\d+)?")
_IDENT_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_\-./]*")
# attribute after '.' — allows most chars the reference allows
_ATTR_RE = re.compile(r"[a-zA-Z0-9_\-./]+")

_TWO_CHAR = ("&&", "||", ">>", ">=", "<=", "!=", "=~", "!~")
_ONE_CHAR = "{}()|=<>!+-*/%^,.~"

DURATION_NS = {
    "ns": 1,
    "us": 1_000,
    "µs": 1_000,
    "ms": 1_000_000,
    "s": 1_000_000_000,
    "m": 60 * 1_000_000_000,
    "h": 3600 * 1_000_000_000,
}


@dataclass
class Token:
    kind: str  # op | ident | keyword | string | int | float | duration | attr | eof
    text: str
    value: object = None
    pos: int = 0


class LexError(Exception):
    pass


def lex(src: str) -> list[Token]:
    out: list[Token] = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c.isspace():
            i += 1
            continue
        if src.startswith(("&&", "||", ">>", ">=", "<=", "!=", "=~", "!~"), i):
            out.append(Token("op", src[i : i + 2], pos=i))
            i += 2
            continue
        if c == '"' or c == "`":
            q = c
            j = i + 1
            buf = []
            while j < n and src[j] != q:
                if q == '"' and src[j] == "\\" and j + 1 < n:
                    esc = src[j + 1]
                    buf.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\"}.get(esc, esc))
                    j += 2
                else:
                    buf.append(src[j])
                    j += 1
            if j >= n:
                raise LexError(f"unterminated string at {i}")
            out.append(Token("string", src[i : j + 1], value="".join(buf), pos=i))
            i = j + 1
            continue
        if c == ".":
            # .attr (attribute in default scope) vs arithmetic dot — TraceQL
            # has no float-leading-dot, so '.' followed by attr chars is an
            # attribute reference
            m = _ATTR_RE.match(src, i + 1)
            if m:
                out.append(Token("attr", src[i : m.end()], value=m.group(0), pos=i))
                i = m.end()
                continue
            raise LexError(f"bare '.' at {i}")
        m = _DURATION_RE.match(src, i)
        if m and m.group(0) != "":
            txt = m.group(0)
            num = float(txt[: -len(m.group(2))])
            out.append(Token("duration", txt, value=int(num * DURATION_NS[m.group(2)]), pos=i))
            i = m.end()
            continue
        m = _NUMBER_RE.match(src, i)
        if m:
            txt = m.group(0)
            if "." in txt:
                out.append(Token("float", txt, value=float(txt), pos=i))
            else:
                out.append(Token("int", txt, value=int(txt), pos=i))
            i = m.end()
            continue
        m = _IDENT_RE.match(src, i)
        if m:
            txt = m.group(0)
            kind = "keyword" if txt in KEYWORDS else "ident"
            out.append(Token(kind, txt, value=txt, pos=i))
            i = m.end()
            continue
        if c in _ONE_CHAR:
            out.append(Token("op", c, pos=i))
            i += 1
            continue
        raise LexError(f"unexpected character {c!r} at {i}")
    out.append(Token("eof", "", pos=n))
    return out
