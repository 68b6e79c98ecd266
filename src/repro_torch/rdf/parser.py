"""Minimal N-Triples parser (subset sufficient for the benchmarks and tests).

Grammar per line:  ``subject predicate object .``
  subject   := <IRI> | prefixed:name | _:blank
  predicate := <IRI> | prefixed:name
  object    := subject-forms | "literal" | "literal"^^<type> | "literal"@lang

Comments (``# ...``) and blank lines are skipped.  Malformed lines raise
``ParseError`` with a line number (strict mode) or are counted and skipped
(lenient mode — the BTC2012 dataset in the paper is famously dirty).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, TextIO

from repro_torch.rdf.triples import TripleStore


class ParseError(ValueError):
    pass


@dataclass
class ParseStats:
    lines: int = 0
    triples: int = 0
    skipped: int = 0


def _scan_term(line: str, pos: int, lineno: int) -> tuple[str, int]:
    """Return (term, new_pos) starting at first non-space char at/after pos."""
    n = len(line)
    while pos < n and line[pos] in " \t":
        pos += 1
    if pos >= n:
        raise ParseError(f"line {lineno}: unexpected end of line")
    c = line[pos]
    if c == "<":  # IRI
        end = line.find(">", pos + 1)
        if end < 0:
            raise ParseError(f"line {lineno}: unterminated IRI")
        return line[pos + 1 : end], end + 1
    if c == '"':  # literal (with escapes), optional ^^type / @lang suffix
        i = pos + 1
        while i < n:
            if line[i] == "\\":
                i += 2
                continue
            if line[i] == '"':
                break
            i += 1
        if i >= n:
            raise ParseError(f"line {lineno}: unterminated literal")
        end = i + 1
        # consume datatype / language tag into the lexical form
        if end < n and line[end] == "@":
            while end < n and line[end] not in " \t":
                end += 1
        elif end + 1 < n and line[end : end + 2] == "^^":
            end += 2
            if end < n and line[end] == "<":
                close = line.find(">", end)
                if close < 0:
                    raise ParseError(f"line {lineno}: unterminated datatype IRI")
                end = close + 1
        return line[pos:end], end
    # prefixed name or blank node: read to whitespace
    end = pos
    while end < n and line[end] not in " \t":
        end += 1
    term = line[pos:end]
    if term.endswith("."):  # allow `obj .` glued to the dot
        term = term[:-1]
        end -= 1
    if not term:
        raise ParseError(f"line {lineno}: empty term")
    return term, end


def parse_line(line: str, lineno: int = 0) -> tuple[str, str, str] | None:
    stripped = line.strip()
    if not stripped or stripped.startswith("#"):
        return None
    s, pos = _scan_term(line, 0, lineno)
    p, pos = _scan_term(line, pos, lineno)
    o, pos = _scan_term(line, pos, lineno)
    rest = line[pos:].strip()
    if rest not in (".", ""):
        raise ParseError(f"line {lineno}: trailing garbage {rest!r}")
    return s, p, o


def parse_ntriples(
    lines: Iterable[str] | TextIO,
    store: TripleStore | None = None,
    strict: bool = True,
) -> tuple[TripleStore, ParseStats]:
    store = store if store is not None else TripleStore()
    stats = ParseStats()
    for lineno, line in enumerate(lines, start=1):
        stats.lines += 1
        try:
            t = parse_line(line, lineno)
        except ParseError:
            if strict:
                raise
            stats.skipped += 1
            continue
        if t is None:
            continue
        store.add(*t)
        stats.triples += 1
    return store, stats


def serialize_ntriples(triples: Iterable[tuple[str, str, str]]) -> Iterator[str]:
    """Inverse of the parser for round-trip tests: IRIs <>-wrapped unless literal/prefixed."""
    for s, p, o in triples:
        yield f"{_wrap(s)} {_wrap(p)} {_wrap(o)} ."


def _wrap(term: str) -> str:
    if term.startswith('"') or term.startswith("_:"):
        return term
    if ":" in term and not term.startswith("http"):
        return term  # prefixed name
    return f"<{term}>"
