"""SPARQL UPDATE subset parser: ``INSERT DATA`` / ``DELETE DATA``.

Grammar (reusing the SPARQL lexer from :mod:`repro_torch.rdf.sparql`):

    update   := prologue (op)+
    prologue := (PREFIX name: <iri>)*
    op       := INSERT DATA '{' triples '}'
              | DELETE DATA '{' triples '}'
    triples  := (term term term '.'?)*

Terms are ground (no variables — DATA blocks are concrete triples).  IRIs
and prefixed names normalize exactly like query terms (``rdf:type`` /
``rdf:subClassOf`` short forms); literals keep their quoted lexical form so
they dictionary-encode the way the N-Triples loader does.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.rdf.sparql import (SparqlError, _lex, normalize_iri,
                              normalize_prefixed)


class UpdateError(ValueError):
    """Malformed SPARQL UPDATE text or an unsupported mutation."""


@dataclass
class UpdateOp:
    action: str  # "insert" | "delete"
    triples: list[tuple[str, str, str]] = field(default_factory=list)


class _UpdateParser:
    def __init__(self, src: str):
        try:
            self.toks = _lex(src)
        except SparqlError as e:
            raise UpdateError(str(e)) from e
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind: str):
        t = self.next()
        if t.kind != kind:
            raise UpdateError(
                f"expected {kind}, got {t.kind} {t.text!r} at {t.pos}")
        return t

    def parse(self) -> list[UpdateOp]:
        while self.peek().kind == "PREFIX":
            self.next()
            self.expect("NAME")
            self.expect("IRI")  # prefixes fold into terms at lex level
        ops: list[UpdateOp] = []
        while self.peek().kind != "EOF":
            t = self.next()
            word = t.text.upper() if t.kind == "NAME" else ""
            if word not in ("INSERT", "DELETE"):
                raise UpdateError(
                    f"expected INSERT/DELETE DATA, got {t.text!r} at {t.pos}")
            data = self.next()
            if data.kind != "NAME" or data.text.upper() != "DATA":
                raise UpdateError(
                    "only INSERT DATA / DELETE DATA are supported "
                    f"(got {data.text!r} at {data.pos})")
            ops.append(UpdateOp(action=word.lower(),
                                triples=self._data_block()))
            if self.peek().kind == "DOT":  # tolerate ';'-less separators
                self.next()
        if not ops:
            raise UpdateError("empty update: no INSERT DATA / DELETE DATA op")
        return ops

    def _data_block(self) -> list[tuple[str, str, str]]:
        self.expect("LBRACE")
        triples: list[tuple[str, str, str]] = []
        while self.peek().kind != "RBRACE":
            if self.peek().kind == "EOF":
                raise UpdateError("unexpected EOF inside DATA block")
            s = self._term()
            p = self._term(pred=True)
            o = self._term()
            triples.append((s, p, o))
            if self.peek().kind == "DOT":
                self.next()
        self.next()  # RBRACE
        return triples

    def _term(self, pred: bool = False) -> str:
        t = self.next()
        if t.kind == "IRI":
            return normalize_iri(t.text[1:-1])
        if t.kind == "NAME":
            return normalize_prefixed(t.text)
        if t.kind == "A" and pred:
            return "rdf:type"
        if t.kind == "LITERAL" and not pred:
            end = t.text.rfind('"')
            return f'"{t.text[1:end]}"'
        if t.kind == "NUMBER" and not pred:
            return f'"{t.text}"'
        if t.kind == "VAR":
            raise UpdateError(
                f"variables are not allowed in DATA blocks ({t.text!r} at "
                f"{t.pos}); use ground triples")
        raise UpdateError(f"bad term {t.text!r} at {t.pos}")


def parse_update(src: str) -> list[UpdateOp]:
    """Parse SPARQL UPDATE text into a list of insert/delete operations."""
    return _UpdateParser(src).parse()
