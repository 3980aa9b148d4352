"""Tokenizer: character stream → token stream.

Reference: src/parser/Tokenizer.cpp (stork tokenizer: maximal-munch
operators, // and /* */ comments, numbers, strings) over
PushBackStream (line/char counters, PushBackStream.h:9).
"""

from __future__ import annotations

from typing import Iterator, List

from abc_tpu_torch.parser.tokens import KEYWORDS, OPERATORS, TokKind, Token
from abc_tpu_torch.utils.errors import ParsingError


def tokenize(source: str) -> List[Token]:
    return list(_tokenize_iter(source))


def _tokenize_iter(source: str) -> Iterator[Token]:
    i, n = 0, len(source)
    line, line_start = 0, 0

    def pos_char(idx: int) -> int:
        return idx - line_start

    while i < n:
        c = source[i]
        # whitespace / newlines
        if c == "\n":
            line += 1
            i += 1
            line_start = i
            continue
        if c.isspace():
            i += 1
            continue
        # comments
        if source.startswith("//", i):
            j = source.find("\n", i)
            i = n if j < 0 else j
            continue
        if source.startswith("/*", i):
            j = source.find("*/", i)
            if j < 0:
                raise ParsingError("unterminated block comment", line, pos_char(i))
            # keep line numbers correct through multi-line comments
            for k in range(i, j):
                if source[k] == "\n":
                    line += 1
                    line_start = k + 1
            i = j + 2
            continue
        # identifiers / keywords
        if c.isalpha() or c == "_":
            j = i
            while j < n and (source[j].isalnum() or source[j] == "_"):
                j += 1
            word = source[i:j]
            kind = TokKind.RESERVED if word in KEYWORDS else TokKind.IDENTIFIER
            yield Token(kind, word, line, pos_char(i))
            i = j
            continue
        # numbers
        if c.isdigit() or (c == "." and i + 1 < n and source[i + 1].isdigit()):
            j = i
            is_float = False
            while j < n and (source[j].isdigit() or source[j] == "."):
                if source[j] == ".":
                    if is_float:
                        raise ParsingError("malformed number", line, pos_char(i))
                    is_float = True
                j += 1
            # optional exponent
            if j < n and source[j] in "eE":
                k = j + 1
                if k < n and source[k] in "+-":
                    k += 1
                if k < n and source[k].isdigit():
                    is_float = True
                    j = k
                    while j < n and source[j].isdigit():
                        j += 1
            text = source[i:j]
            # trailing f suffix → float (else doubles, like the reference)
            if j < n and source[j] in "fF" and is_float:
                yield Token(TokKind.FLOAT, float(text), line, pos_char(i))
                j += 1
            elif is_float:
                yield Token(TokKind.DOUBLE, float(text), line, pos_char(i))
            else:
                yield Token(TokKind.INT, int(text), line, pos_char(i))
            i = j
            continue
        # strings
        if c == '"':
            j = i + 1
            buf = []
            while j < n and source[j] != '"':
                if source[j] == "\\" and j + 1 < n:
                    esc = source[j + 1]
                    buf.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\"}.get(esc, esc))
                    j += 2
                else:
                    buf.append(source[j])
                    j += 1
            if j >= n:
                raise ParsingError("unterminated string literal", line, pos_char(i))
            yield Token(TokKind.STRING, "".join(buf), line, pos_char(i))
            i = j + 1
            continue
        # chars
        if c == "'":
            if i + 2 < n and source[i + 2] == "'":
                yield Token(TokKind.CHAR, source[i + 1], line, pos_char(i))
                i += 3
                continue
            raise ParsingError("malformed char literal", line, pos_char(i))
        # operators / punctuation — maximal munch
        for op in OPERATORS:
            if source.startswith(op, i):
                yield Token(TokKind.RESERVED, op, line, pos_char(i))
                i += len(op)
                break
        else:
            raise ParsingError(f"unexpected character {c!r}", line, pos_char(i))

    yield Token(TokKind.EOF, None, line, pos_char(i))


class TokenStream:
    """Pull-based token iterator with lookahead (ref: tokens_iterator,
    Tokenizer.h:15-37)."""

    def __init__(self, source: str):
        self._tokens = tokenize(source)
        self._pos = 0

    @property
    def current(self) -> Token:
        return self._tokens[self._pos]

    def peek(self, offset: int = 1) -> Token:
        idx = min(self._pos + offset, len(self._tokens) - 1)
        return self._tokens[idx]

    def advance(self) -> Token:
        tok = self.current
        if not tok.is_eof():
            self._pos += 1
        return tok

    def expect(self, spelling: str) -> Token:
        tok = self.current
        if not tok.is_reserved(spelling):
            raise ParsingError(f"expected {spelling!r} but found {tok.value!r}",
                               tok.line, tok.char)
        return self.advance()

    def accept(self, spelling: str) -> bool:
        if self.current.is_reserved(spelling):
            self.advance()
            return True
        return False
