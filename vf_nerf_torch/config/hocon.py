"""Minimal HOCON parser.

The reference config system uses pyhocon to read ``confs/vf_nerf.conf``
(reference: ``config_parser/vf_nerf_config_parser.py:66``). pyhocon is not
available in this environment, so this module implements the HOCON subset the
VF-NeRF config files actually use:

- nested objects ``name { ... }`` (with or without ``=``/``:``),
- ``key = value`` / ``key : value`` pairs,
- scalar values: ints, floats (incl. scientific notation), booleans
  (``true/false`` and Python-style ``True/False``, which the reference conf
  files use), quoted and unquoted strings,
- lists ``[a, b, c]`` with optional trailing commas,
- ``#`` and ``//`` comments (including inline comments),
- newline- or comma-separated entries,
- ``include "path"`` directives and ``${path.to.key}`` substitutions are NOT
  supported (unused by the reference confs).

Returned objects are plain ``dict``/``list``/scalars.
"""

from __future__ import annotations

from typing import Any, List, Optional


class HoconParseError(ValueError):
    """Raised when a config file cannot be parsed."""

    def __init__(self, message: str, line: int, col: int) -> None:
        super().__init__(f"{message} (line {line}, column {col})")
        self.line = line
        self.col = col


# Characters that terminate an unquoted token.
_UNQUOTED_TERMINATORS = set("{}[],=:#\n\"")


class _Scanner:
    """Character scanner with line/column tracking."""

    def __init__(self, text: str) -> None:
        self.text = text
        self.pos = 0
        self.line = 1
        self.col = 1

    def eof(self) -> bool:
        return self.pos >= len(self.text)

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def advance(self) -> str:
        ch = self.text[self.pos]
        self.pos += 1
        if ch == "\n":
            self.line += 1
            self.col = 1
        else:
            self.col += 1
        return ch

    def error(self, message: str) -> HoconParseError:
        return HoconParseError(message, self.line, self.col)

    def skip_inline_ws(self) -> None:
        """Skip spaces/tabs/carriage-returns and comments, but not newlines."""
        while not self.eof():
            ch = self.peek()
            if ch in " \t\r":
                self.advance()
            elif ch == "#" or self.text.startswith("//", self.pos):
                self._skip_comment()
            else:
                return

    def skip_ws_and_newlines(self) -> None:
        """Skip all whitespace, newlines and comments."""
        while not self.eof():
            ch = self.peek()
            if ch in " \t\r\n":
                self.advance()
            elif ch == "#" or self.text.startswith("//", self.pos):
                self._skip_comment()
            else:
                return

    def _skip_comment(self) -> None:
        while not self.eof() and self.peek() != "\n":
            self.advance()


def _coerce_scalar(token: str) -> Any:
    """Map an unquoted token to bool/int/float, else keep it as a string."""
    lowered = token.lower()
    if lowered == "true":
        return True
    if lowered == "false":
        return False
    if lowered in ("null", "none"):
        return None
    try:
        return int(token)
    except ValueError:
        pass
    try:
        return float(token)
    except ValueError:
        pass
    return token


def _parse_quoted_string(sc: _Scanner) -> str:
    quote = sc.advance()  # opening quote
    chars: List[str] = []
    while True:
        if sc.eof():
            raise sc.error("unterminated string")
        ch = sc.advance()
        if ch == "\\":
            if sc.eof():
                raise sc.error("unterminated escape sequence")
            esc = sc.advance()
            chars.append({"n": "\n", "t": "\t", "r": "\r"}.get(esc, esc))
        elif ch == quote:
            return "".join(chars)
        else:
            chars.append(ch)


def _parse_unquoted_token(sc: _Scanner) -> str:
    chars: List[str] = []
    while not sc.eof():
        ch = sc.peek()
        if ch in _UNQUOTED_TERMINATORS or ch in " \t\r":
            break
        if sc.text.startswith("//", sc.pos):
            break
        chars.append(sc.advance())
    if not chars:
        raise sc.error("expected a token")
    return "".join(chars)


def _parse_value(sc: _Scanner) -> Any:
    sc.skip_ws_and_newlines()
    ch = sc.peek()
    if ch == "{":
        return _parse_object(sc)
    if ch == "[":
        return _parse_list(sc)
    if ch == '"' or ch == "'":
        return _parse_quoted_string(sc)
    token = _parse_unquoted_token(sc)
    return _coerce_scalar(token)


def _parse_list(sc: _Scanner) -> List[Any]:
    assert sc.advance() == "["
    items: List[Any] = []
    while True:
        sc.skip_ws_and_newlines()
        if sc.eof():
            raise sc.error("unterminated list")
        if sc.peek() == "]":
            sc.advance()
            return items
        items.append(_parse_value(sc))
        sc.skip_ws_and_newlines()
        if sc.peek() == ",":
            sc.advance()
        elif sc.peek() == "]":
            sc.advance()
            return items


def _parse_key(sc: _Scanner) -> str:
    if sc.peek() in ('"', "'"):
        return _parse_quoted_string(sc)
    return _parse_unquoted_token(sc)


def _parse_object_body(sc: _Scanner, closing: Optional[str]) -> dict:
    """Parse ``key = value`` entries until `closing` (or EOF when None)."""
    result: dict = {}
    while True:
        sc.skip_ws_and_newlines()
        if sc.eof():
            if closing is not None:
                raise sc.error(f"expected '{closing}' before end of input")
            return result
        if closing is not None and sc.peek() == closing:
            sc.advance()
            return result
        key = _parse_key(sc)
        sc.skip_inline_ws()
        ch = sc.peek()
        if ch in ("=", ":"):
            sc.advance()
            value = _parse_value(sc)
        elif ch == "{":
            # `name { ... }` object syntax without separator.
            value = _parse_object(sc)
        else:
            raise sc.error(f"expected '=', ':' or '{{' after key {key!r}")
        if isinstance(value, dict) and isinstance(result.get(key), dict):
            # HOCON object merge semantics for duplicate keys.
            result[key].update(value)
        else:
            result[key] = value
        sc.skip_inline_ws()
        if not sc.eof() and sc.peek() == ",":
            sc.advance()


def _parse_object(sc: _Scanner) -> dict:
    assert sc.advance() == "{"
    return _parse_object_body(sc, closing="}")


def parse_string(text: str) -> dict:
    """Parse a HOCON document from a string into nested dicts."""
    sc = _Scanner(text)
    return _parse_object_body(sc, closing=None)


def parse_file(path: str) -> dict:
    """Parse a HOCON config file (the reference ``pyhocon`` entry point)."""
    with open(path, "r") as f:
        return parse_string(f.read())
