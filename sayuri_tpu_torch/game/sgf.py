"""SGF parsing and writing (host-side; a copy of sayuri_tpu.game.sgf, which
is pure Python).

The reference engine's SGF layer (sgf.cc): multi-game files, property
multimaps, per-move comments, and its emit conventions (SZ/KM/RU/PB/PW/RE,
AB/AW handicap setup). Not on any hot path.
"""

from __future__ import annotations

import string
from dataclasses import dataclass, field

SGF_COLS = string.ascii_lowercase  # sgf coords: 'a'.. ; no 'i' skip in SGF


@dataclass
class SgfNode:
    props: dict = field(default_factory=dict)  # key -> list[str]

    def get(self, key, default=None):
        v = self.props.get(key)
        return v[0] if v else default

    def add(self, key, value):
        self.props.setdefault(key, []).append(value)


@dataclass
class SgfGame:
    nodes: list = field(default_factory=list)  # linear main line

    @property
    def root(self) -> SgfNode:
        return self.nodes[0]

    def board_size(self) -> int:
        return int(self.root.get("SZ", "19"))

    def komi(self) -> float:
        try:
            return float(self.root.get("KM", "7.5"))
        except ValueError:
            return 7.5

    def handicap_stones(self):
        """AB/AW setup stones as (color, (y, x)) with color 0=black."""
        out = []
        for key, color in (("AB", 0), ("AW", 1)):
            for v in self.root.props.get(key, []):
                yx = sgf_to_coord(v, self.board_size())
                if yx is not None:
                    out.append((color, yx))
        return out

    def moves(self):
        """Main-line moves as (color 0/1, vertex or None for pass)."""
        size = self.board_size()
        out = []
        for node in self.nodes:
            for key, color in (("B", 0), ("W", 1)):
                if key in node.props:
                    v = node.props[key][0]
                    yx = sgf_to_coord(v, size)
                    out.append(
                        (color, None if yx is None else yx[0] * size + yx[1])
                    )
        return out


def sgf_to_coord(s: str, size: int):
    """'dd' -> (y, x); '' or 'tt' (size<=19) -> None (pass)."""
    s = s.strip()
    if not s or (s == "tt" and size <= 19):
        return None
    x = SGF_COLS.index(s[0])
    y = SGF_COLS.index(s[1])
    if x >= size or y >= size:
        return None
    return (y, x)


def coord_to_sgf(vertex, size: int) -> str:
    if vertex is None or vertex < 0 or vertex >= size * size:
        return ""
    y, x = divmod(vertex, size)
    return SGF_COLS[x] + SGF_COLS[y]


class SgfParser:
    """Recursive-descent SGF parser; keeps the main line only (the
    reference also walks only the first variation, sgf.cc)."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def parse_games(self):
        games = []
        while True:
            self._skip_ws()
            if self.pos >= len(self.text) or self.text[self.pos] != "(":
                break
            games.append(self._parse_game())
        return games

    def _skip_ws(self):
        while self.pos < len(self.text) and self.text[self.pos] not in "(;":
            self.pos += 1

    def _parse_game(self) -> SgfGame:
        game = SgfGame()
        depth = 0
        i = self.pos
        n = len(self.text)
        cur = None
        main_line_depth = None
        while i < n:
            c = self.text[i]
            if c == "(":
                depth += 1
                if main_line_depth is None:
                    main_line_depth = depth
                i += 1
            elif c == ")":
                depth -= 1
                i += 1
                if depth == 0:
                    break
            elif c == ";":
                if depth == main_line_depth:
                    cur = SgfNode()
                    game.nodes.append(cur)
                else:
                    cur = None  # ignore side variations
                i += 1
            elif c.isalpha() and cur is not None or (c.isalpha() and cur is None):
                # property ident
                j = i
                while j < n and self.text[j].isalpha():
                    j += 1
                ident = self.text[i:j]
                i = j
                # one or more [values]
                while True:
                    while i < n and self.text[i] in " \t\r\n":
                        i += 1
                    if i >= n or self.text[i] != "[":
                        break
                    i += 1
                    val = []
                    while i < n:
                        ch = self.text[i]
                        if ch == "\\" and i + 1 < n:
                            val.append(self.text[i + 1])
                            i += 2
                            continue
                        if ch == "]":
                            i += 1
                            break
                        val.append(ch)
                        i += 1
                    if cur is not None:
                        cur.add(ident.upper(), "".join(val))
            else:
                i += 1
        self.pos = i
        return game


def parse_file(path: str):
    with open(path, "r", errors="replace") as f:
        return SgfParser(f.read()).parse_games()


def parse_string(text: str):
    return SgfParser(text).parse_games()


def game_to_sgf(
    size: int,
    komi: float,
    moves,                  # list[(color, vertex_or_None, comment_or_None)]
    result: str = "",
    rule: str = "chinese",
    handicap_stones=None,   # list[(color, vertex)]
    black_name: str = "sayuri-tpu",
    white_name: str = "sayuri-tpu",
) -> str:
    """Emit a single-game SGF (Sgf::ToString conventions, sgf.cc)."""
    out = [
        "(;GM[1]FF[4]SZ[%d]KM[%s]RU[%s]PB[%s]PW[%s]"
        % (size, f"{komi:g}", rule, black_name, white_name)
    ]
    if result:
        out.append(f"RE[{result}]")
    if handicap_stones:
        blacks = [v for c, v in handicap_stones if c == 0]
        whites = [v for c, v in handicap_stones if c == 1]
        if blacks:
            out.append("AB" + "".join(f"[{coord_to_sgf(v, size)}]" for v in blacks))
        if whites:
            out.append("AW" + "".join(f"[{coord_to_sgf(v, size)}]" for v in whites))
    for item in moves:
        color, vertex = item[0], item[1]
        comment = item[2] if len(item) > 2 else None
        key = "B" if color == 0 else "W"
        out.append(f";{key}[{coord_to_sgf(vertex, size)}]")
        if comment:
            esc = comment.replace("\\", "\\\\").replace("]", "\\]")
            out.append(f"C[{esc}]")
    out.append(")")
    return "".join(out)
