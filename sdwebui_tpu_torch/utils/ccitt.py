"""CCITT bi-level decoding (ITU-T T.4 and T.6), for TIFF's compressions 2
(Modified Huffman, each row byte-aligned), 3 (Group 3: an EOL before each
row, 1-D or, with ``T4Options`` bit 0, a tag bit choosing 1-D or 2-D rows)
and 4 (Group 4: 2-D rows against the row above, the first against white),
as libtiff's ``tif_fax3.c`` decodes them for Pillow.

``decode(data, width, height, kind, t4_options)`` gives (height, width)
uint8 samples, 1 where a run was coded black.  The caller reverses each
byte's bits first for ``FillOrder`` 2 and reads 1 as black or white by the
photometric interpretation.  The bit string is walked one code at a time
on the host, each code by one lookup in a table of the stream's 13-bit
windows (a 1728×2200 page of text in one to two seconds).
"""

from __future__ import annotations

import numpy as np

_WHITE_TERM = (
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111", "10011", "10100",
    "00111", "01000", "001000", "000011", "110100", "110101", "101010", "101011", "0100111",
    "0001100", "0001000", "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011", "00010010",
    "00010011", "00010100", "00010101", "00010110", "00010111", "00101000", "00101001",
    "00101010", "00101011", "00101100", "00101101", "00000100", "00000101", "00001010",
    "00001011", "01010010", "01010011", "01010100", "01010101", "00100100", "00100101",
    "01011000", "01011001", "01011010", "01011011", "01001010", "01001011", "00110010",
    "00110011", "00110100")
_WHITE_MAKEUP = (
    "11011", "10010", "010111", "0110111", "00110110", "00110111", "01100100", "01100101",
    "01101000", "01100111", "011001100", "011001101", "011010010", "011010011", "011010100",
    "011010101", "011010110", "011010111", "011011000", "011011001", "011011010", "011011011",
    "010011000", "010011001", "010011010", "011000", "010011011")
_BLACK_TERM = (
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011", "000101", "000100",
    "0000100", "0000101", "0000111", "00000100", "00000111", "000011000", "0000010111",
    "0000011000", "0000001000", "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010", "000011001011",
    "000011001100", "000011001101", "000001101000", "000001101001", "000001101010",
    "000001101011", "000011010010", "000011010011", "000011010100", "000011010101",
    "000011010110", "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110", "000001010111",
    "000001100100", "000001100101", "000001010010", "000001010011", "000000100100",
    "000000110111", "000000111000", "000000100111", "000000101000", "000001011000",
    "000001011001", "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111")
_BLACK_MAKEUP = (
    "0000001111", "000011001000", "000011001001", "000001011011", "000000110011",
    "000000110100", "000000110101", "0000001101100", "0000001101101", "0000001001010",
    "0000001001011", "0000001001100", "0000001001101", "0000001110010", "0000001110011",
    "0000001110100", "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010", "0000001011011",
    "0000001100100", "0000001100101")
_EXT_MAKEUP = ("00000001000", "00000001100", "00000001101", "000000010010", "000000010011",
               "000000010100", "000000010101", "000000010110", "000000010111", "000000011100",
               "000000011101", "000000011110", "000000011111")


def _codes(term, makeup) -> dict:
    table = {code: n for n, code in enumerate(term)}
    table.update({code: 64 * (i + 1) for i, code in enumerate(makeup)})
    table.update({code: 1792 + 64 * i for i, code in enumerate(_EXT_MAKEUP)})
    return table


_RUNS = (_codes(_WHITE_TERM, _WHITE_MAKEUP), _codes(_BLACK_TERM, _BLACK_MAKEUP))
#: 2-D mode codes → ("P", "H") or the vertical offset
_MODES = {"0001": "P", "001": "H", "1": 0, "011": 1, "000011": 2, "0000011": 3, "010": -1,
          "000010": -2, "0000010": -3}
_EOL = b"000000000001"
_PEEK = 13                      # the longest code's bits


def _lookup(codes: dict) -> list:
    """{code string: value} → a table over every `_PEEK`-bit window: the
    value and length of the code the window starts with, or None."""
    table: list = [None] * (1 << _PEEK)
    for code, value in codes.items():
        shift = _PEEK - len(code)
        base = int(code, 2) << shift
        table[base:base + (1 << shift)] = [(value, len(code))] * (1 << shift)
    return table


_RUN_TABLES = tuple(_lookup(t) for t in _RUNS)
_MODE_TABLE = _lookup(_MODES)


class _Bits:
    def __init__(self, data: bytes):
        bits = np.unpackbits(np.frombuffer(data, np.uint8)) if data else np.zeros(0, np.uint8)
        self.s = (bits + 48).astype(np.uint8).tobytes()      # b"0" / b"1" a bit
        padded = np.concatenate([bits, np.zeros(_PEEK, np.uint8)]).astype(np.int64)
        win = np.zeros(len(bits) + 1, np.int64)
        for k in range(_PEEK):   # entry p: the _PEEK bits from bit p, MSB first
            win += padded[k:k + len(bits) + 1] << (_PEEK - 1 - k)
        self.win = win.tolist()
        self.pos = 0

    def code(self, table: list) -> object:
        pos = self.pos
        hit = table[self.win[pos]] if pos < len(self.win) else None
        if hit is None:
            raise ValueError(f"CCITT: no code at bit {pos}")
        self.pos = pos + hit[1]
        return hit[0]

    def run(self, colour: int) -> int:
        table, win = _RUN_TABLES[colour], self.win
        total, pos = 0, self.pos
        while True:
            hit = table[win[pos]] if pos < len(win) else None
            if hit is None:
                raise ValueError(f"CCITT: no run code at bit {pos}")
            pos += hit[1]
            total += hit[0]
            if hit[0] < 64:
                self.pos = pos
                return total

    def sync_eol(self) -> bool:
        """libtiff's SYNC_EOL: skip to just past the next EOL; False at
        the end of the data."""
        at = self.s.find(b"00000000000", self.pos)
        if at < 0:
            return False
        one = self.s.find(b"1", at + 11)
        if one < 0:
            return False
        self.pos = one + 1
        return True

    def align(self) -> None:
        self.pos = -(-self.pos // 8) * 8


def _row_1d(bits: _Bits, width: int) -> list:
    """A 1-D (Modified Huffman) row → its changing elements."""
    changes, x, colour = [], 0, 0
    while x < width:
        x += bits.run(colour)
        changes.append(min(x, width))
        colour ^= 1
    return changes


def _row_2d(bits: _Bits, ref: list, width: int) -> list:
    """A 2-D row coded against the reference row's changing elements."""
    changes: list = []
    a0, colour = -1, 0
    ref = ref + [width, width]
    k = 0
    while a0 < width:
        # b1: the first change on the reference row right of a0 to the
        # colour opposite a0's (even changes turn black, odd ones white)
        while k > 0 and ref[k - 1] > a0:
            k -= 1
        while ref[k] <= a0 or (k & 1) != colour:
            k += 1
            if k >= len(ref) - 1:
                break
        b1 = ref[k] if k < len(ref) else width
        b2 = ref[k + 1] if k + 1 < len(ref) else width
        mode = bits.code(_MODE_TABLE)
        if mode == "P":
            a0 = b2
        elif mode == "H":
            start = max(a0, 0)
            a1 = start + bits.run(colour)
            a2 = a1 + bits.run(colour ^ 1)
            changes += [min(a1, width), min(a2, width)]
            a0 = a2
        else:
            a1 = b1 + mode
            if a1 < max(a0, 0) or a1 > width:
                raise ValueError("CCITT: a vertical code off the row")
            changes.append(a1)
            a0 = a1
            colour ^= 1
    return changes


def _pixels(changes: list, width: int) -> np.ndarray:
    """Changing elements → a row of 0/1, white first."""
    edges = np.minimum(np.maximum.accumulate(np.asarray(changes + [width], np.int64)), width)
    runs = np.diff(np.concatenate([[0], edges]))
    return np.repeat(np.arange(len(runs), dtype=np.int64) & 1, runs).astype(np.uint8)


def decode(data: bytes, width: int, height: int, kind: str, t4_options: int = 0) -> np.ndarray:
    """CCITT-coded rows → (height, width) uint8, 1 where coded black.
    kind: "rle" (TIFF compression 2), "g3" (3) or "g4" (4)."""
    bits = _Bits(data)
    out = np.zeros((height, width), np.uint8)
    ref: list = []
    two_d = bool(t4_options & 1)
    for y in range(height):
        if kind == "rle":
            changes = _row_1d(bits, width)
            bits.align()
        elif kind == "g3":
            if bits.s.startswith(_EOL[:11], bits.pos) or y == 0:
                if not bits.sync_eol():
                    break
            one_d = True
            if two_d:
                one_d = bits.s[bits.pos:bits.pos + 1] == b"1"
                bits.pos += 1
            changes = _row_1d(bits, width) if one_d else _row_2d(bits, ref, width)
        else:
            if bits.s.startswith(_EOL, bits.pos):
                break                                   # EOFB
            changes = _row_2d(bits, ref, width)
        out[y] = _pixels(changes, width)
        ref = [c for c in changes if c < width] if kind != "rle" else []
    return out
