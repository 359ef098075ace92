"""A TrueType (sfnt) reader and the shaping Pillow's raqm layout does on it.

The text JAX draws on grids and cards goes through Pillow's FreeType
binding (``sdwebui_tpu/utils/grid_annotations.py``, the embedding card of
``sdwebui_tpu/training/textual_inversion.py:372-380``).  This module reads
what that needs from a font file, in numpy and the stdlib:

- ``head``, ``hhea``, ``maxp``, ``OS/2``, ``hmtx``, ``cmap`` (formats 4 and
  12), ``loca`` and ``glyf``: simple glyphs, and composite glyphs with their
  offsets, transforms and point matching;
- ``cvt ``, ``fpgm``, ``prep`` and ``gasp``, which the hinter
  (``utils/truetype_hint.py``) runs;
- GSUB and GPOS for the features HarfBuzz applies by default to a
  horizontal run: GSUB single, ligature and chaining-context substitutions
  (through extension lookups), GPOS pair adjustment (formats 1 and 2) for
  ``kern``; the legacy ``kern`` table (format 0) where a font has no GPOS.

What raqm does and this reader does not raises ``NotImplementedError``
naming it: right-to-left text, scripts that need complex shaping (and
combining marks, which take GPOS mark attachment), a default GSUB lookup
of another type that would apply, and CFF outlines.  A character the font
lacks is drawn as glyph 0 (``.notdef``), as Pillow draws it.
"""

from __future__ import annotations

import functools
import struct
import unicodedata

import numpy as np

#: the GSUB features HarfBuzz turns on for every horizontal run
GSUB_DEFAULT = ("ccmp", "locl", "rlig", "rclt", "calt", "clig", "liga")
#: the scripts whose shaping is only the default features above, by the
#: OpenType script tag HarfBuzz gives them; any other script raises
SIMPLE_SCRIPTS = {"Latin": "latn", "Greek": "grek", "Cyrillic": "cyrl"}

# composite-glyph flags
ARG_1_AND_2_ARE_WORDS = 0x1
ARGS_ARE_XY_VALUES = 0x2
ROUND_XY_TO_GRID = 0x4
WE_HAVE_A_SCALE = 0x8
MORE_COMPONENTS = 0x20
WE_HAVE_AN_X_AND_Y_SCALE = 0x40
WE_HAVE_A_TWO_BY_TWO = 0x80
WE_HAVE_INSTRUCTIONS = 0x100
USE_MY_METRICS = 0x200
SCALED_COMPONENT_OFFSET = 0x800
UNSCALED_COMPONENT_OFFSET = 0x1000


class Glyph:
    """One glyf entry in font units: ``points`` (n, 2) int64, ``on`` (n,)
    bool, ``ends`` the contours' last point indices, ``program`` its
    instructions, and for a composite ``components`` [(glyph id, flags,
    arg1, arg2, (xx, xy, yx, yy) in F2Dot14 or None)]."""

    __slots__ = ("points", "on", "ends", "program", "components", "bbox")

    def __init__(self, points, on, ends, program=b"", components=None, bbox=(0, 0, 0, 0)):
        self.points, self.on, self.ends = points, on, ends
        self.program, self.components, self.bbox = program, components, bbox


def _u16(b, o):
    return struct.unpack_from(">H", b, o)[0]


def _i16(b, o):
    return struct.unpack_from(">h", b, o)[0]


def _u32(b, o):
    return struct.unpack_from(">I", b, o)[0]


class Font:
    """The tables of one TrueType font file (``data``: its bytes)."""

    def __init__(self, data: bytes, name: str = "font"):
        self.data, self.name = data, name
        tag = data[:4]
        if tag == b"OTTO":
            raise NotImplementedError(f"{name}: CFF (PostScript) outlines are not ported; only "
                                      "TrueType glyf outlines are read")
        if tag == b"ttcf":
            raise NotImplementedError(f"{name}: font collections (.ttc) are not ported")
        if tag not in (b"\x00\x01\x00\x00", b"true"):
            raise OSError(f"{name}: unknown file format (header {tag!r})")
        n = _u16(data, 4)
        self.tables = {}
        for i in range(n):
            t, _, off, length = struct.unpack_from(">4sIII", data, 12 + 16 * i)
            self.tables[t.decode("latin-1")] = (off, length)
        if "glyf" not in self.tables:
            raise NotImplementedError(f"{name}: no glyf table (CFF outlines are not ported)")
        head = self.table("head")
        self.units_per_em = _u16(head, 18)
        self.head_flags = _u16(head, 16)
        self.index_to_loc = _i16(head, 50)
        hhea = self.table("hhea")
        self.ascender, self.descender = _i16(hhea, 4), _i16(hhea, 6)
        n_hmetrics = _u16(hhea, 34)
        maxp = self.table("maxp")
        self.num_glyphs = _u16(maxp, 4)
        # the hinter's twilight points and storage (maxp version 1.0)
        self.max_twilight, self.max_storage = struct.unpack_from(">2H", maxp, 16) \
            if len(maxp) >= 32 else (0, 0)
        os2 = self.table("OS/2") if "OS/2" in self.tables else None
        self.typo = (_i16(os2, 68), _i16(os2, 70)) if os2 is not None and len(os2) >= 72 \
            else None
        hmtx = self.table("hmtx")
        rec = np.frombuffer(hmtx[:4 * n_hmetrics], ">i2").astype(np.int64).reshape(-1, 2)
        self.advances = np.empty(self.num_glyphs, np.int64)
        self.lsbs = np.empty(self.num_glyphs, np.int64)
        self.advances[:n_hmetrics] = rec[:, 0] & 0xFFFF
        self.lsbs[:n_hmetrics] = rec[:, 1]
        self.advances[n_hmetrics:] = self.advances[n_hmetrics - 1]
        rest = self.num_glyphs - n_hmetrics
        if rest:
            self.lsbs[n_hmetrics:] = np.frombuffer(hmtx[4 * n_hmetrics:4 * n_hmetrics + 2 * rest],
                                                   ">i2")
        loca = self.table("loca")
        if self.index_to_loc == 0:
            self.loca = np.frombuffer(loca, ">u2", self.num_glyphs + 1).astype(np.int64) * 2
        else:
            self.loca = np.frombuffer(loca, ">u4", self.num_glyphs + 1).astype(np.int64)
        self.cmap = self._read_cmap()
        self.cvt = np.frombuffer(self.table("cvt "), ">i2").astype(np.int64) \
            if "cvt " in self.tables else np.zeros(0, np.int64)
        self.fpgm = self.table("fpgm") if "fpgm" in self.tables else b""
        self.prep = self.table("prep") if "prep" in self.tables else b""
        self.gasp = self._read_gasp()
        self._glyphs = {}
        self.gsub = self._layout_table("GSUB")
        self.gpos = self._layout_table("GPOS")
        self.kern_pairs = self._read_kern() if self.gpos is None else {}

    def table(self, tag: str) -> bytes:
        off, length = self.tables[tag]
        return self.data[off:off + length]

    # ---------------------------------------------------------------- cmap

    def _read_cmap(self) -> dict:
        b = self.table("cmap")
        subs = {}
        for i in range(_u16(b, 2)):
            pid, eid, off = struct.unpack_from(">HHI", b, 4 + 8 * i)
            subs[(pid, eid)] = off
        for key in ((3, 10), (0, 4), (0, 6), (3, 1), (0, 3), (0, 2), (0, 1), (0, 0)):
            if key in subs:
                off = subs[key]
                fmt = _u16(b, off)
                if fmt == 12:
                    return self._cmap12(b, off)
                if fmt == 4:
                    return self._cmap4(b, off)
        raise NotImplementedError(f"{self.name}: no Unicode cmap of format 4 or 12")

    @staticmethod
    def _cmap4(b, off) -> dict:
        seg2 = _u16(b, off + 6)
        ends = np.frombuffer(b, ">u2", seg2 // 2, off + 14)
        starts = np.frombuffer(b, ">u2", seg2 // 2, off + 16 + seg2)
        deltas = np.frombuffer(b, ">i2", seg2 // 2, off + 16 + 2 * seg2)
        ro_off = off + 16 + 3 * seg2
        ranges = np.frombuffer(b, ">u2", seg2 // 2, ro_off)
        out = {}
        for i in range(seg2 // 2):
            s, e, d, r = int(starts[i]), int(ends[i]), int(deltas[i]), int(ranges[i])
            for c in range(s, e + 1):
                if c == 0xFFFF:
                    continue
                if r == 0:
                    g = (c + d) & 0xFFFF
                else:
                    g = _u16(b, ro_off + 2 * i + r + 2 * (c - s))
                    if g:
                        g = (g + d) & 0xFFFF
                if g:
                    out[c] = g
        return out

    @staticmethod
    def _cmap12(b, off) -> dict:
        n = _u32(b, off + 12)
        out = {}
        for i in range(n):
            s, e, g = struct.unpack_from(">III", b, off + 16 + 12 * i)
            for c in range(s, e + 1):
                out[c] = g + c - s
        return out

    def _read_gasp(self) -> list:
        if "gasp" not in self.tables:
            return []
        b = self.table("gasp")
        return [struct.unpack_from(">HH", b, 4 + 4 * i) for i in range(_u16(b, 2))]

    # ---------------------------------------------------------------- glyf

    def glyph(self, gid: int) -> Glyph:
        """The glyf entry of glyph `gid` (cached)."""
        g = self._glyphs.get(gid)
        if g is None:
            g = self._glyphs[gid] = self._read_glyph(gid)
        return g

    def _read_glyph(self, gid: int) -> Glyph:
        glyf = self.tables["glyf"][0]
        start, end = int(self.loca[gid]), int(self.loca[gid + 1])
        b = self.data
        empty = Glyph(np.zeros((0, 2), np.int64), np.zeros(0, bool), [])
        if end <= start:
            return empty
        o = glyf + start
        nc, x0, y0, x1, y1 = struct.unpack_from(">hhhhh", b, o)
        o += 10
        if nc >= 0:
            ends = list(struct.unpack_from(f">{nc}H", b, o))
            o += 2 * nc
            n_ins = _u16(b, o)
            program = b[o + 2:o + 2 + n_ins]
            o += 2 + n_ins
            n = ends[-1] + 1 if ends else 0
            flags = []
            while len(flags) < n:
                f = b[o]
                o += 1
                flags.append(f)
                if f & 8:
                    flags.extend([f] * b[o])
                    o += 1
            coords = []
            for short, same in ((2, 16), (4, 32)):
                v, vals = 0, []
                for f in flags[:n]:
                    if f & short:
                        d = b[o]
                        o += 1
                        v += d if f & same else -d
                    elif not f & same:
                        v += _i16(b, o)
                        o += 2
                    vals.append(v)
                coords.append(vals)
            pts = np.stack([np.asarray(coords[0], np.int64), np.asarray(coords[1], np.int64)],
                           axis=1) if n else np.zeros((0, 2), np.int64)
            on = np.asarray([bool(f & 1) for f in flags[:n]], bool)
            return Glyph(pts, on, ends, program, None, (x0, y0, x1, y1))
        comps, more, have_ins = [], True, False
        while more:
            flags, cid = struct.unpack_from(">HH", b, o)
            o += 4
            if flags & ARG_1_AND_2_ARE_WORDS:
                fmt = ">hh" if flags & ARGS_ARE_XY_VALUES else ">HH"
                a1, a2 = struct.unpack_from(fmt, b, o)
                o += 4
            else:
                fmt = ">bb" if flags & ARGS_ARE_XY_VALUES else ">BB"
                a1, a2 = struct.unpack_from(fmt, b, o)
                o += 2
            m = None                    # (xx, xy, yx, yy) in F2Dot14
            if flags & WE_HAVE_A_SCALE:
                m = (_i16(b, o), 0, 0, _i16(b, o))
                o += 2
            elif flags & WE_HAVE_AN_X_AND_Y_SCALE:
                m = (_i16(b, o), 0, 0, _i16(b, o + 2))
                o += 4
            elif flags & WE_HAVE_A_TWO_BY_TWO:
                m = struct.unpack_from(">hhhh", b, o)
                o += 8
            comps.append((cid, flags, a1, a2, m))
            more = bool(flags & MORE_COMPONENTS)
            have_ins |= bool(flags & WE_HAVE_INSTRUCTIONS)
        program = b""
        if have_ins:
            n_ins = _u16(b, o)
            program = b[o + 2:o + 2 + n_ins]
        return Glyph(empty.points, empty.on, [], program, comps, (x0, y0, x1, y1))

    # ------------------------------------------------------- OpenType layout

    def _layout_table(self, tag):
        if tag not in self.tables:
            return None
        b = self.table(tag)
        scripts, features, lookups = _u16(b, 4), _u16(b, 6), _u16(b, 8)
        return dict(data=b, scripts=scripts, features=features, lookups=lookups)

    def _read_kern(self) -> dict:
        if "kern" not in self.tables:
            return {}
        b = self.table("kern")
        pairs, o = {}, 4
        for _ in range(_u16(b, 2)):
            length, coverage = _u16(b, o + 2), _u16(b, o + 4)
            if coverage >> 8 == 0 and coverage & 1:        # horizontal kerning, format 0
                n = _u16(b, o + 6)
                for i in range(n):
                    left, right, v = struct.unpack_from(">HHh", b, o + 14 + 6 * i)
                    pairs[(left, right)] = v
            o += length
        return pairs

    @functools.lru_cache(maxsize=64)
    def feature_lookups(self, tag: str, script: str, features: tuple) -> tuple:
        """The lookup indices of `features` (and the required feature) in
        `script`'s default language system of the GSUB or GPOS table, in
        lookup order, as HarfBuzz collects them."""
        t = self.gsub if tag == "GSUB" else self.gpos
        if t is None:
            return ()
        b, so, fo = t["data"], t["scripts"], t["features"]
        recs = {b[so + 2 + 6 * i:so + 6 + 6 * i].decode("latin-1"): _u16(b, so + 6 + 6 * i)
                for i in range(_u16(b, so))}
        off = recs.get(script, recs.get("DFLT", recs.get("dflt")))
        if off is None:
            return ()
        s = so + off
        ls = _u16(b, s)
        if not ls:
            return ()
        ls += s
        req = _u16(b, ls + 2)
        idx = [_u16(b, ls + 6 + 2 * i) for i in range(_u16(b, ls + 4))]
        out = set()
        for fi in ([req] if req != 0xFFFF else []) + idx:
            rec = fo + 2 + 6 * fi
            ftag = b[rec:rec + 4].decode("latin-1")
            if fi == req or ftag in features:
                f = fo + _u16(b, rec + 4)
                out.update(_u16(b, f + 4 + 2 * k) for k in range(_u16(b, f + 2)))
        return tuple(sorted(out))

    def lookup(self, tag: str, index: int) -> tuple:
        """(type, flag, [subtable offsets into the table's data]) of a
        lookup, extension subtables resolved."""
        t = self.gsub if tag == "GSUB" else self.gpos
        b, lo = t["data"], t["lookups"]
        lk = lo + _u16(b, lo + 2 + 2 * index)
        typ, flag, n = _u16(b, lk), _u16(b, lk + 2), _u16(b, lk + 4)
        subs = [lk + _u16(b, lk + 6 + 2 * i) for i in range(n)]
        ext = 7 if tag == "GSUB" else 9
        if typ == ext:
            typ = _u16(b, subs[0] + 2)
            subs = [s + _u32(b, s + 4) for s in subs]
        return typ, flag, subs


def _coverage(b, off) -> dict:
    """Coverage table → {glyph: coverage index}."""
    fmt = _u16(b, off)
    out = {}
    if fmt == 1:
        for i in range(_u16(b, off + 2)):
            out[_u16(b, off + 4 + 2 * i)] = i
    else:
        for i in range(_u16(b, off + 2)):
            s, e, k = struct.unpack_from(">HHH", b, off + 4 + 6 * i)
            for g in range(s, e + 1):
                out[g] = k + g - s
    return out


def _class_def(b, off) -> dict:
    """ClassDef table → {glyph: class} (absent glyphs are class 0)."""
    fmt = _u16(b, off)
    out = {}
    if fmt == 1:
        start, n = _u16(b, off + 2), _u16(b, off + 4)
        for i in range(n):
            out[start + i] = _u16(b, off + 6 + 2 * i)
    else:
        for i in range(_u16(b, off + 2)):
            s, e, c = struct.unpack_from(">HHH", b, off + 4 + 6 * i)
            for g in range(s, e + 1):
                out[g] = c
    return out


_VALUE_FIELDS = ("XPlacement", "YPlacement", "XAdvance", "YAdvance",
                 "XPlaDevice", "YPlaDevice", "XAdvDevice", "YAdvDevice")


def _value_record(b, o, fmt) -> dict:
    """A ValueRecord's fields {name: value}."""
    vals, n = {}, 0
    for bit, name in enumerate(_VALUE_FIELDS):
        if fmt & (1 << bit):
            vals[name] = _i16(b, o + n)
            n += 2
    return vals


def _value_size(fmt) -> int:
    return 2 * bin(fmt & 0xFF).count("1")


# --------------------------------------------------------------------------
# shaping
# --------------------------------------------------------------------------

_COMPLEX = ("Arabic", "Hebrew", "Syriac", "Thaana", "N'Ko", "Devanagari", "Bengali", "Gurmukhi",
            "Gujarati", "Oriya", "Tamil", "Telugu", "Kannada", "Malayalam", "Sinhala", "Thai",
            "Lao", "Tibetan", "Myanmar", "Khmer", "Mongolian", "Hangul", "Tifinagh")


_SCRIPT_RANGES = (("Latin", 0x0041, 0x024F), ("Latin", 0x0250, 0x02AF), ("Latin", 0x1D00, 0x1DBF),
                  ("Latin", 0x1E00, 0x1EFF), ("Latin", 0x2C60, 0x2C7F), ("Latin", 0xA720, 0xA7FF),
                  ("Latin", 0xFB00, 0xFB06), ("Latin", 0xFF21, 0xFF5A),
                  ("Greek", 0x0370, 0x03FF), ("Greek", 0x1F00, 0x1FFF),
                  ("Cyrillic", 0x0400, 0x052F), ("Cyrillic", 0x2DE0, 0x2DFF),
                  ("Cyrillic", 0xA640, 0xA69F))


def _script_of(ch: str) -> str | None:
    """The Unicode script of a letter (by block; a letter outside these
    blocks by the first word of its name), None for a character of no
    script (digits, punctuation, symbols, spaces)."""
    if not unicodedata.category(ch).startswith("L"):
        return None
    c = ord(ch)
    for script, lo, hi in _SCRIPT_RANGES:
        if lo <= c <= hi:
            return script
    name = unicodedata.name(ch, "")
    return name.split(" ")[0].title() if name else "Unknown"


def check_text(text: str) -> str:
    """The OpenType script tag raqm shapes `text` with; NotImplementedError
    for what this port does not shape (right-to-left text, complex
    scripts, combining marks, more than one script in a run)."""
    scripts = set()
    for ch in text:
        bidi = unicodedata.bidirectional(ch)
        if bidi in ("R", "AL", "AN", "RLE", "RLO", "RLI", "FSI"):
            raise NotImplementedError(f"right-to-left text ({ch!r}, U+{ord(ch):04X}) is not "
                                      "ported: raqm's bidi layout is not restated")
        s = _script_of(ch)
        if s is not None:
            scripts.add(s)
    for s in sorted(scripts):
        if s not in SIMPLE_SCRIPTS:
            what = "complex shaping" if s in _COMPLEX else "its own shaping"
            raise NotImplementedError(f"{s} text is not ported: the script needs {what} "
                                      "(only Latin, Greek and Cyrillic runs are shaped)")
    for ch in text:
        if unicodedata.category(ch) in ("Mn", "Mc", "Me"):
            raise NotImplementedError(f"combining marks ({ch!r}, U+{ord(ch):04X}) are not "
                                      "ported: they take GPOS mark attachment")
    if len(scripts) > 1:
        raise NotImplementedError(f"text mixing scripts {sorted(scripts)} is not ported: raqm "
                                  "shapes each script's run apart")
    return SIMPLE_SCRIPTS[scripts.pop()] if scripts else "DFLT"


def _apply_gsub(font: Font, glyphs: list, script: str) -> list:
    for li in font.feature_lookups("GSUB", script, GSUB_DEFAULT):
        glyphs = _gsub_lookup(font, li, glyphs)
    return glyphs


def _gsub_lookup(font: Font, index: int, glyphs: list) -> list:
    typ, flag, subs = font.lookup("GSUB", index)
    b = font.gsub["data"]
    out, i = list(glyphs), 0
    while i < len(out):
        step = 1
        for s in subs:
            res = _gsub_at(font, b, typ, s, out, i, index)
            if res is not None:
                out, step = res
                break
        i += step
    return out


def _gsub_at(font, b, typ, s, glyphs, i, index):
    """Apply subtable `s` at position i: (new glyphs, positions to advance)
    or None when it does not apply."""
    fmt = _u16(b, s)
    g = glyphs[i]
    if typ == 1:
        cov = _coverage(b, s + _u16(b, s + 2))
        if g not in cov:
            return None
        new = (g + _i16(b, s + 4)) & 0xFFFF if fmt == 1 else _u16(b, s + 6 + 2 * cov[g])
        return glyphs[:i] + [new] + glyphs[i + 1:], 1
    if typ == 4:
        cov = _coverage(b, s + _u16(b, s + 2))
        if g not in cov:
            return None
        ls = s + _u16(b, s + 6 + 2 * cov[g])
        for k in range(_u16(b, ls)):
            lig = ls + _u16(b, ls + 2 + 2 * k)
            lig_glyph, n = _u16(b, lig), _u16(b, lig + 2)
            comps = [_u16(b, lig + 4 + 2 * j) for j in range(n - 1)]
            if glyphs[i + 1:i + n] == comps:
                return glyphs[:i] + [lig_glyph] + glyphs[i + n:], 1
        return None
    if typ == 6:
        return _chain_context(font, b, s, glyphs, i)
    if typ in (2, 3, 5, 8):
        cov = _coverage(b, s + _u16(b, s + 2)) if typ != 5 or fmt != 3 else {}
        if g in cov:
            raise NotImplementedError(f"{font.name}: GSUB lookup {index} of type {typ} applies "
                                      "by default to this text; that substitution is not ported")
        return None
    raise NotImplementedError(f"{font.name}: GSUB lookup {index} of type {typ} is not ported")


def _chain_context(font, b, s, glyphs, i):
    fmt = _u16(b, s)
    g = glyphs[i]
    if fmt == 1:
        cov = _coverage(b, s + _u16(b, s + 2))
        if g not in cov:
            return None
        rs = s + _u16(b, s + 6 + 2 * cov[g])
        for k in range(_u16(b, rs)):
            r = rs + _u16(b, rs + 2 + 2 * k)
            m = _chain_rule(b, r, glyphs, i, lambda x: x, lambda x: x, lambda x: x)
            if m is not None:
                return _apply_records(font, glyphs, i, *m)
        return None
    if fmt == 2:
        cov = _coverage(b, s + _u16(b, s + 2))
        if g not in cov:
            return None
        back = _class_def(b, s + _u16(b, s + 4))
        inp = _class_def(b, s + _u16(b, s + 6))
        ahead = _class_def(b, s + _u16(b, s + 8))
        n_sets = _u16(b, s + 10)
        c = inp.get(g, 0)
        if c >= n_sets:
            return None
        off = _u16(b, s + 12 + 2 * c)
        if not off:
            return None
        rs = s + off
        for k in range(_u16(b, rs)):
            r = rs + _u16(b, rs + 2 + 2 * k)
            m = _chain_rule(b, r, glyphs, i, lambda x: back.get(x, 0), lambda x: inp.get(x, 0),
                            lambda x: ahead.get(x, 0))
            if m is not None:
                return _apply_records(font, glyphs, i, *m)
        return None
    # format 3: coverage tables per position
    o = s + 2
    nb = _u16(b, o)
    back = [_coverage(b, s + _u16(b, o + 2 + 2 * j)) for j in range(nb)]
    o += 2 + 2 * nb
    ni = _u16(b, o)
    inp = [_coverage(b, s + _u16(b, o + 2 + 2 * j)) for j in range(ni)]
    o += 2 + 2 * ni
    na = _u16(b, o)
    ahead = [_coverage(b, s + _u16(b, o + 2 + 2 * j)) for j in range(na)]
    o += 2 + 2 * na
    if i - nb < 0 or i + ni + na > len(glyphs):
        return None
    if not all(glyphs[i - 1 - j] in back[j] for j in range(nb)):
        return None
    if not all(glyphs[i + j] in inp[j] for j in range(ni)):
        return None
    if not all(glyphs[i + ni + j] in ahead[j] for j in range(na)):
        return None
    recs = [struct.unpack_from(">HH", b, o + 2 + 4 * j) for j in range(_u16(b, o))]
    return _apply_records(font, glyphs, i, ni, recs)


def _chain_rule(b, r, glyphs, i, cb, ci, ca):
    nb = _u16(b, r)
    back = [_u16(b, r + 2 + 2 * j) for j in range(nb)]
    o = r + 2 + 2 * nb
    ni = _u16(b, o)
    inp = [_u16(b, o + 2 + 2 * j) for j in range(ni - 1)]
    o += 2 + 2 * (ni - 1)
    na = _u16(b, o)
    ahead = [_u16(b, o + 2 + 2 * j) for j in range(na)]
    o += 2 + 2 * na
    if i - nb < 0 or i + ni + na > len(glyphs):
        return None
    if any(cb(glyphs[i - 1 - j]) != back[j] for j in range(nb)):
        return None
    if any(ci(glyphs[i + 1 + j]) != inp[j] for j in range(ni - 1)):
        return None
    if any(ca(glyphs[i + ni + j]) != ahead[j] for j in range(na)):
        return None
    recs = [struct.unpack_from(">HH", b, o + 2 + 4 * j) for j in range(_u16(b, o))]
    return ni, recs


def _apply_records(font, glyphs, i, n_input, recs):
    out = list(glyphs)
    for seq, li in recs:
        typ, _, subs = font.lookup("GSUB", li)
        if typ != 1:
            raise NotImplementedError(f"{font.name}: a chained GSUB lookup of type {typ} "
                                      "applies to this text; it is not ported")
        for s in subs:
            res = _gsub_at(font, font.gsub["data"], typ, s, out, i + seq, li)
            if res is not None:
                out = res[0]
                break
    return out, n_input


def _pair_adjust(font: Font, lookups: tuple, left: int, right: int) -> int:
    """The first glyph's XAdvance adjustment (font units) of the kern
    lookups for the pair (left, right)."""
    b = font.gpos["data"]
    total = 0
    for li in lookups:
        typ, _, subs = font.lookup("GPOS", li)
        if typ != 2:
            continue
        for s in subs:
            fmt = _u16(b, s)
            cov = _coverage(b, s + _u16(b, s + 2))
            if left not in cov:
                continue
            vf1, vf2 = _u16(b, s + 4), _u16(b, s + 6)
            v1 = None
            if fmt == 1:
                ps = s + _u16(b, s + 10 + 2 * cov[left])
                size = 2 + _value_size(vf1) + _value_size(vf2)
                for k in range(_u16(b, ps)):
                    rec = ps + 2 + size * k
                    if _u16(b, rec) == right:
                        v1 = _value_record(b, rec + 2, vf1)
                        v2 = _value_record(b, rec + 2 + _value_size(vf1), vf2)
                        break
            else:
                c1 = _class_def(b, s + _u16(b, s + 8)).get(left, 0)
                c2 = _class_def(b, s + _u16(b, s + 10)).get(right, 0)
                n2 = _u16(b, s + 14)
                size = _value_size(vf1) + _value_size(vf2)
                rec = s + 16 + (c1 * n2 + c2) * size
                v1 = _value_record(b, rec, vf1)
                v2 = _value_record(b, rec + _value_size(vf1), vf2)
            if v1 is None:
                continue
            if any(v1.get(k) for k in _VALUE_FIELDS if k != "XAdvance") or any(v2.values()):
                raise NotImplementedError(f"{font.name}: a kern pair that moves more than the "
                                          "first glyph's advance is not ported")
            total += v1.get("XAdvance", 0)
            break
    return total


def shape(font: Font, text: str, kerning: bool = True) -> tuple:
    """(glyph ids, kern adjustments in font units, one per glyph: the
    advance added after it; None for a hidden glyph, which has no advance)
    of `text` as raqm shapes it with `font`."""
    script = check_text(text)
    glyphs = [font.cmap.get(ord(ch), 0) for ch in text]
    if font.gsub is not None:
        glyphs = _apply_gsub(font, glyphs, script)
    kern = [0] * len(glyphs)
    # HarfBuzz hides default-ignorable characters (the soft hyphen, zero-
    # width spaces and joiners): the space glyph with no advance
    hidden = [i for i, ch in enumerate(text) if is_default_ignorable(ch)]
    if hidden and len(glyphs) != len(text):
        raise NotImplementedError("default-ignorable characters inside a ligature are not "
                                  "ported")
    if kerning and len(glyphs) > 1:
        if font.gpos is not None:
            lookups = font.feature_lookups("GPOS", script, ("kern",))
            for i in range(len(glyphs) - 1):
                kern[i] = _pair_adjust(font, lookups, glyphs[i], glyphs[i + 1])
        else:
            for i in range(len(glyphs) - 1):
                kern[i] = font.kern_pairs.get((glyphs[i], glyphs[i + 1]), 0)
    space = font.cmap.get(0x20, 0)
    for i in hidden:
        glyphs[i], kern[i] = space, None
    return glyphs, kern


def is_default_ignorable(ch: str) -> bool:
    """Unicode's Default_Ignorable_Code_Point, as HarfBuzz hides it."""
    c = ord(ch)
    return (c in (0x00AD, 0x034F, 0x061C, 0x115F, 0x1160, 0x17B4, 0x17B5, 0x3164, 0xFEFF,
                  0xFFA0) or 0x180B <= c <= 0x180F or 0x200B <= c <= 0x200F
            or 0x202A <= c <= 0x202E or 0x2060 <= c <= 0x206F or 0xFE00 <= c <= 0xFE0F
            or 0xFFF0 <= c <= 0xFFF8 or 0xE0000 <= c <= 0xE0FFF)
