"""The JPEG 2000 codestream (ISO 15444-1 annex A): its markers read as
OpenJPEG 2.5 reads them, and written as OpenJPEG writes them.

Reading: SOC, SIZ (image and tile offsets, component precision, sign and
subsampling), CAP (Part 15 refused), COD / COC, QCD / QCC, RGN, POC,
PPM / PPT, TLM / PLM / PLT (skipped), CRG (no effect on the samples), COM
(the first one is Pillow's ``info["comment"]``), SOT / SOD per tile-part,
EOC.  A main or tile-part COD (QCD) applies to every component of its
scope, as OpenJPEG copies it; a COC (QCC) then to its own.  A SIZ of more
than twice Pillow's ``MAX_IMAGE_PIXELS`` raises before anything is
allocated, as ``Image.open`` does; a tile-part that runs past the
codestream raises.

Writing: the main header OpenJPEG writes for Pillow's defaults (SIZ, COD,
QCD, its COM), and every marker the fixture tool asks for."""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from sdwebui_tpu_torch.utils.png import MAX_IMAGE_PIXELS

SOC, CAP, SIZ, COD, COC, QCD, QCC, RGN, POC, PPM, PPT, COM = (
    0xFF4F, 0xFF50, 0xFF51, 0xFF52, 0xFF53, 0xFF5C, 0xFF5D, 0xFF5E, 0xFF5F, 0xFF60, 0xFF61,
    0xFF64)
SOT, SOD, EOC = 0xFF90, 0xFF93, 0xFFD9

#: OpenJPEG's version string in the COM marker it writes
OPENJPEG_COMMENT = b"Created by OpenJPEG version 2.5.4"


class CodestreamError(ValueError):
    """A codestream the decoder cannot read (truncated or inconsistent)."""


@dataclass
class Component:
    prec: int
    sgnd: bool
    dx: int
    dy: int


@dataclass
class CodingStyle:
    """Per component: COD/COC's SPcod and QCD/QCC's quantization."""
    levels: int = 5
    cblkw: int = 6          # exponents (the marker stores them minus 2)
    cblkh: int = 6
    cblksty: int = 0
    reversible: bool = True
    precincts: list = field(default_factory=list)   # (PPx, PPy) per resolution
    qntsty: int = 0
    guard: int = 2
    steps: list = field(default_factory=list)        # (expn, mant) per band as signalled
    roishift: int = 0

    def copy(self) -> "CodingStyle":
        return CodingStyle(self.levels, self.cblkw, self.cblkh, self.cblksty, self.reversible,
                           list(self.precincts), self.qntsty, self.guard, list(self.steps),
                           self.roishift)

    def precinct(self, r: int) -> tuple[int, int]:
        return self.precincts[r] if r < len(self.precincts) else (15, 15)

    def step(self, b: int) -> tuple[int, int]:
        """(expn, mant) of band index b (0 LL, then 3·(r − 1) + orient)."""
        if self.qntsty == 1:
            e0, m0 = self.steps[0]
            return max(e0 - (b - 1) // 3, 0) if b else e0, m0
        if b >= len(self.steps):
            raise CodestreamError("a quantization marker with too few bands")
        return self.steps[b]


@dataclass
class TileCoding:
    """A tile's COD-level fields and its components' styles."""
    csty: int = 0            # Scod: 1 precincts, 2 SOP, 4 EPH
    progression: int = 0
    layers: int = 1
    mct: int = 0
    comps: list = field(default_factory=list)
    pocs: list = field(default_factory=list)   # (rs, cs, lye, re, ce, order)

    def copy(self) -> "TileCoding":
        return TileCoding(self.csty, self.progression, self.layers, self.mct,
                          [c.copy() for c in self.comps], list(self.pocs))


@dataclass
class Codestream:
    xsiz: int
    ysiz: int
    xosiz: int
    yosiz: int
    xtsiz: int
    ytsiz: int
    xtosiz: int
    ytosiz: int
    comps: list
    rsiz: int = 0
    coding: TileCoding = None
    comment: bytes | None = None
    ppm: bytes | None = None
    tiles: dict = field(default_factory=dict)      # index → TileData

    @property
    def numxtiles(self) -> int:
        return -(-(self.xsiz - self.xtosiz) // self.xtsiz)

    @property
    def numytiles(self) -> int:
        return -(-(self.ysiz - self.ytosiz) // self.ytsiz)


@dataclass
class TileData:
    coding: TileCoding
    parts: list = field(default_factory=list)        # tile-part bodies in order
    ppt: list = field(default_factory=list)          # (Zppt, bytes)
    ppm_parts: list = field(default_factory=list)    # packed headers per tile-part (PPM)


def _u16(b, o):
    return struct.unpack_from(">H", b, o)[0]


def _u32(b, o):
    return struct.unpack_from(">I", b, o)[0]


def read_siz(seg: bytes) -> Codestream:
    if len(seg) < 36:
        raise CodestreamError("a SIZ marker too short")
    rsiz, xsiz, ysiz, xo, yo, xt, yt, xto, yto, csiz = struct.unpack_from(">HIIIIIIIIH", seg, 0)
    if xsiz <= xo or ysiz <= yo or xt == 0 or yt == 0 or csiz == 0 or xto > xo or yto > yo \
            or xto + xt <= xo or yto + yt <= yo:
        raise CodestreamError("a SIZ marker with an empty image or tile grid")
    if len(seg) < 36 + 3 * csiz:
        raise CodestreamError("a SIZ marker too short for its components")
    comps = []
    for c in range(csiz):
        s, dx, dy = seg[36 + 3 * c:39 + 3 * c]
        if dx == 0 or dy == 0:
            raise CodestreamError("a component with zero subsampling")
        comps.append(Component((s & 0x7F) + 1, bool(s & 0x80), dx, dy))
    pixels = (xsiz - xo) * (ysiz - yo)
    if pixels > 2 * MAX_IMAGE_PIXELS:
        raise ValueError(f"Image size ({pixels} pixels) exceeds limit of "
                         f"{2 * MAX_IMAGE_PIXELS} pixels, could be decompression bomb DOS attack.")
    if any(c.prec > 16 for c in comps):
        raise CodestreamError("a component of more than 16 bits")
    return Codestream(xsiz, ysiz, xo, yo, xt, yt, xto, yto, comps, rsiz)


def _read_spcod(seg, o, style: CodingStyle, with_precincts: bool):
    if len(seg) < o + 5:
        raise CodestreamError("a COD/COC marker too short")
    levels, xcb, ycb, sty, tr = seg[o:o + 5]
    if levels > 32 or xcb > 8 or ycb > 8 or xcb + ycb > 8:
        raise CodestreamError("a COD/COC marker with impossible sizes")
    if sty & 0x40:
        from sdwebui_tpu_torch.utils.image_io import UnsupportedImageFormat
        raise UnsupportedImageFormat("HTJ2K (JPEG 2000 Part 15)")
    if tr > 1:
        raise CodestreamError("a wavelet transform other than 5/3 or 9/7 (Part 2)")
    style.levels, style.cblkw, style.cblkh, style.cblksty = levels, xcb + 2, ycb + 2, sty
    style.reversible = tr == 1
    o += 5
    if with_precincts:
        if len(seg) < o + levels + 1:
            raise CodestreamError("a COD/COC marker too short for its precincts")
        style.precincts = [(b & 15, b >> 4) for b in seg[o:o + levels + 1]]
        o += levels + 1
    else:
        style.precincts = []
    return o


def _read_sqcd(seg, o, style: CodingStyle):
    if len(seg) < o + 1:
        raise CodestreamError("a QCD/QCC marker too short")
    s = seg[o]
    style.qntsty, style.guard = s & 31, s >> 5
    o += 1
    if style.qntsty == 0:
        style.steps = [(b >> 3, 0) for b in seg[o:]]
    elif style.qntsty in (1, 2):
        n = (len(seg) - o) // 2
        if n == 0:
            raise CodestreamError("a QCD/QCC marker with no step size")
        vals = struct.unpack_from(f">{n}H", seg, o)
        style.steps = [(v >> 11, v & 0x7FF) for v in vals]
        if style.qntsty == 1:
            style.steps = style.steps[:1]
    else:
        raise CodestreamError("an unknown quantization style")


def _comp_index(seg, o, ncomp):
    if ncomp < 257:
        return seg[o], o + 1
    return _u16(seg, o), o + 2


def _apply(marker, seg, cs: Codestream, coding: TileCoding):
    n = len(cs.comps)
    if marker == COD:
        if len(seg) < 5:
            raise CodestreamError("a COD marker too short")
        coding.csty = seg[0]
        coding.progression, coding.layers, coding.mct = seg[1], _u16(seg, 2), seg[4]
        if coding.progression > 4 or coding.layers == 0:
            raise CodestreamError("a COD marker with no layers or an unknown progression")
        style = coding.comps[0].copy() if coding.comps else CodingStyle()
        _read_spcod(seg, 5, style, bool(coding.csty & 1))
        for c in coding.comps:
            (c.levels, c.cblkw, c.cblkh, c.cblksty, c.reversible, c.precincts) = (
                style.levels, style.cblkw, style.cblkh, style.cblksty, style.reversible,
                list(style.precincts))
    elif marker == COC:
        c, o = _comp_index(seg, 0, n)
        if c >= n:
            raise CodestreamError("a COC marker for a missing component")
        scoc = seg[o]
        _read_spcod(seg, o + 1, coding.comps[c], bool(scoc & 1))
    elif marker == QCD:
        style = CodingStyle()
        _read_sqcd(seg, 0, style)
        for c in coding.comps:
            c.qntsty, c.guard, c.steps = style.qntsty, style.guard, list(style.steps)
    elif marker == QCC:
        c, o = _comp_index(seg, 0, n)
        if c >= n:
            raise CodestreamError("a QCC marker for a missing component")
        _read_sqcd(seg, o, coding.comps[c])
    elif marker == RGN:
        c, o = _comp_index(seg, 0, n)
        if c >= n or len(seg) < o + 2:
            raise CodestreamError("a bad RGN marker")
        if seg[o] != 0:
            raise CodestreamError("an RGN style other than max-shift")
        coding.comps[c].roishift = seg[o + 1]
    elif marker == POC:
        step = 7 if n < 257 else 9
        pocs = []
        o = 0
        while o + step <= len(seg):
            rs = seg[o]
            cs_, o2 = _comp_index(seg, o + 1, n)
            lye = _u16(seg, o2)
            re_ = seg[o2 + 2]
            ce, o3 = _comp_index(seg, o2 + 3, n)
            order = seg[o3]
            if order > 4:
                raise CodestreamError("a POC marker with an unknown progression")
            pocs.append((rs, cs_, lye, re_, ce if ce else 256, order))
            o += step
        coding.pocs = pocs


def read(data: bytes) -> Codestream:
    """Parse a codestream: main header, then every tile-part."""
    if data[:2] != b"\xff\x4f" or data[2:4] != b"\xff\x51":
        raise CodestreamError("not a JPEG 2000 codestream")
    lsiz = _u16(data, 4)
    cs = read_siz(data[6:4 + lsiz])
    coding = TileCoding(comps=[CodingStyle() for _ in cs.comps])
    have_cod = have_qcd = False
    o = 4 + lsiz
    ppm = {}
    while True:
        if o + 4 > len(data):
            raise CodestreamError("a codestream that ends in its main header")
        marker = _u16(data, o)
        if marker == SOT or marker == EOC:
            break
        if marker < 0xFF30:
            raise CodestreamError(f"no marker where one is due ({marker:04x})")
        seglen = _u16(data, o + 2)
        seg = data[o + 4:o + 2 + seglen]
        if len(seg) < seglen - 2 or seglen < 2:
            raise CodestreamError("a marker that runs past the codestream")
        if marker == CAP:
            pcap = _u32(seg, 0) if len(seg) >= 4 else 0
            if pcap & (1 << (32 - 15)):
                from sdwebui_tpu_torch.utils.image_io import UnsupportedImageFormat
                raise UnsupportedImageFormat("HTJ2K (JPEG 2000 Part 15)")
        elif marker == COM:
            if cs.comment is None and len(seg) >= 2:
                cs.comment = bytes(seg[2:])
        elif marker == PPM:
            ppm[seg[0]] = bytes(seg[1:])
        else:
            if marker == COD:
                have_cod = True
            if marker == QCD:
                have_qcd = True
            _apply(marker, seg, cs, coding)
        o += 2 + seglen
    if not (have_cod and have_qcd):
        raise CodestreamError("a main header without COD or QCD")
    cs.coding = coding
    if ppm:
        cs.ppm = b"".join(ppm[k] for k in sorted(ppm))
    ntiles = cs.numxtiles * cs.numytiles
    order = []
    while o + 2 <= len(data):
        marker = _u16(data, o)
        if marker == EOC:
            break
        if marker != SOT:
            raise CodestreamError(f"no SOT where a tile-part is due ({marker:04x})")
        if o + 12 > len(data):
            raise CodestreamError("a tile-part that runs past the codestream")
        _, isot, psot = struct.unpack_from(">HHI", data, o + 2)
        if isot >= ntiles:
            raise CodestreamError("a tile-part of a missing tile")
        end = o + psot if psot else len(data) - (2 if data[-2:] == b"\xff\xd9" else 0)
        if end > len(data):
            raise CodestreamError("a tile-part that runs past the codestream")
        tile = cs.tiles.get(isot)
        if tile is None:
            tile = cs.tiles[isot] = TileData(coding.copy())
        p = o + 12
        ppt = []
        while True:
            if p + 2 > end:
                raise CodestreamError("a tile-part header that runs past its tile-part")
            m = _u16(data, p)
            if m == SOD:
                p += 2
                break
            seglen = _u16(data, p + 2)
            seg = data[p + 4:p + 2 + seglen]
            if p + 2 + seglen > end:
                raise CodestreamError("a marker that runs past its tile-part")
            if m == PPT:
                ppt.append((seg[0], bytes(seg[1:])))
            elif m in (COD, COC, QCD, QCC, RGN, POC):
                _apply(m, seg, cs, tile.coding)
            p += 2 + seglen
        tile.parts.append(bytes(data[p:end]))
        tile.ppt.extend(ppt)
        order.append(isot)
        o = end
    if cs.ppm is not None:
        q = 0
        for isot in order:
            if q + 4 > len(cs.ppm):
                raise CodestreamError("a PPM marker shorter than its tile-parts")
            nppm = _u32(cs.ppm, q)
            cs.tiles[isot].ppm_parts.append(cs.ppm[q + 4:q + 4 + nppm])
            q += 4 + nppm
    return cs


# -- writing


def marker(code: int, body: bytes) -> bytes:
    return struct.pack(">HH", code, len(body) + 2) + body


def siz(width, height, comps, x0=0, y0=0, tw=None, th=None, tx0=0, ty0=0, rsiz=0) -> bytes:
    """SIZ for components ``[(prec, sgnd, dx, dy)]``."""
    tw = tw or width
    th = th or height
    body = struct.pack(">HIIIIIIIIH", rsiz, width, height, x0, y0, tw, th, tx0, ty0, len(comps))
    for prec, sgnd, dx, dy in comps:
        body += bytes([(prec - 1) | (0x80 if sgnd else 0), dx, dy])
    return marker(SIZ, body)


def spcod(levels, cblkw, cblkh, cblksty, reversible, precincts=None) -> bytes:
    b = bytes([levels, cblkw - 2, cblkh - 2, cblksty, 1 if reversible else 0])
    if precincts:
        b += bytes(ppx | (ppy << 4) for ppx, ppy in precincts)
    return b


def cod(csty, progression, layers, mct, sp: bytes) -> bytes:
    return marker(COD, bytes([csty, progression]) + struct.pack(">H", layers) +
                  bytes([mct]) + sp)


def qcd_none(guard: int, expns: list, code: int = QCD, comp: bytes = b"") -> bytes:
    return marker(code, comp + bytes([guard << 5]) + bytes(e << 3 for e in expns))


def com(text: bytes) -> bytes:
    return marker(COM, b"\x00\x01" + text)


def sot(index: int, length: int, part: int = 0, parts: int = 1) -> bytes:
    return struct.pack(">HHHIBB", SOT, 10, index, length, part, parts)
