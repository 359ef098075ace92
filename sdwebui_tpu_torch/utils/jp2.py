"""The JP2 file format (ISO 15444-1 annex I) as Pillow's
``Jpeg2KImagePlugin`` and OpenJPEG read it, and the boxes OpenJPEG writes.

Reading follows Pillow's ``_parse_jp2_header``: the boxes up to ``jp2h``,
then in ``jp2h``: ``ihdr`` (size,
components, depth: mode L, I;16, LA, RGB or RGBA), ``colr`` (CMYK for four
components in enumerated space 12), ``pclr`` after an L / LA header (mode P
or PA, its palette when no entry is deeper than 8 bits) and ``res `` /
``resc`` (``info["dpi"]``).  OpenJPEG gives the colour space of ``colr``'s
enumeration (16 sRGB, 17 greyscale, 18 sYCC, 12 CMYK; anything else, or an
ICC profile, is unknown).  Pillow asks OpenJPEG not to apply ``pclr``,
``cmap`` or ``cdef``, so the components stay in codestream order.

Writing: the signature, ``ftyp`` (brand and compatibility ``jp2 ``),
``jp2h`` with ``ihdr``, ``colr`` (enumerated sRGB or greyscale) and, for an
image with alpha, ``cdef``, then ``jp2c``, as OpenJPEG writes them for
Pillow."""

from __future__ import annotations

import struct
from dataclasses import dataclass

from sdwebui_tpu_torch.utils.image_modes import NotThisFormat

SIGNATURE = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"

#: OpenJPEG's OPJ_CLRSPC_* for colr's enumerated colour spaces
SPACES = {16: "sRGB", 17: "grey", 18: "sYCC", 12: "CMYK", 24: "eYCC"}


@dataclass
class Header:
    width: int
    height: int
    mode: str
    dpi: tuple | None = None
    palette: list | None = None          # [(r, g, b[, a])] as Pillow collects it
    space: str = "unknown"
    codestream: int = 0                  # offset of the codestream


def _boxes(data: bytes, start: int, end: int, strict: bool):
    """(type, payload start, payload end) of the boxes in [start, end);
    `strict`: Pillow's checks on the box lengths (a ``SyntaxError``)."""
    o = start
    while o < end:
        if o + 8 > end:
            if strict:
                raise NotThisFormat("Not enough data in header")
            return
        lbox, tbox = struct.unpack_from(">I4s", data, o)
        hlen = 8
        if lbox == 1:
            if o + 16 > end:
                raise NotThisFormat("Not enough data in header")
            lbox = struct.unpack_from(">Q", data, o + 8)[0]
            hlen = 16
        elif lbox == 0:
            lbox = end - o
        if lbox < hlen or o + lbox > end:
            if strict:
                raise NotThisFormat("Invalid header length")
            lbox = end - o
        yield tbox, o + hlen, o + lbox
        o += lbox


def _res_to_dpi(num, denom, exp):
    if denom == 0:
        return None
    return (254 * num * (10 ** exp)) / (10000 * denom)


def read_header(data: bytes) -> Header:
    """Pillow's ``_parse_jp2_header`` and the codestream's offset."""
    header = None
    end = len(data)
    o = 12
    codestream = None
    for tbox, a, b in _boxes(data, 12, end, strict=True):
        if tbox == b"jp2h":
            header = (a, b)
            o = b
            break
    if header is None:
        raise ValueError("a JP2 file without a jp2h box")
    size = mode = None
    nc = bpc = None
    dpi = None
    palette = None
    space = "unknown"
    for tbox, a, b in _boxes(data, header[0], header[1], strict=True):
        if tbox == b"ihdr":
            if b - a < 11:
                raise NotThisFormat("Not enough data in header")
            height, width, nc, bpc = struct.unpack_from(">IIHB", data, a)
            size = (width, height)
            mode = {1: "I;16" if (bpc & 0x7F) > 8 else "L", 2: "LA", 3: "RGB",
                    4: "RGBA"}.get(nc, mode)
        elif tbox == b"colr":
            if b - a >= 7:
                meth, _, _, enumcs = struct.unpack_from(">BBBI", data, a)
                if meth == 1:
                    space = SPACES.get(enumcs, "unknown")
                if nc == 4 and meth == 1 and enumcs == 12:
                    mode = "CMYK"
            elif nc == 4:
                raise NotThisFormat("Not enough data in header")
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = struct.unpack_from(">HB", data, a)
            depths = data[a + 3:a + 3 + npc]
            if max(depths, default=0) <= 8:
                colors = []
                q = a + 3 + npc
                for _ in range(ne):
                    colors.append(tuple(data[q:q + npc]))
                    q += npc
                palette = []
                for col in colors:         # ImagePalette.getcolor: first occurrence
                    if col not in palette:
                        palette.append(col)
                mode = "P" if mode == "L" else "PA"
                palette = (palette, npc)
        elif tbox == b"res ":
            for tres, c, d in _boxes(data, a, b, strict=True):
                if tres == b"resc":
                    vrcn, vrcd, hrcn, hrcd, vrce, hrce = struct.unpack_from(">HHHHBB", data, c)
                    hres = _res_to_dpi(hrcn, hrcd, hrce)
                    vres = _res_to_dpi(vrcn, vrcd, vrce)
                    if hres is not None and vres is not None:
                        dpi = (hres, vres)
                    break
    if size is None or mode is None:
        raise NotThisFormat("Malformed JP2 header")
    for tbox, a, b in _boxes(data, o, end, strict=False):
        if tbox == b"jp2c":
            codestream = a
            break
    if codestream is None:
        raise ValueError("a JP2 file without a codestream box")
    return Header(size[0], size[1], mode, dpi, palette, space, codestream)


def box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(payload), kind) + payload


def wrap(codestream: bytes, width: int, height: int, channels: int, prec: int = 8) -> bytes:
    """The JP2 file OpenJPEG writes around a codestream of `channels`
    8-bit components (L, LA, RGB, RGBA)."""
    ihdr = box(b"ihdr", struct.pack(">IIHBBBB", height, width, channels, prec - 1, 7, 0, 0))
    enumcs = 17 if channels <= 2 else 16
    colr = box(b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs))
    cdef = b""
    if channels in (2, 4):
        colour = channels - 1
        entries = [(k, 0, k + 1) for k in range(colour)] + [(colour, 1, 0)]
        cdef = box(b"cdef", struct.pack(">H", channels) +
                   b"".join(struct.pack(">HHH", *e) for e in entries))
    return (SIGNATURE + box(b"ftyp", b"jp2 \x00\x00\x00\x00jp2 ") +
            box(b"jp2h", ihdr + colr + cdef) + box(b"jp2c", codestream))
