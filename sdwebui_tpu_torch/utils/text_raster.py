"""Text as Pillow 12 draws it with FreeType: layout, boxes and glyph masks.

Restates, for one line of text:

- FreeType's smooth (gray) rasterizer (``ftgrays.c``): the outline
  decomposed as ``FT_Outline_Decompose`` does (implied on-curve points at
  the truncated midpoints), conic arcs split by forward differences into
  2^k lines, each line's exact area and cover per cell at 1/256 px, and
  the sweep's non-zero fill rule to 0–255;
- Pillow's layout (``_imagingft.c``): with raqm, pen positions in 26.6 from
  the linear advances (``FT_MulFix`` of hmtx) and HarfBuzz's GPOS kerning;
  with basic layout (the default font), the hinted advances and the legacy
  ``kern`` table; each glyph placed at its rounded pen position; the
  anchors ``la``, ``ls`` and ``mm``; ``getlength``, ``getbbox`` and the
  mask ``getmask2`` renders, each glyph composited over the ones before it;
- ``ImageDraw.text`` on an RGB image: the integer part of the start point
  plus the mask's offset, the fraction passed to the render, and the mask
  blended with the ink as ``draw_bitmap`` blends it; ``ImageDraw.line``
  of a horizontal wide line.

Pillow's Python side (``PIL/ImageDraw.py``, ``PIL/ImageText.py``,
``PIL/ImageFont.py``) is the spec for the arithmetic; the tests hold every
box and mask to Pillow itself.  Glyph outlines come hinted from
``utils/truetype_hint.py``.  FreeType's auto-hinter, which it runs on a
TrueType font with no instructions, is not restated: the default font
(such a font) is drawn at its default size from a table of FreeType's
output (``load_default``), and a user's font with no instructions draws
its scaled outline.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from sdwebui_tpu_torch.utils import truetype as tt
from sdwebui_tpu_torch.utils import truetype_hint as th

FONT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "fonts")
DEJAVU_SANS = os.path.join(FONT_DIR, "DejaVuSans.ttf")
AILERON = os.path.join(FONT_DIR, "Aileron-Regular-subset.ttf")

PIXEL_BITS = 8
ONE_PIXEL = 1 << PIXEL_BITS
_M64 = (1 << 64) - 1


def pixel(x: int) -> int:
    """Pillow's PIXEL(): a 26.6 value rounded to whole pixels."""
    return (x + 32) >> 6


# --------------------------------------------------------------------------
# the gray rasterizer
# --------------------------------------------------------------------------

class _Raster:
    """``ftgrays.c``'s cell accumulation for one outline (coordinates in
    1/256 px)."""

    def __init__(self):
        self.cells = {}
        self.ex = self.ey = 0
        self.x = self.y = 0

    def _add(self, area: int, cover: int):
        k = (self.ex, self.ey)
        a, c = self.cells.get(k, (0, 0))
        self.cells[k] = (a + area, c + cover)

    def move_to(self, x: int, y: int):
        self.ex, self.ey = x >> PIXEL_BITS, y >> PIXEL_BITS
        self.x, self.y = x, y

    def line_to(self, to_x: int, to_y: int):
        ex1, ex2 = self.x >> PIXEL_BITS, to_x >> PIXEL_BITS
        ey1, ey2 = self.y >> PIXEL_BITS, to_y >> PIXEL_BITS
        fx1, fy1 = self.x & (ONE_PIXEL - 1), self.y & (ONE_PIXEL - 1)
        dx, dy = to_x - self.x, to_y - self.y
        if ex1 == ex2 and ey1 == ey2:
            pass
        elif dy == 0:
            self.ex, self.ey = ex2, ey2
            self.x, self.y = to_x, to_y
            return
        elif dx == 0:
            if dy > 0:
                while True:
                    self._add((ONE_PIXEL - fy1) * fx1 * 2, ONE_PIXEL - fy1)
                    fy1 = 0
                    ey1 += 1
                    self.ey = ey1
                    if ey1 == ey2:
                        break
            else:
                while True:
                    self._add(-fy1 * fx1 * 2, -fy1)
                    fy1 = ONE_PIXEL
                    ey1 -= 1
                    self.ey = ey1
                    if ey1 == ey2:
                        break
        else:
            prod = dx * fy1 - dy * fx1
            rx = (_M64 >> PIXEL_BITS) // abs(dx) if ex1 != ex2 else 0
            ry = (_M64 >> PIXEL_BITS) // abs(dy) if ey1 != ey2 else 0

            def udiv(a, r):
                return ((a * r) & _M64) >> (64 - PIXEL_BITS)

            while True:
                if prod - dx * ONE_PIXEL > 0 and prod <= 0:                       # left
                    fx2, fy2 = 0, udiv(-prod, rx)
                    prod -= dy * ONE_PIXEL
                    self._add((fy2 - fy1) * (fx1 + fx2), fy2 - fy1)
                    fx1, fy1 = ONE_PIXEL, fy2
                    ex1 -= 1
                elif prod - dx * ONE_PIXEL + dy * ONE_PIXEL > 0 \
                        and prod - dx * ONE_PIXEL <= 0:                           # up
                    prod -= dx * ONE_PIXEL
                    fx2, fy2 = udiv(-prod, ry), ONE_PIXEL
                    self._add((fy2 - fy1) * (fx1 + fx2), fy2 - fy1)
                    fx1, fy1 = fx2, 0
                    ey1 += 1
                elif prod + dy * ONE_PIXEL >= 0 \
                        and prod - dx * ONE_PIXEL + dy * ONE_PIXEL <= 0:          # right
                    prod += dy * ONE_PIXEL
                    fx2, fy2 = ONE_PIXEL, udiv(prod, rx)
                    self._add((fy2 - fy1) * (fx1 + fx2), fy2 - fy1)
                    fx1, fy1 = 0, fy2
                    ex1 += 1
                else:                                                             # down
                    fx2, fy2 = udiv(prod, ry), 0
                    prod += dx * ONE_PIXEL
                    self._add((fy2 - fy1) * (fx1 + fx2), fy2 - fy1)
                    fx1, fy1 = fx2, ONE_PIXEL
                    ey1 -= 1
                self.ex, self.ey = ex1, ey1
                if ex1 == ex2 and ey1 == ey2:
                    break
        fx2, fy2 = to_x & (ONE_PIXEL - 1), to_y & (ONE_PIXEL - 1)
        self._add((fy2 - fy1) * (fx1 + fx2), fy2 - fy1)
        self.x, self.y = to_x, to_y

    def conic_to(self, cx: int, cy: int, to_x: int, to_y: int):
        p0x, p0y = self.x, self.y
        bx, by = cx - p0x, cy - p0y
        ax, ay = to_x - cx - bx, to_y - cy - by
        d = max(abs(ax), abs(ay))
        if d <= ONE_PIXEL // 4:
            self.line_to(to_x, to_y)
            return
        shift = 16
        while True:
            d >>= 2
            shift -= 1
            if d <= ONE_PIXEL // 4:
                break
        rx, ry = ax << (2 * shift), ay << (2 * shift)
        qx, qy = (bx << (shift + 17)) + rx, (by << (shift + 17)) + ry
        rx, ry = rx * 2, ry * 2
        px, py = p0x << 32, p0y << 32
        for _ in range(1 << (16 - shift)):
            px += qx
            py += qy
            qx += rx
            qy += ry
            self.line_to(px >> 32, py >> 32)

    def sweep(self, width: int, height: int) -> np.ndarray:
        """The bitmap, top row first, from the cells (non-zero fill)."""
        out = np.zeros((height, width), np.uint8)
        rows = {}
        for (x, y), v in self.cells.items():
            rows.setdefault(y, []).append((x, v))

        def cov(area: int) -> int:
            c = area >> (PIXEL_BITS * 2 + 1 - 8)
            if c < 0:
                c = ~c
            return 255 if c > 255 else c

        for y, cells in rows.items():
            if not 0 <= y < height:
                continue
            line = out[height - 1 - y]
            cells.sort()
            x, cover = 0, 0
            for cx, (area, c) in cells:
                if cover != 0 and cx > x:
                    line[max(x, 0):max(min(cx, width), 0)] = cov(cover)
                cover += c * (ONE_PIXEL * 2)
                a = cover - area
                if a != 0 and 0 <= cx < width:
                    line[cx] = cov(a)
                x = cx + 1
            if cover != 0 and x < width:
                line[max(x, 0):] = cov(cover)
        return out


def _decompose(r: _Raster, pts, on, ends):
    """FT_Outline_Decompose into the raster (points already shifted)."""
    first = 0
    for last in ends:
        if last < first:
            continue
        start = pts[first]
        i, limit = first, last
        if not on[first]:
            if on[last]:
                start = pts[last]
                limit = last - 1
            else:
                start = (int((pts[first][0] + pts[last][0]) / 2),
                         int((pts[first][1] + pts[last][1]) / 2))
            i = first - 1
        r.move_to(start[0] << 2, start[1] << 2)
        closed = False
        while i < limit:
            i += 1
            if on[i]:
                r.line_to(pts[i][0] << 2, pts[i][1] << 2)
                continue
            ctrl = pts[i]
            while True:
                if i < limit:
                    i += 1
                    vec = pts[i]
                    if on[i]:
                        r.conic_to(ctrl[0] << 2, ctrl[1] << 2, vec[0] << 2, vec[1] << 2)
                        break
                    mid = (int((ctrl[0] + vec[0]) / 2), int((ctrl[1] + vec[1]) / 2))
                    r.conic_to(ctrl[0] << 2, ctrl[1] << 2, mid[0] << 2, mid[1] << 2)
                    ctrl = vec
                    continue
                r.conic_to(ctrl[0] << 2, ctrl[1] << 2, start[0] << 2, start[1] << 2)
                closed = True
                break
            if closed:
                break
        if not closed:
            r.line_to(start[0] << 2, start[1] << 2)
        first = last + 1


def cbox(points) -> tuple:
    """The control box (26.6) of an outline's points."""
    if not points:
        return (0, 0, 0, 0)
    xs = [p[0] for p in points]
    ys = [p[1] for p in points]
    return (min(xs), min(ys), max(xs), max(ys))


def render_outline(outline: th.Outline) -> tuple:
    """(bitmap uint8 (rows, width), left, top) as FT_Render_Glyph's smooth
    mode gives them: the control box floored and ceiled to pixels."""
    x0, y0, x1, y1 = cbox(outline.points)
    left, bottom = x0 >> 6, y0 >> 6
    right, top = (x1 + 63) >> 6, (y1 + 63) >> 6
    w, h = right - left, top - bottom
    if w <= 0 or h <= 0:
        return np.zeros((0, 0), np.uint8), left, top
    shifted = [(x - left * 64, y - bottom * 64) for x, y in outline.points]
    r = _Raster()
    _decompose(r, shifted, outline.on, outline.ends)
    return r.sweep(w, h), left, top


# --------------------------------------------------------------------------
# a font at a size, as Pillow's FreeTypeFont
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _font_file(path: str) -> tuple:
    with open(path, "rb") as f:
        data = f.read()
    font = tt.Font(data, os.path.basename(path))
    return font, th.Hinter(font)


class Face:
    """``ImageFont.truetype(path, size)`` (raqm layout) or, with
    basic=True, the default font's basic layout.  hinting / kerning False
    draw the unhinted outlines / lay out without kerning (what FreeType
    and raqm do with ``FT_LOAD_NO_HINTING`` and ``-kern``)."""

    def __init__(self, path: str, size: int, basic: bool = False, hinting: bool = True,
                 kerning: bool = True):
        if size <= 0:
            raise ValueError(f"font size must be greater than 0, not {size}")
        self.path, self.size, self.basic = path, int(size), basic
        self.hinting, self.kerning = hinting, kerning
        self.font, self.hinter = _font_file(path)
        self.ppem = self.size
        s = self.hinter.size(self.ppem)
        self.scale = s.scale
        f = self.font
        asc, desc = f.ascender, f.descender
        if asc == 0 and desc == 0 and f.typo is not None:
            asc, desc = f.typo
        # ft_recompute_scaled_metrics (GRID_FIT_METRICS): ascender ceiled,
        # descender floored
        self.ascender = (th.mulfix(asc, self.scale) + 63) & -64
        self.descender = th.mulfix(desc, self.scale) & -64
        self._glyphs = {}

    def glyph(self, gid: int) -> tuple:
        """(bitmap, left, top, cbox in pixels (x0, y0, x1, y1), hinted
        advance 26.6) of glyph gid."""
        g = self._glyphs.get(gid)
        if g is None:
            o = self.hinter.outline(gid, self.ppem, self.hinting)
            bm, left, top = render_outline(o)
            x0, y0, x1, y1 = cbox(o.points)
            box = (x0 >> 6, y0 >> 6, (x1 + 63) >> 6, (y1 + 63) >> 6) if o.points \
                else (0, 0, 0, 0)
            adv = (th.mulfix(int(self.font.advances[gid]), self.scale) + 32) & -64
            g = self._glyphs[gid] = (bm, left, top, box, adv)
        return g

    def layout(self, text: str) -> tuple:
        """(glyph ids, x advances in 26.6) of one line."""
        if "\n" in text:
            raise NotImplementedError("multiline text is not ported (each label line is drawn "
                                      "on its own)")
        if self.basic:
            gids = [self.font.cmap.get(ord(c), 0) for c in text]
            adv = [self.glyph(g)[4] for g in gids]
            for i in range(len(gids) - 1):
                k = self.font.kern_pairs.get((gids[i], gids[i + 1]), 0)
                if k:
                    adv[i] += pixel(th.mulfix(k, self.scale)) * 64
            return gids, adv
        gids, kern = tt.shape(self.font, text, self.kerning)
        x_mult = ((self.ppem * 64) << 16) // self.font.units_per_em
        adv = [0 if k is None else
               th.mulfix(int(self.font.advances[g]), self.scale) + ((k * x_mult + 32768) >> 16)
               for g, k in zip(gids, kern)]
        return gids, adv

    def getlength(self, text: str) -> float:
        return sum(self.layout(text)[1]) / 64

    def _box(self, gids, adv, anchor: str) -> tuple:
        """Pillow's bounding_box_and_anchors: (width, height, x_offset,
        y_offset)."""
        pos = x_min = x_max = y_min = y_max = 0
        for g, a in zip(gids, adv):
            px = pixel(pos)
            pos += a
            x_max = max(x_max, pixel(pos))
            b = self.glyph(g)[3]
            x_max = max(x_max, b[2] + px)
            x_min = min(x_min, b[0] + px)
            y_max = max(y_max, b[3])
            y_min = min(y_min, b[1])
        if len(anchor) != 2:
            raise ValueError("anchor must be a 2 character string")
        xa = {"l": 0, "m": pixel(int(pos / 2)) if gids else 0,
              "r": pixel(pos) if gids else 0}.get(anchor[0])
        ya = {"a": pixel(self.ascender), "t": y_max,
              "m": pixel(int((self.ascender + self.descender) / 2)), "s": 0, "b": y_min,
              "d": pixel(self.descender)}.get(anchor[1])
        if xa is None or ya is None:
            raise NotImplementedError(f"anchor {anchor!r} is not ported")
        if not gids:
            xa = ya = 0
        return x_max - x_min, y_max - y_min, -xa + x_min, -(-ya + y_max)

    def getbbox(self, text: str, anchor: str = "la") -> tuple:
        gids, adv = self.layout(text)
        w, h, xo, yo = self._box(gids, adv, anchor)
        return xo, yo, xo + w, yo + h

    def getmask2(self, text: str, anchor: str = "la", start=(0.0, 0.0)) -> tuple:
        """(mask uint8 (h, w), (x_offset, y_offset)) as ``font.render``."""
        gids, adv = self.layout(text)
        w, h, xo, yo = self._box(gids, adv, anchor)
        w += int(np.ceil(start[0]))
        h += int(np.ceil(start[1]))
        mask = np.zeros((max(h, 0), max(w, 0)), np.uint8)
        if not gids or w <= 0 or h <= 0:
            return mask, (xo, yo)
        x = y_max = x_min = 0
        for g, a in zip(gids, adv):
            px = pixel(x)
            b = self.glyph(g)[3]
            x_min = min(x_min, b[0] + px)
            y_max = max(y_max, b[3])
            x += a
        x = int(np.floor((-x_min + start[0]) * 64 + 0.5))
        y = int(np.floor((-y_max - start[1]) * 64 + 0.5))
        for g, a in zip(gids, adv):
            px, py = pixel(x), pixel(y)
            bm, left, top, _, _ = self.glyph(g)
            xx, yy = px + left, -(py + top)
            rows, cols = bm.shape
            x0, x1 = max(0, -xx), min(cols, w - xx)
            y0, y1 = max(0, -yy), min(rows, h - yy)
            if x1 > x0 and y1 > y0:
                # a glyph over the ones before it: src + dst·(255 − src) / 255
                tgt = mask[yy + y0:yy + y1, xx + x0:xx + x1]
                src = bm[y0:y1, x0:x1].astype(np.int32)
                t = tgt.astype(np.int32) * (255 - src) + 128
                tgt[...] = src + (((t >> 8) + t) >> 8)
            x += a
        return mask, (xo, yo)


@functools.lru_cache(maxsize=256)
def truetype(path: str, size: int) -> Face:
    """``ImageFont.truetype(path, size)`` with raqm layout (cached)."""
    return Face(path, size)


class _AtlasFace(Face):
    """A font whose glyphs come from a table of FreeType's own output
    (``fonts/aileron_10.npz``, written by
    ``tools/make_default_font_atlas.py``): each glyph's mask and offset
    from the pen at the baseline, its box and its advance."""

    def __init__(self, path: str, size: int, atlas: str):
        super().__init__(path, size, basic=True)
        with np.load(atlas) as z:
            gids, shapes, offsets = z["gids"], z["shapes"], z["offsets"]
            boxes, advances, flat = z["boxes"], z["advances"], z["masks"]
        at = 0
        for g, (h, w), (ox, oy), (bx0, by0, bx1, by1), adv in zip(
                gids.tolist(), shapes.tolist(), offsets.tolist(), boxes.tolist(),
                advances.tolist()):
            bm = flat[at:at + h * w].reshape(h, w)
            at += h * w
            # getbbox at "ls": (x0, -top, x1, -bottom) about the pen at the baseline
            self._glyphs[g] = (bm, ox, -oy, (bx0, -by1, bx1, -by0), adv)

    def glyph(self, gid: int) -> tuple:
        g = self._glyphs.get(gid)
        if g is None:
            raise ValueError(f"glyph {gid} is not in the default font's table")
        return g


@functools.lru_cache(maxsize=4)
def load_default(size: int | None = None) -> Face:
    """``ImageFont.load_default(size)``: the Aileron Regular subset with
    basic layout, 10 px when no size is given.  The subset has no TrueType
    instructions, so FreeType draws it through its auto-hinter, which is
    not restated: at 10 px its glyphs come from the table of FreeType's
    output; another size raises NotImplementedError."""
    if size is None or int(size) == 10:
        return _AtlasFace(AILERON, 10, os.path.join(FONT_DIR, "aileron_10.npz"))
    raise NotImplementedError(
        f"Pillow's default font at size {size} is not ported: it is a TrueType font with no "
        "instructions, which FreeType draws through its auto-hinter, and that is not "
        "restated; only its default size 10 is")


# --------------------------------------------------------------------------
# drawing on an RGB image (numpy HWC uint8, in place)
# --------------------------------------------------------------------------

def _blend(dst: np.ndarray, mask: np.ndarray, ink):
    """ImagingFill2's blend of `ink` through an L mask into RGB pixels."""
    m = mask.astype(np.int32)[..., None]
    t = dst.astype(np.int32) * (255 - m) + np.asarray(ink, np.int32) * m + 128
    dst[...] = ((t >> 8) + t) >> 8


def draw_text(image: np.ndarray, xy, text: str, face: Face, fill, anchor: str = "la"):
    """``ImageDraw.text(xy, text, fill, font=face, anchor=anchor)`` on one
    line of text."""
    mask, (ox, oy) = face.getmask2(text, anchor, (float(np.modf(xy[0])[0]),
                                                  float(np.modf(xy[1])[0])))
    x, y = int(xy[0]) + ox, int(xy[1]) + oy
    h, w = mask.shape
    H, W = image.shape[:2]
    x0, y0, x1, y1 = max(x, 0), max(y, 0), min(x + w, W), min(y + h, H)
    if x1 > x0 and y1 > y0:
        _blend(image[y0:y1, x0:x1], mask[y0 - y:y1 - y, x0 - x:x1 - x], fill)


def draw_hline(image: np.ndarray, x0: float, x1: float, y: float, fill, width: int):
    """``ImageDraw.line((x0, y, x1, y), fill, width)`` from left to right:
    Pillow truncates the ends to integers and fills the wide line's
    polygon, rows y − ⌊(w − 1)/2⌉ to y + ⌈(w − 1)/2⌉ (its ROUND_DOWN and
    ROUND_UP), columns x0 to x1; a line of no length is one pixel."""
    xa, xb, yi = int(x0), int(x1), int(y)
    if xb < xa:
        raise NotImplementedError("a right-to-left line is not ported")
    half = (width - 1) / 2.0
    down, up = int(np.ceil(half - 0.5)), int(np.floor(half + 0.5))
    if xa == xb or width <= 1:
        down = up = 0
    h, w = image.shape[:2]
    rows = slice(min(max(yi - down, 0), h), min(max(yi + up + 1, 0), h))
    image[rows, min(max(xa, 0), w):min(max(xb + 1, 0), w)] = np.asarray(fill, np.uint8)
