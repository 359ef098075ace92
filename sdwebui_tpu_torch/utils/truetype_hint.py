"""TrueType hinting as FreeType 2.14 does it by default: the bytecode
interpreter in its v40 mode, with backward compatibility.

Pillow loads every glyph it draws with ``FT_LOAD_DEFAULT``, so FreeType
scales the outline to the size, runs the font's ``fpgm`` once and its
``prep`` once per size, then each glyph's own program.  In v40 mode with
backward compatibility on (the font does not opt out through ``INSTCTRL``
selector 3 in ``prep``), moves along x are ignored and so are the moves a
program makes after it has called IUP on both axes: hinting moves points
vertically only, and the glyph keeps its linear advance.  Glyph boxes,
and so the line boxes of ``utils/grid_annotations.py``, depend on it.

This module restates that interpreter in Python integers, with FreeType's
fixed-point arithmetic (26.6 coordinates, 2.14 unit vectors,
``FT_MulFix`` / ``FT_MulDiv`` / ``FT_DivFix`` rounding, ``FT_Vector_NormLen``)
and its undocumented behaviours (the cvt[-1] of MIRP, twilight MIAP / MIRP
/ MSIRP, the orus-based distances of MDRP, MD and IP, IUP's interpolation
on unscaled coordinates, DELTAP and SHPIX only on points already touched
in y).  Instructions a font uses that are not here raise
``NotImplementedError`` naming them.  A font with no instructions at all
(the Aileron subset of Pillow's default font) gets its scaled outline here;
FreeType runs its auto-hinter on such a font instead, which is not
restated (``utils/text_raster.load_default`` says what the port does).

``Hinter(font).outline(gid, ppem)`` → the hinted outline in 26.6 pixels,
cached per (glyph, size); ``prep`` runs once per size.
"""

from __future__ import annotations

import struct

from sdwebui_tpu_torch.utils import truetype as tt

TOUCH_X, TOUCH_Y = 1, 2

# round states
RTHG, RTG, RTDG, RDTG, RUTG, ROFF = 0, 1, 2, 3, 4, 5


def mulfix(a: int, b: int) -> int:
    """FT_MulFix: a·b / 65536, rounded half away from zero."""
    ab = a * b
    return (ab + 0x8000 - (ab < 0)) >> 16


def mulfix14(a: int, b: int) -> int:
    """TT_MulFix14: a·b / 16384, rounded half away from zero."""
    ab = a * b
    return (ab + 0x2000 - (ab < 0)) >> 14


def dotfix14(ax: int, ay: int, bx: int, by: int) -> int:
    """TT_DotFix14: (ax·bx + ay·by) / 16384, rounded as mulfix14."""
    s = ax * bx + ay * by
    return (s + 0x2000 - (s < 0)) >> 14


def muldiv(a: int, b: int, c: int) -> int:
    """FT_MulDiv: a·b / c rounded half away from zero (0x7FFFFFFF for c = 0)."""
    s = -1 if (a < 0) ^ (b < 0) ^ (c < 0) else 1
    a, b, c = abs(a), abs(b), abs(c)
    d = (a * b + (c >> 1)) // c if c > 0 else 0x7FFFFFFF
    return s * d


def muldiv_no_round(a: int, b: int, c: int) -> int:
    s = -1 if (a < 0) ^ (b < 0) ^ (c < 0) else 1
    a, b, c = abs(a), abs(b), abs(c)
    d = a * b // c if c > 0 else 0x7FFFFFFF
    return s * d


def divfix(a: int, b: int) -> int:
    """FT_DivFix: a·65536 / b, rounded."""
    s = -1 if (a < 0) ^ (b < 0) else 1
    a, b = abs(a), abs(b)
    q = ((a << 16) + (b >> 1)) // b if b > 0 else 0x7FFFFFFF
    return s * q


def _i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v & 0x80000000 else v


def _tdiv(a: int, b: int) -> int:
    """C's integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def norm_len(x_: int, y_: int) -> tuple:
    """FT_Vector_NormLen's unit vector (16.16) of (x, y)."""
    sx, sy = (-1 if x_ < 0 else 1), (-1 if y_ < 0 else 1)
    x, y = abs(x_), abs(y_)
    if x == 0:
        return (0, sy * 0x10000 if y > 0 else 0)
    if y == 0:
        return (sx * 0x10000, 0)
    ln = x + (y >> 1) if x > y else y + (x >> 1)
    shift = 31 - (ln.bit_length() - 1)
    shift -= 15 + (ln >= (0xAAAAAAAA >> shift))
    if shift > 0:
        x <<= shift
        y <<= shift
        ln = x + (y >> 1) if x > y else y + (x >> 1)
    else:
        x >>= -shift
        y >>= -shift
        ln >>= -shift
    b = 0x10000 - ln
    while True:
        u = (x + ((x * b) >> 16)) & 0xFFFFFFFF
        v = (y + ((y * b) >> 16)) & 0xFFFFFFFF
        z = _tdiv(-_i32(u * u + v * v), 0x200)
        z = _tdiv(z * ((0x10000 + b) >> 8), 0x10000)
        b += z
        if z <= 0:
            break
    return (-u if sx < 0 else u, -v if sy < 0 else v)


def normalize(vx: int, vy: int, prev: tuple) -> tuple:
    """The interpreter's Normalize: a 2.14 unit vector along (vx, vy); a
    zero vector leaves the previous one."""
    if vx == 0 and vy == 0:
        return prev
    ux, uy = norm_len(vx, vy)
    return (_tdiv(ux, 4), _tdiv(uy, 4))


class Zone:
    """Points of one zone: current and original positions (26.6), unscaled
    coordinates, touch flags, contour ends."""

    __slots__ = ("cur", "org", "orus", "tags", "ends", "n")

    def __init__(self, cur, orus, ends):
        self.cur = [list(p) for p in cur]
        self.org = [list(p) for p in cur]
        self.orus = [list(p) for p in orus]
        self.tags = [0] * len(cur)
        self.ends = list(ends)
        self.n = len(cur)


class GraphicsState:
    __slots__ = ("rp0", "rp1", "rp2", "dual", "proj", "free", "loop", "min_dist", "round_state",
                 "auto_flip", "cvt_cutin", "sw_cutin", "sw_value", "delta_base", "delta_shift",
                 "instruct_control", "scan_control", "scan_type", "gep0", "gep1", "gep2")

    def __init__(self):
        self.rp0 = self.rp1 = self.rp2 = 0
        self.dual = self.proj = self.free = (0x4000, 0)
        self.loop = 1
        self.min_dist = 64
        self.round_state = RTG
        self.auto_flip = True
        self.cvt_cutin = 68
        self.sw_cutin = 0
        self.sw_value = 0
        self.delta_base = 9
        self.delta_shift = 3
        self.instruct_control = 0
        self.scan_control = False
        self.scan_type = 0
        self.gep0 = self.gep1 = self.gep2 = 1

    def copy(self):
        g = GraphicsState.__new__(GraphicsState)
        for k in self.__slots__:
            setattr(g, k, getattr(self, k))
        return g


def _round(state: int, d: int) -> int:
    if state == RTG:
        if d >= 0:
            return max((d + 32) & -64, 0)
        return min(-((-d + 32) & -64), 0)
    if state == RTHG:
        if d >= 0:
            v = (d & -64) + 32
            return v if v >= 0 else 32
        v = -((-d & -64) + 32)
        return v if v <= 0 else -32
    if state == RTDG:
        if d >= 0:
            return max((d + 16) & -32, 0)
        return min(-((-d + 16) & -32), 0)
    if state == RDTG:
        if d >= 0:
            return max(d & -64, 0)
        return min(-(-d & -64), 0)
    if state == RUTG:
        if d >= 0:
            return max((d + 63) & -64, 0)
        return min(-((-d + 63) & -64), 0)
    if state == ROFF:
        return d
    raise NotImplementedError("the super-rounding states (SROUND, S45ROUND) are not ported")


def _round_none(d: int) -> int:
    return d if d >= 0 else min(d, 0)


_NAMES = {0x0A: "SPVFS", 0x0B: "SFVFS", 0x0C: "GPV", 0x0D: "GFV", 0x27: "ALIGNPTS",
          0x29: "UTP", 0x34: "SHC", 0x35: "SHC", 0x46: "GC", 0x47: "GC", 0x48: "SCFS",
          0x4C: "MPS", 0x70: "WCVTF", 0x72: "DELTAP3", 0x73: "DELTAC1", 0x74: "DELTAC2",
          0x75: "DELTAC3", 0x76: "SROUND", 0x77: "S45ROUND", 0x78: "JROT", 0x7E: "SANGW",
          0x7F: "AA", 0x80: "FLIPPT", 0x81: "FLIPRGON", 0x82: "FLIPRGOFF", 0x86: "SDPVTL",
          0x87: "SDPVTL", 0x89: "IDEF", 0x88: "GETINFO"}


def _skip(code: bytes, ip: int) -> int:
    """The position after the instruction at ip (with its inline data)."""
    op = code[ip]
    if op == 0x40:
        return ip + 2 + code[ip + 1]
    if op == 0x41:
        return ip + 2 + 2 * code[ip + 1]
    if 0xB0 <= op <= 0xB7:
        return ip + 1 + (op - 0xAF)
    if 0xB8 <= op <= 0xBF:
        return ip + 1 + 2 * (op - 0xB7)
    return ip + 1


class Size:
    """One ppem of a font: the scale, the cvt after prep, the storage and
    the graphics state glyph programs start from."""

    def __init__(self, hinter: "Hinter", ppem: int):
        font = hinter.font
        self.ppem = ppem
        self.scale = divfix(ppem << 6, font.units_per_em) if font.head_flags & 8 else \
            divfix(ppem * 64, font.units_per_em)
        self.cvt = [mulfix(int(v), self.scale) for v in font.cvt]
        self.storage = [0] * font.max_storage
        self.twilight = Zone([(0, 0)] * font.max_twilight, [(0, 0)] * font.max_twilight, [])
        self.gs = GraphicsState()
        self.hinted = bool(font.fpgm or font.prep or font.cvt.size)
        if font.prep:
            ex = Exec(hinter, self, self.gs, glyph_zone=Zone([], [], []))
            ex.run(font.prep)
            g = ex.gs
            g.dual = g.proj = g.free = (0x4000, 0)
            g.rp0 = g.rp1 = g.rp2 = 0
            g.gep0 = g.gep1 = g.gep2 = 1
            g.loop = 1
            self.gs = g
        # INSTCTRL selector 1 in prep turns hinting off; selector 3 (bit 4)
        # opts out of backward compatibility
        self.backward_compatibility = not self.gs.instruct_control & 4
        if self.gs.instruct_control & 1:
            self.hinted = False


class Exec:
    """One run of the interpreter over a zone (a glyph's or prep's)."""

    def __init__(self, hinter: "Hinter", size: Size, gs: GraphicsState, glyph_zone: Zone,
                 is_composite: bool = False, scale: int | None = None):
        self.h, self.size = hinter, size
        self.gs = gs.copy()
        self.stack = []
        self.zones = (size.twilight, glyph_zone)
        self.zp0 = self.zp1 = self.zp2 = glyph_zone
        self.pts = glyph_zone
        self.is_composite = is_composite
        self.scale = size.scale if scale is None else scale
        self.iupx = self.iupy = False
        self.compat = getattr(size, "backward_compatibility", True)
        self._funcs()

    # ------------------------------------------------------------ vectors

    def _funcs(self):
        g = self.gs
        fx, fy = g.free
        px, py = g.proj
        if fx == 0x4000:
            self.f_dot_p = px
        elif fy == 0x4000:
            self.f_dot_p = py
        else:
            self.f_dot_p = (px * fx + py * fy) >> 14
        self.move_x_only = self.f_dot_p == 0x4000 and fx == 0x4000
        self.move_y_only = self.f_dot_p == 0x4000 and fy == 0x4000
        if abs(self.f_dot_p) < 0x400:
            self.f_dot_p = 0x4000

    def project(self, dx, dy):
        px, py = self.gs.proj
        if px == 0x4000:
            return dx
        if py == 0x4000:
            return dy
        return dotfix14(dx, dy, px, py)

    def dualproj(self, dx, dy):
        px, py = self.gs.dual
        if px == 0x4000:
            return dx
        if py == 0x4000:
            return dy
        return dotfix14(dx, dy, px, py)

    def move(self, zone: Zone, p: int, d: int):
        """Direct_Move (and its axis forms) under backward compatibility."""
        post_iup = self.compat and self.iupx and self.iupy
        if self.move_x_only:
            if not self.compat:
                zone.cur[p][0] += d
            zone.tags[p] |= TOUCH_X
            return
        if self.move_y_only:
            if not post_iup:
                zone.cur[p][1] += d
            zone.tags[p] |= TOUCH_Y
            return
        fx, fy = self.gs.free
        if fx:
            if not self.compat:
                zone.cur[p][0] += muldiv(d, fx, self.f_dot_p)
            zone.tags[p] |= TOUCH_X
        if fy:
            if not post_iup:
                zone.cur[p][1] += muldiv(d, fy, self.f_dot_p)
            zone.tags[p] |= TOUCH_Y

    def move_orig(self, zone: Zone, p: int, d: int):
        fx, fy = self.gs.free
        if self.move_x_only:
            zone.org[p][0] += d
        elif self.move_y_only:
            zone.org[p][1] += d
        else:
            if fx:
                zone.org[p][0] += muldiv(d, fx, self.f_dot_p)
            if fy:
                zone.org[p][1] += muldiv(d, fy, self.f_dot_p)

    def move_zp2(self, p: int, dx: int, dy: int, touch: bool):
        z = self.zp2
        fx, fy = self.gs.free
        if fx:
            if not self.compat:
                z.cur[p][0] += dx
            if touch:
                z.tags[p] |= TOUCH_X
        if fy:
            if not (self.compat and self.iupx and self.iupy):
                z.cur[p][1] += dy
            if touch:
                z.tags[p] |= TOUCH_Y

    def orus_dist(self, z1: Zone, p1: int, z0: Zone, p0: int) -> int:
        """The dual-projected original distance from p0 to p1 (MDRP, MD[a],
        IP): from the unscaled coordinates, scaled, outside the twilight."""
        if self.gs.gep0 == 0 or self.gs.gep1 == 0:
            a, b = z1.org[p1], z0.org[p0]
            return self.dualproj(a[0] - b[0], a[1] - b[1])
        a, b = z1.orus[p1], z0.orus[p0]
        return mulfix(self.dualproj(a[0] - b[0], a[1] - b[1]), self.scale)

    # ------------------------------------------------------------ running

    def pop(self):
        return self.stack.pop()

    def run(self, code: bytes):
        self._exec(code, 0, len(code))

    def _exec(self, code: bytes, ip: int, end: int):
        st = self.stack
        g = self.gs
        while ip < end:
            op = code[ip]
            nxt = ip + 1
            if 0xB0 <= op <= 0xB7:
                n = op - 0xAF
                st.extend(code[ip + 1:ip + 1 + n])
                nxt = ip + 1 + n
            elif 0xB8 <= op <= 0xBF:
                n = op - 0xB7
                st.extend(struct.unpack_from(f">{n}h", code, ip + 1))
                nxt = ip + 1 + 2 * n
            elif op == 0x40:
                n = code[ip + 1]
                st.extend(code[ip + 2:ip + 2 + n])
                nxt = ip + 2 + n
            elif op == 0x41:
                n = code[ip + 1]
                st.extend(struct.unpack_from(f">{n}h", code, ip + 2))
                nxt = ip + 2 + 2 * n
            elif op >= 0xC0:
                self._mdrp(op) if op < 0xE0 else self._mirp(op)
            elif op <= 0x05:
                v = (0, 0x4000) if op & 1 == 0 else (0x4000, 0)
                if op <= 1:
                    g.proj = g.dual = g.free = v
                elif op <= 3:
                    g.proj = g.dual = v
                else:
                    g.free = v
                self._funcs()
            elif op in (0x06, 0x07, 0x08, 0x09):
                p1, p2 = st.pop(), st.pop()          # args[1] = p1 (top), args[0] = p2
                a_pt = self.zp1.cur[p2]
                b_pt = self.zp2.cur[p1]
                a, b = a_pt[0] - b_pt[0], a_pt[1] - b_pt[1]
                odd = op & 1
                if a == 0 and b == 0:
                    a, odd = 0x4000, 0
                if odd:
                    a, b = -b, a
                if op <= 0x07:
                    g.proj = normalize(a, b, g.proj)
                    g.dual = g.proj
                else:
                    g.free = normalize(a, b, g.free)
                self._funcs()
            elif op == 0x0E:
                g.free = g.proj
                self._funcs()
            elif op == 0x0F:
                self._isect()
            elif op == 0x10:
                g.rp0 = st.pop()
            elif op == 0x11:
                g.rp1 = st.pop()
            elif op == 0x12:
                g.rp2 = st.pop()
            elif 0x13 <= op <= 0x16:
                z = st.pop()
                if z not in (0, 1):
                    raise ValueError(f"zone {z} out of range")
                zone = self.zones[z]
                if op == 0x13:
                    self.zp0, g.gep0 = zone, z
                elif op == 0x14:
                    self.zp1, g.gep1 = zone, z
                elif op == 0x15:
                    self.zp2, g.gep2 = zone, z
                else:
                    self.zp0 = self.zp1 = self.zp2 = zone
                    g.gep0 = g.gep1 = g.gep2 = z
            elif op == 0x17:
                g.loop = st.pop()
            elif op == 0x18:
                g.round_state = RTG
            elif op == 0x19:
                g.round_state = RTHG
            elif op == 0x1A:
                g.min_dist = st.pop()
            elif op == 0x1B:                      # ELSE reached from a taken IF
                nxt = self._skip_to_eif(code, ip + 1, end, stop_at_else=False)
            elif op == 0x1C:
                nxt = ip + st.pop()
            elif op == 0x1D:
                g.cvt_cutin = st.pop()
            elif op == 0x1E:
                g.sw_cutin = st.pop()
            elif op == 0x1F:
                g.sw_value = mulfix(st.pop(), self.scale)
            elif op == 0x20:
                st.append(st[-1])
            elif op == 0x21:
                st.pop()
            elif op == 0x22:
                st.clear()
            elif op == 0x23:
                st[-1], st[-2] = st[-2], st[-1]
            elif op == 0x24:
                st.append(len(st))
            elif op == 0x25:
                k = st.pop()
                st.append(st[-k])
            elif op == 0x26:
                k = st.pop()
                st.append(st.pop(-k))
            elif op in (0x2A, 0x2B):
                f = st.pop()
                count = st.pop() if op == 0x2A else 1
                fdef = self.h.fdefs.get(f)
                if fdef is None:
                    raise ValueError(f"CALL of undefined function {f}")
                fcode, fstart, fend = fdef
                for _ in range(count):
                    self._exec(fcode, fstart, fend)
            elif op == 0x2C:
                f = st.pop()
                j = ip + 1
                while code[j] != 0x2D:
                    j = _skip(code, j)
                self.h.fdefs[f] = (code, ip + 1, j)
                nxt = j + 1
            elif op == 0x2D:                      # ENDF ends the function
                return
            elif op in (0x2E, 0x2F):
                self._mdap(op)
            elif op in (0x30, 0x31):
                self._iup(op)
            elif op in (0x32, 0x33):
                self._shp(op)
            elif op in (0x36, 0x37):
                self._shz(op)
            elif op == 0x38:
                self._shpix()
            elif op == 0x39:
                self._ip()
            elif op in (0x3A, 0x3B):
                self._msirp(op)
            elif op == 0x3C:
                self._alignrp()
            elif op == 0x3D:
                g.round_state = RTDG
            elif op in (0x3E, 0x3F):
                self._miap(op)
            elif op == 0x42:
                v, k = st.pop(), st.pop()
                self.size.storage[k] = v
            elif op == 0x43:
                st.append(self.size.storage[st.pop()])
            elif op == 0x44:
                v, k = st.pop(), st.pop()
                self.size.cvt[k] = v
            elif op == 0x45:
                st.append(self.size.cvt[st.pop()])
            elif op in (0x49, 0x4A):
                k, l_ = st.pop(), st.pop()         # args[1] = K (top), args[0] = L
                if op & 1:
                    a, b = self.zp0.cur[l_], self.zp1.cur[k]
                    st.append(self.project(a[0] - b[0], a[1] - b[1]))
                else:
                    st.append(self.orus_dist(self.zp0, l_, self.zp1, k))
            elif op == 0x4B:
                st.append(self.size.ppem)
            elif op == 0x4D:
                g.auto_flip = True
            elif op == 0x4E:
                g.auto_flip = False
            elif 0x50 <= op <= 0x55:
                b_, a_ = st.pop(), st.pop()
                st.append(int((a_ < b_, a_ <= b_, a_ > b_, a_ >= b_, a_ == b_,
                               a_ != b_)[op - 0x50]))
            elif op == 0x56:
                st.append(int(_round(g.round_state, st.pop()) & 127 == 64))
            elif op == 0x57:
                st.append(int(_round(g.round_state, st.pop()) & 127 == 0))
            elif op == 0x58:
                if not st.pop():
                    nxt = self._skip_to_eif(code, ip + 1, end, stop_at_else=True)
            elif op == 0x59:
                pass
            elif op == 0x5A:
                b_, a_ = st.pop(), st.pop()
                st.append(int(bool(a_) and bool(b_)))
            elif op == 0x5B:
                b_, a_ = st.pop(), st.pop()
                st.append(int(bool(a_) or bool(b_)))
            elif op == 0x5C:
                st.append(int(not st.pop()))
            elif op in (0x5D, 0x71):
                self._deltap(16 if op == 0x71 else 0)
            elif op == 0x5E:
                g.delta_base = st.pop()
            elif op == 0x5F:
                g.delta_shift = st.pop()
            elif op == 0x60:
                b_ = st.pop()
                st[-1] += b_
            elif op == 0x61:
                b_ = st.pop()
                st[-1] -= b_
            elif op == 0x62:
                b_ = st.pop()
                if b_ == 0:
                    raise ZeroDivisionError("TrueType DIV by zero")
                st[-1] = muldiv_no_round(st[-1], 64, b_)
            elif op == 0x63:
                b_ = st.pop()
                st[-1] = muldiv(st[-1], b_, 64)
            elif op == 0x64:
                st[-1] = abs(st[-1])
            elif op == 0x65:
                st[-1] = -st[-1]
            elif op == 0x66:
                st[-1] &= -64
            elif op == 0x67:
                st[-1] = (st[-1] + 63) & -64
            elif 0x68 <= op <= 0x6B:
                st[-1] = _round(g.round_state, st[-1])
            elif 0x6C <= op <= 0x6F:
                st[-1] = _round_none(st[-1])
            elif op == 0x79:
                e, off = st.pop(), st.pop()
                if not e:
                    nxt = ip + off
            elif op == 0x7A:
                g.round_state = ROFF
            elif op == 0x7C:
                g.round_state = RUTG
            elif op == 0x7D:
                g.round_state = RDTG
            elif op == 0x85:
                g.scan_control = st.pop()
            elif op == 0x8A:
                a_, b_, c_ = st[-1], st[-2], st[-3]
                st[-1], st[-2], st[-3] = c_, a_, b_
            elif op == 0x8B:
                b_ = st.pop()
                st[-1] = max(st[-1], b_)
            elif op == 0x8C:
                b_ = st.pop()
                st[-1] = min(st[-1], b_)
            elif op == 0x8D:
                g.scan_type = st.pop()
            elif op == 0x8E:
                sel, val = st.pop(), st.pop()
                if sel in (1, 2, 3):
                    bit = 1 << (sel - 1)
                    g.instruct_control = (g.instruct_control & ~bit) | (bit if val else 0)
            else:
                raise NotImplementedError(
                    f"TrueType instruction {_NAMES.get(op, 'opcode')} (0x{op:02X}) is not ported")
            ip = nxt

    @staticmethod
    def _skip_to_eif(code, ip, end, stop_at_else: bool) -> int:
        """From inside an IF (or after an ELSE): the position after the
        matching ELSE (when stop_at_else) or EIF."""
        depth = 1
        while ip < end:
            op = code[ip]
            if op == 0x58:
                depth += 1
            elif op == 0x59:
                depth -= 1
                if depth == 0:
                    return ip + 1
            elif op == 0x1B and depth == 1 and stop_at_else:
                return ip + 1
            ip = _skip(code, ip)
        return ip

    # ------------------------------------------------------ instructions

    def _mdap(self, op):
        g = self.gs
        p = self.stack.pop()
        z = self.zp0
        if op & 1:
            c = self.project(*z.cur[p])
            d = _round(g.round_state, c) - c
        else:
            d = 0
        self.move(z, p, d)
        g.rp0 = g.rp1 = p

    def _miap(self, op):
        g = self.gs
        cvt_i, p = self.stack.pop(), self.stack.pop()
        z = self.zp0
        d = self.size.cvt[cvt_i]
        if g.gep0 == 0:
            z.org[p] = [mulfix14(d, g.free[0]), mulfix14(d, g.free[1])]
            z.cur[p] = list(z.org[p])
        org = self.project(*z.cur[p])
        if op & 1:
            if abs(d - org) > g.cvt_cutin:
                d = org
            d = _round(g.round_state, d)
        self.move(z, p, d - org)
        g.rp0 = g.rp1 = p

    def _mdrp(self, op):
        g = self.gs
        p = self.stack.pop()
        z0, z1 = self.zp0, self.zp1
        org = self.orus_dist(z1, p, z0, g.rp0)
        if g.sw_cutin > 0 and g.sw_value - g.sw_cutin < org < g.sw_value + g.sw_cutin:
            org = g.sw_value if org >= 0 else -g.sw_value
        d = _round(g.round_state, org) if op & 4 else _round_none(org)
        if op & 8:
            if org >= 0:
                d = max(d, g.min_dist)
            else:
                d = min(d, -g.min_dist)
        a, b = z1.cur[p], z0.cur[g.rp0]
        cur = self.project(a[0] - b[0], a[1] - b[1])
        self.move(z1, p, d - cur)
        g.rp1 = g.rp0
        g.rp2 = p
        if op & 16:
            g.rp0 = p

    def _mirp(self, op):
        g = self.gs
        entry, p = self.stack.pop() + 1, self.stack.pop()
        z0, z1 = self.zp0, self.zp1
        cvt = self.size.cvt[entry - 1] if entry else 0
        if abs(cvt - g.sw_value) < g.sw_cutin:
            cvt = g.sw_value if cvt >= 0 else -g.sw_value
        if g.gep1 == 0:
            r = z0.org[g.rp0]
            z1.org[p] = [r[0] + mulfix14(cvt, g.free[0]), r[1] + mulfix14(cvt, g.free[1])]
            z1.cur[p] = list(z1.org[p])
        a, b = z1.org[p], z0.org[g.rp0]
        org = self.dualproj(a[0] - b[0], a[1] - b[1])
        a, b = z1.cur[p], z0.cur[g.rp0]
        cur = self.project(a[0] - b[0], a[1] - b[1])
        if g.auto_flip and (org ^ cvt) < 0:
            cvt = -cvt
        if op & 4:
            if g.gep0 == g.gep1 and abs(cvt - org) > g.cvt_cutin:
                cvt = org
            d = _round(g.round_state, cvt)
        else:
            d = _round_none(cvt)
        if op & 8:
            if org >= 0:
                d = max(d, g.min_dist)
            else:
                d = min(d, -g.min_dist)
        self.move(z1, p, d - cur)
        g.rp1 = g.rp0
        if op & 16:
            g.rp0 = p
        g.rp2 = p

    def _msirp(self, op):
        g = self.gs
        d, p = self.stack.pop(), self.stack.pop()
        z0, z1 = self.zp0, self.zp1
        if g.gep1 == 0:
            z1.org[p] = list(z0.org[g.rp0])
            self.move_orig(z1, p, d)
            z1.cur[p] = list(z1.org[p])
        a, b = z1.cur[p], z0.cur[g.rp0]
        self.move(z1, p, d - self.project(a[0] - b[0], a[1] - b[1]))
        g.rp1 = g.rp0
        g.rp2 = p
        if op & 1:
            g.rp0 = p

    def _alignrp(self):
        g = self.gs
        z0, z1 = self.zp0, self.zp1
        for _ in range(g.loop):
            p = self.stack.pop()
            a, b = z1.cur[p], z0.cur[g.rp0]
            self.move(z1, p, -self.project(a[0] - b[0], a[1] - b[1]))
        g.loop = 1

    def _ip(self):
        g = self.gs
        z0, z1, z2 = self.zp0, self.zp1, self.zp2
        twilight = g.gep0 == 0 or g.gep1 == 0 or g.gep2 == 0
        base_o = z0.org[g.rp1] if twilight else z0.orus[g.rp1]
        base_c = z0.cur[g.rp1]

        def odist(z, p):
            # in font units (the ratio needs no scaling), in the twilight zone
            # from the original positions
            a = z.org[p] if twilight else z.orus[p]
            return self.dualproj(a[0] - base_o[0], a[1] - base_o[1])

        old = odist(z1, g.rp2)
        a = z1.cur[g.rp2]
        cur_range = self.project(a[0] - base_c[0], a[1] - base_c[1])
        for _ in range(g.loop):
            p = self.stack.pop()
            od = odist(z2, p)
            a = z2.cur[p]
            cd = self.project(a[0] - base_c[0], a[1] - base_c[1])
            if od:
                new = muldiv(od, cur_range, old) if old else od
            else:
                new = 0
            self.move(z2, p, new - cd)
        g.loop = 1

    def _displacement(self, op):
        g = self.gs
        if op & 1:
            z, p = self.zp0, g.rp1
        else:
            z, p = self.zp1, g.rp2
        a, b = z.cur[p], z.org[p]
        d = self.project(a[0] - b[0], a[1] - b[1])
        return (muldiv(d, g.free[0], self.f_dot_p), muldiv(d, g.free[1], self.f_dot_p), z, p)

    def _shp(self, op):
        g = self.gs
        dx, dy, _, _ = self._displacement(op)
        for _ in range(g.loop):
            p = self.stack.pop()
            self.move_zp2(p, 0 if self.compat else dx, dy, True)
        g.loop = 1

    def _shz(self, op):
        g = self.gs
        self.stack.pop()
        dx, dy, z, ref = self._displacement(op)
        z2 = self.zp2
        if g.gep2 == 0:
            limit = z2.n
        elif g.gep2 == 1 and z2.ends:
            limit = z2.ends[-1] + 1
        else:
            limit = 0
        for i in range(limit):
            if z is not z2 or ref != i:
                self.move_zp2(i, dx, dy, False)

    def _shpix(self):
        g = self.gs
        amount = self.stack.pop()
        dx, dy = mulfix14(amount, g.free[0]), mulfix14(amount, g.free[1])
        twilight = g.gep2 == 0
        for _ in range(g.loop):
            p = self.stack.pop()
            if self.compat:
                if twilight or (not (self.iupx and self.iupy) and (
                        (self.is_composite and g.free[1] != 0)
                        or self.zp2.tags[p] & TOUCH_Y)):
                    self.move_zp2(p, 0, dy, True)
            else:
                self.move_zp2(p, dx, dy, True)
        g.loop = 1

    def _deltap(self, base: int):
        g = self.gs
        n = self.stack.pop()
        ppem = self.size.ppem
        for _ in range(n):
            p, arg = self.stack.pop(), self.stack.pop()
            if p >= self.zp0.n:
                continue
            c = ((arg & 0xF0) >> 4) + base + g.delta_base
            if ppem != c:
                continue
            b = (arg & 0xF) - 8
            if b >= 0:
                b += 1
            b *= 1 << (6 - g.delta_shift)
            if self.compat:
                if not (self.iupx and self.iupy) and (
                        (self.is_composite and g.free[1] != 0) or self.zp0.tags[p] & TOUCH_Y):
                    self.move(self.zp0, p, b)
            else:
                self.move(self.zp0, p, b)

    def _isect(self):
        st = self.stack
        b1, b0, a1, a0, p = st.pop(), st.pop(), st.pop(), st.pop(), st.pop()
        z0, z1, z2 = self.zp0, self.zp1, self.zp2
        dbx = z0.cur[b1][0] - z0.cur[b0][0]
        dby = z0.cur[b1][1] - z0.cur[b0][1]
        dax = z1.cur[a1][0] - z1.cur[a0][0]
        day = z1.cur[a1][1] - z1.cur[a0][1]
        dx = z0.cur[b0][0] - z1.cur[a0][0]
        dy = z0.cur[b0][1] - z1.cur[a0][1]
        disc = muldiv(dax, -dby, 0x40) + muldiv(day, dbx, 0x40)
        dot = muldiv(dax, dbx, 0x40) + muldiv(day, dby, 0x40)
        if 19 * abs(disc) > abs(dot):
            val = muldiv(dx, -dby, 0x40) + muldiv(dy, dbx, 0x40)
            rx, ry = muldiv(val, dax, disc), muldiv(val, day, disc)
            z2.cur[p] = [z1.cur[a0][0] + rx, z1.cur[a0][1] + ry]
        else:
            z2.cur[p] = [
                _tdiv(z1.cur[a0][0] + z1.cur[a1][0] + z0.cur[b0][0] + z0.cur[b1][0], 4),
                _tdiv(z1.cur[a0][1] + z1.cur[a1][1] + z0.cur[b0][1] + z0.cur[b1][1], 4)]
        z2.tags[p] |= TOUCH_X | TOUCH_Y

    def _iup(self, op):
        z = self.pts
        if not z.ends:
            return
        if self.compat:
            if self.iupx and self.iupy:
                return
            if op & 1:
                self.iupx = True
            else:
                self.iupy = True
        axis = 0 if op & 1 else 1
        mask = TOUCH_X if op & 1 else TOUCH_Y
        point = 0
        for end_point in z.ends:
            first_point = point
            end_point = min(end_point, z.n - 1)
            while point <= end_point and not z.tags[point] & mask:
                point += 1
            if point <= end_point:
                first_touched = cur_touched = point
                point += 1
                while point <= end_point:
                    if z.tags[point] & mask:
                        self._iup_interp(axis, cur_touched + 1, point - 1, cur_touched, point)
                        cur_touched = point
                    point += 1
                if cur_touched == first_touched:
                    self._iup_shift(axis, first_point, end_point, cur_touched)
                else:
                    self._iup_interp(axis, cur_touched + 1, end_point, cur_touched, first_touched)
                    if first_touched > 0:
                        self._iup_interp(axis, first_point, first_touched - 1, cur_touched,
                                         first_touched)
            point = end_point + 1

    def _iup_shift(self, axis, p1, p2, p):
        z = self.pts
        d = z.cur[p][axis] - z.org[p][axis]
        if d:
            for i in range(p1, p2 + 1):
                if i != p:
                    z.cur[i][axis] += d

    def _iup_interp(self, axis, p1, p2, ref1, ref2):
        if p1 > p2:
            return
        z = self.pts
        orus1, orus2 = z.orus[ref1][axis], z.orus[ref2][axis]
        if orus1 > orus2:
            orus1, orus2 = orus2, orus1
            ref1, ref2 = ref2, ref1
        org1, org2 = z.org[ref1][axis], z.org[ref2][axis]
        cur1, cur2 = z.cur[ref1][axis], z.cur[ref2][axis]
        d1, d2 = cur1 - org1, cur2 - org2
        if cur1 == cur2 or orus1 == orus2:
            for i in range(p1, p2 + 1):
                x = z.org[i][axis]
                z.cur[i][axis] = x + d1 if x <= org1 else (x + d2 if x >= org2 else cur1)
            return
        scale = None
        for i in range(p1, p2 + 1):
            x = z.org[i][axis]
            if x <= org1:
                x += d1
            elif x >= org2:
                x += d2
            else:
                if scale is None:
                    scale = divfix(cur2 - cur1, orus2 - orus1)
                x = cur1 + mulfix(z.orus[i][axis] - orus1, scale)
            z.cur[i][axis] = x


class Outline:
    """A glyph's outline in 26.6 pixels: ``points`` [(x, y)], ``on``,
    ``ends``, and its four phantom points (26.6)."""

    __slots__ = ("points", "on", "ends", "phantom")

    def __init__(self, points, on, ends, phantom):
        self.points, self.on, self.ends, self.phantom = points, on, ends, phantom


class Hinter:
    """FreeType's TrueType loader for one font: ``outline(gid, ppem,
    hinting=True)``; sizes and glyph outlines are cached."""

    def __init__(self, font: tt.Font):
        self.font = font
        self.fdefs = {}
        self._sizes = {}
        self._outlines = {}
        if font.fpgm:
            size = Size.__new__(Size)
            size.ppem, size.scale, size.cvt, size.storage = 0, 0x10000, [], \
                [0] * font.max_storage
            size.twilight = Zone([(0, 0)] * font.max_twilight, [(0, 0)] * font.max_twilight, [])
            Exec(self, size, GraphicsState(), Zone([], [], [])).run(font.fpgm)

    def size(self, ppem: int) -> Size:
        s = self._sizes.get(ppem)
        if s is None:
            s = self._sizes[ppem] = Size(self, ppem)
        return s

    def outline(self, gid: int, ppem: int, hinting: bool = True) -> Outline:
        key = (gid, ppem, hinting)
        o = self._outlines.get(key)
        if o is None:
            o = self._outlines[key] = self._load(gid, self.size(ppem), hinting, 0)
        return o

    def _phantom(self, gid: int, glyph: tt.Glyph) -> list:
        f = self.font
        x_min, _, _, y_max = glyph.bbox
        pp1x = x_min - int(f.lsbs[gid])
        asc, desc = f.typo if f.typo is not None else (f.ascender, f.descender)
        top = y_max + (asc - y_max)
        return [(pp1x, 0), (pp1x + int(f.advances[gid]), 0), (0, top), (0, top - abs(asc - desc))]

    def _load(self, gid: int, size: Size, hinting: bool, depth: int) -> Outline:
        if depth > 8:
            raise ValueError("composite glyphs nested too deep")
        glyph = self.font.glyph(gid)
        hint = hinting and size.hinted
        if glyph.components is None:
            orus = [tuple(int(v) for v in p) for p in glyph.points] + self._phantom(gid, glyph)
            sc = size.scale
            cur = [(mulfix(x, sc), mulfix(y, sc)) for x, y in orus]
            n = len(glyph.points)
            if not hint:
                return Outline(cur[:n], list(glyph.on), list(glyph.ends), cur[n:])
            zone = Zone(cur, orus, glyph.ends)
            self._hint(zone, glyph.program, size, False)
            return Outline([tuple(p) for p in zone.cur[:n]], list(glyph.on), list(glyph.ends),
                           [tuple(p) for p in zone.cur[n:]])
        points, on, ends, phantom = [], [], [], None
        for cid, flags, a1, a2, m in glyph.components:
            child = self._load(cid, size, hinting, depth + 1)
            pts = list(child.points)
            if m is not None:
                xx, yx, xy, yy = (v * 4 for v in m)
                pts = [(mulfix(x, xx) + mulfix(y, xy), mulfix(x, yx) + mulfix(y, yy))
                       for x, y in pts]
            if flags & tt.ARGS_ARE_XY_VALUES:
                if m is not None and flags & tt.SCALED_COMPONENT_OFFSET:
                    raise NotImplementedError("scaled component offsets are not ported")
                dx, dy = mulfix(a1, size.scale), mulfix(a2, size.scale)
                if flags & tt.ROUND_XY_TO_GRID and hint:
                    dy = (dy + 32) & -64
            else:
                if a1 >= len(points) or a2 >= len(pts):
                    raise ValueError("composite point matching out of range")
                dx, dy = points[a1][0] - pts[a2][0], points[a1][1] - pts[a2][1]
            base = len(points)
            points += [(x + dx, y + dy) for x, y in pts]
            on += child.on
            ends += [e + base for e in child.ends]
            if flags & tt.USE_MY_METRICS:
                phantom = child.phantom
        sc = size.scale
        if phantom is None:
            phantom = [(mulfix(x, sc), mulfix(y, sc)) for x, y in self._phantom(gid, glyph)]
        if hint and glyph.program:
            cur = points + list(phantom)
            zone = Zone(cur, cur, ends)
            self._hint(zone, glyph.program, size, True)
            n = len(points)
            return Outline([tuple(p) for p in zone.cur[:n]], on, ends,
                           [tuple(p) for p in zone.cur[n:]])
        return Outline(points, on, ends, list(phantom))

    def _hint(self, zone: Zone, program: bytes, size: Size, composite: bool):
        """TT_Hint_Glyph: round the phantom points, run the program."""
        n = zone.n
        for i, axis in ((n - 4, 0), (n - 3, 0), (n - 2, 1), (n - 1, 1)):
            zone.cur[i][axis] = (zone.cur[i][axis] + 32) & -64
        if not program:
            return
        ex = Exec(self, size, size.gs, zone, is_composite=composite,
                  scale=0x10000 if composite else None)
        ex.run(program)
