"""Tier-2 of JPEG 2000 (ISO 15444-1 annex B) as OpenJPEG reads and writes
it: a tile's resolutions, sub-bands, precincts and code-blocks
(``opj_tcd_init_tile``), the packet order of the five progressions and of
POC (``opj_pi_next_*``, each packet once), packet headers (tag trees for
inclusion and zero bit-planes, pass counts, Lblock and the codeword segment
lengths), SOP / EPH, and packed headers from PPM / PPT.

Decoding gives each code-block its codeword segments ``[(passes, bytes)]``;
a length that runs past the tile's data raises."""

from __future__ import annotations

import numpy as np

from sdwebui_tpu_torch.utils.j2k_codestream import CodestreamError


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def ceil_pow2(a: int, e: int) -> int:
    return -((-a) >> e)


class Cblk:
    __slots__ = ("x0", "y0", "x1", "y1", "included", "numbps", "numlenbits", "segs",
                 "npasses", "enc")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.included = False
        self.numbps = 0
        self.numlenbits = 3
        self.segs = []          # [passes, max passes, bytearray]
        self.npasses = 0
        self.enc = None


class TagTree:
    """``opj_tgt_*``: a quad tree over (w, h) leaves."""

    def __init__(self, w: int, h: int):
        nodes = 0
        lw, lh = w, h
        sizes = []
        while True:
            sizes.append((lw, lh))
            nodes += lw * lh
            if lw * lh <= 1:
                break
            lw, lh = (lw + 1) // 2, (lh + 1) // 2
        self.n = nodes
        self.parent = [-1] * nodes
        base = 0
        for k in range(len(sizes) - 1):
            lw, lh = sizes[k]
            pw = sizes[k + 1][0]
            nbase = base + lw * lh
            for j in range(lh):
                for i in range(lw):
                    self.parent[base + j * lw + i] = nbase + (j // 2) * pw + i // 2
            base = nbase
        self.reset()

    def reset(self):
        self.value = [999] * self.n
        self.low = [0] * self.n
        self.known = [False] * self.n

    def set_value(self, leaf: int, v: int):
        node = leaf
        while node >= 0 and self.value[node] > v:
            self.value[node] = v
            node = self.parent[node]

    def _path(self, leaf):
        stk = []
        node = leaf
        while self.parent[node] >= 0:
            stk.append(node)
            node = self.parent[node]
        return node, stk

    def decode(self, bio, leaf: int, threshold: int) -> bool:
        node, stk = self._path(leaf)
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold and low < self.value[node]:
                if bio.read(1):
                    self.value[node] = low
                else:
                    low += 1
            self.low[node] = low
            if not stk:
                break
            node = stk.pop()
        return self.value[node] < threshold

    def encode(self, bio, leaf: int, threshold: int):
        node, stk = self._path(leaf)
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold:
                if low >= self.value[node]:
                    if not self.known[node]:
                        bio.write(1, 1)
                        self.known[node] = True
                    break
                bio.write(0, 1)
                low += 1
            self.low[node] = low
            if not stk:
                break
            node = stk.pop()


class BitReader:
    """``opj_bio`` reading: after a 0xFF byte the next gives 7 bits."""

    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.pos, self.end = data, pos, end
        self.buf = 0
        self.ct = 0

    def _bytein(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.pos < self.end:
            self.buf |= self.data[self.pos]
            self.pos += 1
        else:
            raise CodestreamError("a packet header that runs past its tile's data")

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            if self.ct == 0:
                self._bytein()
            self.ct -= 1
            v = (v << 1) | ((self.buf >> self.ct) & 1)
        return v

    def align(self):
        """``opj_bio_inalign``; returns the position after the header."""
        if (self.buf & 0xFF) == 0xFF:
            self._bytein()
        self.ct = 0
        return self.pos


class BitWriter:
    """``opj_bio`` writing."""

    def __init__(self):
        self.out = bytearray()
        self.buf = 0
        self.ct = 8

    def _byteout(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        self.out.append(self.buf >> 8)

    def write(self, v: int, n: int):
        for k in range(n - 1, -1, -1):
            if self.ct == 0:
                self._byteout()
            self.ct -= 1
            self.buf |= ((v >> k) & 1) << self.ct

    def flush(self) -> bytes:
        self._byteout()
        if self.ct == 7:
            self._byteout()
        return bytes(self.out)


class Band:
    __slots__ = ("orient", "x0", "y0", "x1", "y1", "index", "numbps", "step", "precincts")


class Precinct:
    """A precinct of a band: ``cw`` × ``ch`` code-blocks over ``rect``,
    made with their tag trees when first asked for (``cblks``), so that a
    precinct that no packet includes costs nothing: a file of a few bytes
    may declare millions of code-blocks and code none."""

    __slots__ = ("cw", "ch", "rect", "cbw", "cbh", "_cblks", "incl", "imsb")

    def __init__(self, cw: int, ch: int, rect=None, cbw: int = 0, cbh: int = 0):
        self.cw, self.ch, self.rect, self.cbw, self.cbh = cw, ch, rect, cbw, cbh
        self._cblks = None
        self.incl = self.imsb = None

    @property
    def cblks(self) -> list:
        if self._cblks is None:
            self._cblks = []
            if self.cw * self.ch:
                x0, y0, x1, y1 = self.rect
                bx0 = (x0 >> self.cbw) << self.cbw
                by0 = (y0 >> self.cbh) << self.cbh
                for k in range(self.cw * self.ch):
                    qx = bx0 + (k % self.cw) * (1 << self.cbw)
                    qy = by0 + (k // self.cw) * (1 << self.cbh)
                    self._cblks.append(Cblk(max(qx, x0), max(qy, y0), min(qx + (1 << self.cbw), x1),
                                            min(qy + (1 << self.cbh), y1)))
                self.incl = TagTree(self.cw, self.ch)
                self.imsb = TagTree(self.cw, self.ch)
        return self._cblks

    @property
    def built(self) -> list:
        """The code-blocks made so far: none until ``cblks`` is asked for."""
        return self._cblks or []


class Resolution:
    __slots__ = ("x0", "y0", "x1", "y1", "pdx", "pdy", "pw", "ph", "bands")


class TileComp:
    __slots__ = ("x0", "y0", "x1", "y1", "res", "style", "comp")


def tile_rect(cs, t: int):
    p, q = t % cs.numxtiles, t // cs.numxtiles
    return (max(cs.xtosiz + p * cs.xtsiz, cs.xosiz), max(cs.ytosiz + q * cs.ytsiz, cs.yosiz),
            min(cs.xtosiz + (p + 1) * cs.xtsiz, cs.xsiz), min(cs.ytosiz + (q + 1) * cs.ytsiz,
                                                            cs.ysiz))


def build_tile(cs, coding, rect) -> list:
    """The tile-components of a tile: resolutions, bands, precincts and
    code-blocks (``opj_tcd_init_tile``)."""
    tx0, ty0, tx1, ty1 = rect
    out = []
    for c, comp in enumerate(cs.comps):
        st = coding.comps[c]
        tc = TileComp()
        tc.comp, tc.style = comp, st
        tc.x0, tc.y0 = ceil_div(tx0, comp.dx), ceil_div(ty0, comp.dy)
        tc.x1, tc.y1 = ceil_div(tx1, comp.dx), ceil_div(ty1, comp.dy)
        nres = st.levels + 1
        tc.res = []
        for r in range(nres):
            level = nres - 1 - r
            res = Resolution()
            res.x0, res.y0 = ceil_pow2(tc.x0, level), ceil_pow2(tc.y0, level)
            res.x1, res.y1 = ceil_pow2(tc.x1, level), ceil_pow2(tc.y1, level)
            pdx, pdy = st.precinct(r)
            if r > 0 and (pdx == 0 or pdy == 0):
                from sdwebui_tpu_torch.utils.image_io import UnsupportedImageFormat
                raise UnsupportedImageFormat("JPEG 2000 with one-sample precincts above the "
                                             "lowest resolution")
            res.pdx, res.pdy = pdx, pdy
            px0 = (res.x0 >> pdx) << pdx
            py0 = (res.y0 >> pdy) << pdy
            px1 = ceil_pow2(res.x1, pdx) << pdx
            py1 = ceil_pow2(res.y1, pdy) << pdy
            res.pw = 0 if res.x0 == res.x1 else (px1 - px0) >> pdx
            res.ph = 0 if res.y0 == res.y1 else (py1 - py0) >> pdy
            if r == 0:
                cbgx, cbgy, cbgw, cbgh = px0, py0, pdx, pdy
                orients = (0,)
            else:
                cbgx, cbgy, cbgw, cbgh = ceil_pow2(px0, 1), ceil_pow2(py0, 1), pdx - 1, pdy - 1
                orients = (1, 2, 3)
            cbw = min(st.cblkw, cbgw)
            cbh = min(st.cblkh, cbgh)
            res.bands = []
            for orient in orients:
                b = Band()
                b.orient = orient
                if r == 0:
                    b.x0, b.y0, b.x1, b.y1 = res.x0, res.y0, res.x1, res.y1
                    b.index = 0
                else:
                    xob, yob = orient & 1, orient >> 1
                    b.x0 = ceil_pow2(tc.x0 - (xob << level), level + 1)
                    b.y0 = ceil_pow2(tc.y0 - (yob << level), level + 1)
                    b.x1 = ceil_pow2(tc.x1 - (xob << level), level + 1)
                    b.y1 = ceil_pow2(tc.y1 - (yob << level), level + 1)
                    b.index = 3 * (r - 1) + orient
                expn, mant = st.step(b.index)
                b.numbps = expn + st.guard - 1
                gain = 0 if (not st.reversible or orient == 0) else (2 if orient == 3 else 1)
                b.step = float(np.float32((1.0 + mant / 2048.0) * 2.0 ** (comp.prec + gain - expn)))
                b.precincts = []
                for pno in range(res.pw * res.ph):
                    cx0 = cbgx + (pno % res.pw) * (1 << cbgw)
                    cy0 = cbgy + (pno // res.pw) * (1 << cbgh)
                    x0, y0 = max(cx0, b.x0), max(cy0, b.y0)
                    x1, y1 = min(cx0 + (1 << cbgw), b.x1), min(cy0 + (1 << cbgh), b.y1)
                    if x1 <= x0 or y1 <= y0:
                        b.precincts.append(Precinct(0, 0))
                        continue
                    bx0 = (x0 >> cbw) << cbw
                    by0 = (y0 >> cbh) << cbh
                    b.precincts.append(Precinct((ceil_pow2(x1, cbw) << cbw) - bx0 >> cbw,
                                                (ceil_pow2(y1, cbh) << cbh) - by0 >> cbh,
                                                (x0, y0, x1, y1), cbw, cbh))
                res.bands.append(b)
            tc.res.append(res)
        out.append(tc)
    return out


def packet_order(cs, coding, comps: list, rect) -> list:
    """(layer, res, comp, precinct) of every packet of a tile, in the order
    of its progression, or of its POC entries (``opj_pi_next_*``; a packet
    already given is not given again)."""
    tx0, ty0, tx1, ty1 = rect
    nc = len(comps)
    maxres = max(len(tc.res) for tc in comps)
    entries = coding.pocs or [(0, 0, coding.layers, maxres, nc, coding.progression)]
    seen = set()
    out = []

    def emit(l, r, c, p):
        key = (l, r, c, p)
        if key not in seen:
            seen.add(key)
            out.append(key)

    for rs, cs0, lye, re_, ce, order in entries:
        lye = min(lye, coding.layers)
        re_ = min(re_, maxres)
        ce = min(ce, nc)
        if order in (0, 1):
            outer = [(l, r) for l in range(lye) for r in range(rs, re_)] if order == 0 else \
                [(l, r) for r in range(rs, re_) for l in range(lye)]
            for l, r in outer:
                for c in range(cs0, ce):
                    tc = comps[c]
                    if r >= len(tc.res):
                        continue
                    res = tc.res[r]
                    for p in range(res.pw * res.ph):
                        emit(l, r, c, p)
            continue
        # position-driven orders (RPCL, PCRL, CPRL)
        dx = dy = 0
        for c in range(nc):
            tc = comps[c]
            for r, res in enumerate(tc.res):
                lv = len(tc.res) - 1 - r
                ddx = tc.comp.dx * (1 << (res.pdx + lv))
                ddy = tc.comp.dy * (1 << (res.pdy + lv))
                dx = ddx if not dx else min(dx, ddx)
                dy = ddy if not dy else min(dy, ddy)
        if not dx or not dy:
            continue

        def steps(lo, hi, d):
            v = lo
            while v < hi:
                yield v
                v += d - (v % d)

        def at(c, r, x, y):
            tc = comps[c]
            if r >= len(tc.res):
                return None
            res = tc.res[r]
            lv = len(tc.res) - 1 - r
            cdx, cdy = tc.comp.dx, tc.comp.dy
            trx0, try0 = ceil_div(tx0, cdx << lv), ceil_div(ty0, cdy << lv)
            trx1, try1 = ceil_div(tx1, cdx << lv), ceil_div(ty1, cdy << lv)
            rpx, rpy = res.pdx + lv, res.pdy + lv
            if not (y % (cdy << rpy) == 0 or (y == ty0 and (try0 << lv) % (1 << rpy))):
                return None
            if not (x % (cdx << rpx) == 0 or (x == tx0 and (trx0 << lv) % (1 << rpx))):
                return None
            if res.pw == 0 or res.ph == 0 or trx0 == trx1 or try0 == try1:
                return None
            prci = (ceil_div(x, cdx << lv) >> res.pdx) - (trx0 >> res.pdx)
            prcj = (ceil_div(y, cdy << lv) >> res.pdy) - (try0 >> res.pdy)
            return prci + prcj * res.pw

        if order == 2:       # RPCL
            for r in range(rs, re_):
                for y in steps(ty0, ty1, dy):
                    for x in steps(tx0, tx1, dx):
                        for c in range(cs0, ce):
                            p = at(c, r, x, y)
                            if p is not None:
                                for l in range(lye):
                                    emit(l, r, c, p)
        elif order == 3:     # PCRL
            for y in steps(ty0, ty1, dy):
                for x in steps(tx0, tx1, dx):
                    for c in range(cs0, ce):
                        for r in range(rs, re_):
                            p = at(c, r, x, y)
                            if p is not None:
                                for l in range(lye):
                                    emit(l, r, c, p)
        else:                # CPRL
            for c in range(cs0, ce):
                tc = comps[c]
                cdx = cdy = 0
                for r, res in enumerate(tc.res):
                    lv = len(tc.res) - 1 - r
                    ddx = tc.comp.dx * (1 << (res.pdx + lv))
                    ddy = tc.comp.dy * (1 << (res.pdy + lv))
                    cdx = ddx if not cdx else min(cdx, ddx)
                    cdy = ddy if not cdy else min(cdy, ddy)
                for y in steps(ty0, ty1, cdy):
                    for x in steps(tx0, tx1, cdx):
                        for r in range(rs, re_):
                            p = at(c, r, x, y)
                            if p is not None:
                                for l in range(lye):
                                    emit(l, r, c, p)
    return out


def _seg_max(style: int, segs: list) -> int:
    """``opj_t2_init_seg``: the passes the next codeword segment may hold."""
    if style & 4:                  # TERMALL
        return 1
    if style & 1:                  # BYPASS
        if not segs:
            return 10
        return 2 if segs[-1][1] in (1, 10) else 1
    return 109


def decode_packets(comps, coding, order, data: bytes, headers: bytes | None):
    """Read a tile's packets in `order` from `data` (the tile-parts' bodies
    joined); their headers from `headers` when PPM / PPT packed them."""
    sop, eph = coding.csty & 2, coding.csty & 4
    pos, end = 0, len(data)
    hpos, hend = 0, len(headers) if headers is not None else 0
    for l, r, c, p in order:
        tc = comps[c]
        res = tc.res[r]
        style = tc.style.cblksty
        if pos >= end and headers is None:
            break            # a truncated tile: the packets left are empty
        if sop and pos + 6 <= end and data[pos] == 0xFF and data[pos + 1] == 0x91:
            pos += 6
        src, start, stop = (headers, hpos, hend) if headers is not None else (data, pos, end)
        bio = BitReader(src, start, stop)
        if l == 0:
            for b in res.bands:
                prc = b.precincts[p]
                if prc.built:          # trees not made yet are fresh
                    prc.incl.reset()
                    prc.imsb.reset()
        present = bio.read(1)
        contrib = []
        if present:
            for b in res.bands:
                prc = b.precincts[p]
                for k, cb in enumerate(prc.cblks):
                    if not cb.included:
                        inc = prc.incl.decode(bio, k, l + 1)
                    else:
                        inc = bio.read(1)
                    if not inc:
                        continue
                    if not cb.included:
                        i = 0
                        while not prc.imsb.decode(bio, k, i):
                            i += 1
                            if i > 64:
                                raise CodestreamError("a bad zero bit-plane count")
                        cb.numbps = b.numbps + 1 - i
                        cb.numlenbits = 3
                        cb.included = True
                    n = _numpasses(bio)
                    while bio.read(1):
                        cb.numlenbits += 1
                    if not cb.segs or cb.segs[-1][0] == cb.segs[-1][1]:
                        cb.segs.append([0, _seg_max(style, cb.segs), bytearray()])
                    parts = []
                    while n > 0:
                        seg = cb.segs[-1]
                        take = min(seg[1] - seg[0], n)
                        nbits = cb.numlenbits + (take.bit_length() - 1)
                        if nbits > 32:
                            raise CodestreamError("a codeword segment length of over 32 bits")
                        parts.append((seg, take, bio.read(nbits)))
                        seg[0] += take
                        n -= take
                        if n > 0:
                            cb.segs.append([0, _seg_max(style, cb.segs), bytearray()])
                    contrib.append((cb, parts))
        after = bio.align()
        if headers is not None:
            hpos = after
            if eph and hpos + 2 <= hend and headers[hpos] == 0xFF and headers[hpos + 1] == 0x92:
                hpos += 2
        else:
            pos = after
            if eph and pos + 2 <= end and data[pos] == 0xFF and data[pos + 1] == 0x92:
                pos += 2
        for cb, parts in contrib:
            for seg, take, length in parts:
                if pos + length > end:
                    raise CodestreamError("a code-block's data runs past its tile-part")
                seg[2] += data[pos:pos + length]
                cb.npasses += take
                pos += length
                if cb.npasses > 164:
                    raise CodestreamError("a code-block of more than 164 passes")


def _numpasses(bio) -> int:
    if not bio.read(1):
        return 1
    if not bio.read(1):
        return 2
    n = bio.read(2)
    if n != 3:
        return 3 + n
    n = bio.read(5)
    if n != 31:
        return 6 + n
    return 37 + bio.read(7)


def _put_numpasses(bio, n: int):
    if n == 1:
        bio.write(0, 1)
    elif n == 2:
        bio.write(2, 2)
    elif n <= 5:
        bio.write(0xC | (n - 3), 4)
    elif n <= 36:
        bio.write(0x1E0 | (n - 6), 9)
    else:
        bio.write(0xFF80 | (n - 37), 16)


def encode_packet(tc, r: int, p: int, layer: int, layer_passes, sop_index=None,
                  eph=False) -> tuple[bytes, bytes]:
    """One packet (``opj_t2_encode_packet``): its header and its body.
    `layer_passes(cb)` gives the code-block's passes in this layer as
    (passes, [lengths of the segments it ends or continues])."""
    res = tc.res[r]
    if layer == 0:
        for b in res.bands:
            prc = b.precincts[p]
            if not prc.cblks:
                continue
            prc.incl.reset()
            prc.imsb.reset()
            for k, cb in enumerate(prc.cblks):
                cb.npasses = 0
                prc.imsb.set_value(k, b.numbps - cb.enc.numbps)
    work = []
    for b in res.bands:
        prc = b.precincts[p]
        for k, cb in enumerate(prc.cblks):
            npass, lens = layer_passes(cb)
            work.append((b, prc, k, cb, npass, lens))
    bio = BitWriter()
    bio.write(1, 1)             # OpenJPEG writes a packet as present even with nothing in it
    for b, prc, k, cb, npass, lens in work:
        if cb.npasses == 0 and npass:
            prc.incl.set_value(k, layer)
    for b, prc, k, cb, npass, lens in work:
        if cb.npasses == 0:
            prc.incl.encode(bio, k, layer + 1)
        else:
            bio.write(1 if npass else 0, 1)
        if not npass:
            continue
        if cb.npasses == 0:
            cb.numlenbits = 3
            prc.imsb.encode(bio, k, 999)
        _put_numpasses(bio, npass)
        increment = 0
        for nump, length in lens:
            increment = max(increment, length.bit_length() - (cb.numlenbits +
                                                             nump.bit_length() - 1))
        bio.write((1 << increment) - 1, increment)
        bio.write(0, 1)
        cb.numlenbits += increment
        for nump, length in lens:
            bio.write(length, cb.numlenbits + nump.bit_length() - 1)
    header = bio.flush()
    if eph:
        header += b"\xff\x92"
    if sop_index is not None:
        header = b"\xff\x91\x00\x04" + (sop_index & 0xFFFF).to_bytes(2, "big") + header
    body = bytearray()
    for b, prc, k, cb, npass, lens in work:
        if npass:
            start = cb.enc.pass_ends[cb.npasses - 1] if cb.npasses else 0
            stop = cb.enc.pass_ends[cb.npasses + npass - 1]
            body += cb.enc.data[start:stop]
            cb.npasses += npass
    return header, bytes(body)
