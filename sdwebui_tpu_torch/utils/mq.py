"""The MQ arithmetic coder of JPEG 2000 (ISO 15444-1 annex C) as OpenJPEG
codes it, one code-block segment at a time, in plain Python.

A context's state is one of the 94 (state, MPS) pairs of table C.2, kept as
``2 · state + mps``.  ``MQDecoder`` reads a segment as ``opj_mqc_init_dec``,
``opj_mqc_decode`` and ``opj_mqc_raw_decode`` do, over its bytes with the
two 0xFF OpenJPEG appends: a byte after 0xFF gives 7 bits (its top bit a
carry into C, which is 32 bits), a 0xFF followed by a byte over 0x8F gives
1 bits from there on.  ``MQEncoder`` writes a code-block's bytes as
``opj_mqc_encode`` / ``byteout`` / ``flush`` / ``restart_init_enc`` and the
raw coder ``opj_mqc_bypass_*`` do, with OpenJPEG's pointer into its buffer:
a placeholder byte before the first, and a terminated segment's last byte
incremented by a carry of the next, as OpenJPEG's is."""

from __future__ import annotations

#: table C.2: Qe, next index after an MPS, after an LPS, and the MPS switch
_TABLE = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0), (0x0AC1, 4, 12, 0),
    (0x0521, 5, 29, 0), (0x0221, 38, 33, 0), (0x5601, 7, 6, 1), (0x5401, 8, 14, 0),
    (0x4801, 9, 14, 0), (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1), (0x5401, 16, 14, 0),
    (0x5101, 17, 15, 0), (0x4801, 18, 16, 0), (0x3801, 19, 17, 0), (0x3401, 20, 18, 0),
    (0x3001, 21, 19, 0), (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0), (0x1401, 28, 25, 0),
    (0x1201, 29, 26, 0), (0x1101, 30, 27, 0), (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0),
    (0x08A1, 33, 30, 0), (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0), (0x0085, 40, 37, 0),
    (0x0049, 41, 38, 0), (0x0025, 42, 39, 0), (0x0015, 43, 40, 0), (0x0009, 44, 41, 0),
    (0x0005, 45, 42, 0), (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
)
#: per combined state 2·state + mps: Qe, the MPS, the state after an MPS / an LPS
QE = [_TABLE[s >> 1][0] for s in range(94)]
MPS = [s & 1 for s in range(94)]
NMPS = [2 * _TABLE[s >> 1][1] + (s & 1) for s in range(94)]
NLPS = [2 * _TABLE[s >> 1][2] + ((s & 1) ^ _TABLE[s >> 1][3]) for s in range(94)]

#: the contexts, numbered from 1 (entry 0 is unused):
#: zero coding 1-9, sign coding 10-14, magnitude refinement 15-17,
#: run length 18, uniform 19
NCTX = 20
CTX_ZC, CTX_SC, CTX_MAG, CTX_AGG, CTX_UNI = 1, 10, 15, 18, 19


def initial_contexts() -> list:
    """The NCTX context states as ``opj_mqc_resetstates`` and the three
    ``opj_mqc_setstate`` calls of tier-1 leave them."""
    cx = [0] * NCTX
    cx[CTX_UNI] = 2 * 46
    cx[CTX_AGG] = 2 * 3
    cx[CTX_ZC] = 2 * 4
    return cx


class MQDecoder:
    """``opj_mqc`` decoding one codeword segment: MQ (``decode``) or raw
    (``raw``), in the contexts `cx` (a list the caller keeps)."""

    __slots__ = ("d", "bp", "a", "c", "ct", "cx")

    def __init__(self, data: bytes, raw: bool, cx: list):
        self.d = data + b"\xff\xff"
        self.cx = cx
        self.bp = 0
        if raw:
            self.c = self.ct = 0
            return
        self.c = self.d[0] << 16 if data else 0xFF << 16
        self.ct = 0
        self._bytein()
        self.c <<= 7
        self.ct -= 7
        self.a = 0x8000

    def _bytein(self):
        d, bp = self.d, self.bp
        nxt = d[bp + 1] if bp + 1 < len(d) else 0xFF
        if d[bp] == 0xFF:
            if nxt > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp = bp + 1
                self.c = (self.c + (nxt << 9)) & 0xFFFFFFFF     # a carry, in 32 bits
                self.ct = 7
        else:
            self.bp = bp + 1
            self.c += nxt << 8
            self.ct = 8

    def decode(self, k: int) -> int:
        cx = self.cx
        s = cx[k]
        qe = QE[s]
        a = self.a - qe
        c = self.c
        if (c >> 16) < qe:
            if a < qe:
                d = MPS[s]
                cx[k] = NMPS[s]
            else:
                d = 1 - MPS[s]
                cx[k] = NLPS[s]
            a = qe
        else:
            c -= qe << 16
            if a & 0x8000:
                self.a, self.c = a, c
                return MPS[s]
            if a < qe:
                d = 1 - MPS[s]
                cx[k] = NLPS[s]
            else:
                d = MPS[s]
                cx[k] = NMPS[s]
        ct = self.ct
        while True:
            if ct == 0:
                self.c = c
                self._bytein()
                c, ct = self.c, self.ct
            a <<= 1
            c = (c << 1) & 0xFFFFFFFF
            ct -= 1
            if a >= 0x8000:
                break
        self.a, self.c, self.ct = a, c, ct
        return d

    def raw(self) -> int:
        if self.ct == 0:
            d, bp = self.d, self.bp
            byte = d[bp] if bp < len(d) else 0xFF
            if self.c == 0xFF:
                if byte > 0x8F:
                    self.c, self.ct = 0xFF, 8
                else:
                    self.c, self.ct, self.bp = byte, 7, bp + 1
            else:
                self.c, self.ct, self.bp = byte, 8, bp + 1
        self.ct -= 1
        return (self.c >> self.ct) & 1


#: ``BYPASS_CT_INIT``: no raw bit written since the raw coder started
_RAW_FRESH = -1


class MQEncoder:
    """``opj_mqc`` encoding one code-block: ``buf`` holds a placeholder byte
    and then the block's bytes, ``bp`` is OpenJPEG's pointer into it (the
    last byte written; past it after a flush), ``numbytes()`` the bytes so
    far.  ``encode`` codes a decision, ``bypass`` a raw bit; ``flush`` /
    ``bypass_flush`` end a segment and ``restart`` / ``bypass_start`` begin
    the next."""

    __slots__ = ("a", "c", "ct", "buf", "bp", "cx")

    def __init__(self):
        self.a, self.c, self.ct = 0x8000, 0, 12
        self.buf = bytearray(1)
        self.bp = 0
        self.cx = initial_contexts()

    def numbytes(self) -> int:
        return self.bp - 1

    def _put(self, byte: int):
        """Write `byte` past ``bp`` and move to it."""
        self.bp += 1
        del self.buf[self.bp:]
        self.buf.append(byte & 0xFF)

    def _byteout(self):
        buf, bp = self.buf, self.bp
        if buf[bp] == 0xFF:
            self._put(self.c >> 20)
            self.c &= 0xFFFFF
            self.ct = 7
        elif not self.c & 0x8000000:
            self._put(self.c >> 19)
            self.c &= 0x7FFFF
            self.ct = 8
        else:
            buf[bp] += 1
            if buf[bp] == 0xFF:
                self.c &= 0x7FFFFFF
                self._put(self.c >> 20)
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                self._put(self.c >> 19)
                self.c &= 0x7FFFF
                self.ct = 8

    def encode(self, k: int, d: int):
        cx = self.cx
        s = cx[k]
        qe = QE[s]
        a = self.a - qe
        if d == MPS[s]:
            if a & 0x8000:
                self.a = a
                self.c += qe
                return
            if a < qe:
                a = qe
            else:
                self.c += qe
            cx[k] = NMPS[s]
        else:
            if a < qe:
                self.c += qe
            else:
                a = qe
            cx[k] = NLPS[s]
        ct = self.ct
        while True:
            a <<= 1
            self.c <<= 1
            ct -= 1
            if ct == 0:
                self.ct = ct
                self._byteout()
                ct = self.ct
            if a & 0x8000:
                break
        self.a, self.ct = a, ct

    def flush(self):
        """``opj_mqc_flush``: SETBITS, two bytes out; a last 0xFF is not counted."""
        temp = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= temp:
            self.c -= 0x8000
        self.c <<= self.ct
        self._byteout()
        self.c <<= self.ct
        self._byteout()
        if self.buf[self.bp] != 0xFF:
            self.bp += 1

    def restart(self):
        """``opj_mqc_restart_init_enc``: a new MQ segment after a flush."""
        self.a, self.c, self.ct = 0x8000, 0, 12
        self.bp -= 1
        if self.buf[self.bp] == 0xFF:
            self.ct = 13

    def reset_contexts(self):
        self.cx[:] = initial_contexts()

    def bypass_start(self):
        """``opj_mqc_bypass_init_enc``: a raw segment after a flush."""
        self.c, self.ct = 0, _RAW_FRESH

    def bypass(self, d: int):
        """``opj_mqc_bypass_enc``: one raw bit, a byte out every 8 (7 after 0xFF)."""
        if self.ct == _RAW_FRESH:
            self.ct = 8
        self.ct -= 1
        self.c += d << self.ct
        if self.ct == 0:
            self._at(self.c)
            self.ct = 7 if self.c == 0xFF else 8
            self.c = 0

    def _at(self, byte: int):
        """Write `byte` at ``bp`` and move past it (the raw coder's pointer
        is the next byte's place)."""
        del self.buf[self.bp:]
        self.buf.append(byte & 0xFF)
        self.bp += 1

    def bypass_extra(self) -> int:
        """``opj_mqc_bypass_get_extra_bytes``: the byte a pass ending here
        would still take."""
        return 1 if self.ct != _RAW_FRESH and (
            self.ct < 7 or (self.ct == 7 and self.buf[self.bp - 1] != 0xFF)) else 0

    def bypass_flush(self):
        """``opj_mqc_bypass_flush_enc``: the last bits padded with 0, 1, 0, ...;
        a last 0xFF, or a last 0xFF 0x7F, dropped."""
        ct, last = self.ct, self.buf[self.bp - 1]
        if ct != _RAW_FRESH and (ct < 7 or (ct == 7 and last != 0xFF)):
            bit = 0
            while self.ct > 0:
                self.ct -= 1
                self.c += bit << self.ct
                bit = 1 - bit
            self._at(self.c)
        elif ct == 7 and last == 0xFF:
            self.bp -= 1
        elif ct == 8 and last == 0x7F and self.buf[self.bp - 2] == 0xFF:
            self.bp -= 2

    def data(self) -> bytes:
        """The block's bytes: those counted by ``numbytes``."""
        return bytes(self.buf[1:self.bp])
