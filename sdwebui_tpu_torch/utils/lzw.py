"""The two LZW codecs of the image formats: GIF's and TIFF's.

GIF (``decode_gif`` / ``encode_gif``): codes packed LSB-first, the code
size growing from ``min_size + 1`` bits when the table reaches a power of
two, up to 12 bits; ``1 << min_size`` clears the table and the next code
ends the data, and the encoder clears the table when it is full.  TIFF
(``decode_tiff``): 8-bit symbols, codes packed MSB-first from 9 bits, 256
clears and 257 ends, and the code size grows one entry early ("early
change"), as libtiff reads it.
"""

from __future__ import annotations


def decode_gif(data: bytes, min_size: int, limit: int) -> bytes:
    """GIF LZW data (the sub-blocks already joined) → at most `limit`
    index bytes."""
    if not 1 <= min_size <= 11:
        raise ValueError(f"bad GIF LZW code size {min_size}")
    clear = 1 << min_size
    end = clear + 1
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    table = list(base)
    size = min_size + 1
    mask = (1 << size) - 1
    out = bytearray()
    buf = nbits = pos = 0
    n = len(data)
    prev = None
    while len(out) < limit:
        while nbits < size:
            if pos >= n:
                return bytes(out)
            buf |= data[pos] << nbits
            pos += 1
            nbits += 8
        code = buf & mask
        buf >>= size
        nbits -= size
        if code == clear:
            table = list(base)
            size = min_size + 1
            mask = (1 << size) - 1
            prev = None
            continue
        if code == end:
            break
        if prev is None:
            if code >= clear:
                raise ValueError("GIF LZW data starts with an undefined code")
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
                new = prev + entry[:1]
            elif code == len(table):
                entry = new = prev + prev[:1]
            else:
                raise ValueError("bad GIF LZW code")
            if len(table) < 4096:
                table.append(new)
                if len(table) == 1 << size and size < 12:
                    size += 1
                    mask = (1 << size) - 1
        out += entry
        prev = entry
    return bytes(out[:limit])


def encode_gif(data: bytes, min_size: int) -> bytes:
    """Index bytes (each < 2**min_size) → GIF LZW data, not yet cut into
    sub-blocks."""
    clear = 1 << min_size
    end = clear + 1
    out = bytearray()
    acc = nacc = 0
    size = min_size + 1

    def emit(code: int):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    emit(clear)
    table: dict = {}
    next_code = clear + 2
    dec_len, first = clear + 2, True     # the decoder's table, one code behind
    if not data:
        emit(end)
        return bytes(out + (bytes([acc]) if nacc else b""))
    prefix = data[0]
    for b in data[1:]:
        key = (prefix << 8) | b
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if not first and dec_len < 4096:
            dec_len += 1
            if dec_len == 1 << size and size < 12:
                size += 1
        first = False
        table[key] = next_code
        next_code += 1
        if next_code == 4096:
            emit(clear)
            table.clear()
            next_code = clear + 2
            dec_len, first, size = clear + 2, True, min_size + 1
        prefix = b
    emit(prefix)
    if not first and dec_len < 4096:
        dec_len += 1
        if dec_len == 1 << size and size < 12:
            size += 1
    emit(end)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def decode_tiff(data: bytes, limit: int) -> bytes:
    """One TIFF LZW strip or tile → at most `limit` bytes."""
    if len(data) >= 2 and data[0] == 0 and data[1] & 1:
        raise ValueError("old-style (LSB-first) TIFF LZW is not read")
    base = [bytes([i]) for i in range(256)] + [b"", b""]
    table = list(base)
    size = 9
    out = bytearray()
    buf = nbits = pos = 0
    n = len(data)
    prev = None
    while len(out) < limit:
        while nbits < size:
            if pos >= n:
                return bytes(out)
            buf = (buf << 8) | data[pos]
            pos += 1
            nbits += 8
        nbits -= size
        code = (buf >> nbits) & ((1 << size) - 1)
        buf &= (1 << nbits) - 1
        if code == 256:
            table = list(base)
            size = 9
            prev = None
            continue
        if code == 257:
            break
        if prev is None:
            if code > 255:
                raise ValueError("TIFF LZW data starts with an undefined code")
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
                new = prev + entry[:1]
            elif code == len(table):
                entry = new = prev + prev[:1]
            else:
                raise ValueError("bad TIFF LZW code")
            if len(table) < 4096:
                table.append(new)
                if len(table) == (1 << size) - 1 and size < 12:
                    size += 1
        out += entry
        prev = entry
    return bytes(out[:limit])
