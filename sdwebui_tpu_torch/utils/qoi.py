"""QOI ("Quite OK Image") reading and writing, as Pillow's
``QoiImagePlugin`` does.

The reader is Pillow's ``QoiDecoder``: INDEX, DIFF, LUMA, RUN, RGB and RGBA
ops from a previous pixel of (0, 0, 0, 255) and an empty index table (a
miss reads (0, 0, 0, 0)); three channels read as RGB, any other count as
RGBA.  It runs one op at a time on the host (about a second at 512²).

The writer gives the bytes of Pillow's ``QoiEncoder`` (colour space 1,
the 8-byte end marker), computed on whole arrays: the index table's hits
are found by comparing each pixel with the last earlier pixel of the same
hash that was not part of a run, which is what the table holds when the
encoder reaches it."""

from __future__ import annotations

import struct

import numpy as np

from sdwebui_tpu_torch.utils.png import check_image_size


def decode_qoi(data: bytes) -> tuple[np.ndarray, dict]:
    """QOI bytes → (uint8 (H, W, 3|4), {})."""
    if not data.startswith(b"qoif") or len(data) < 14:
        raise ValueError("not a QOI file")
    w, h = struct.unpack_from(">II", data, 4)
    check_image_size(w, h)
    bands = 3 if data[12] == 3 else 4
    total = w * h
    out = np.empty((total, 4), np.uint8)
    seen = [(0, 0, 0, 0)] * 64
    r, g, b, a = 0, 0, 0, 255
    pos, i, n = 14, 0, len(data)
    mv = memoryview(data)
    while i < total:
        if pos >= n:
            raise ValueError("QOI: image file is truncated")
        byte = mv[pos]
        pos += 1
        if byte == 0xFE:
            r, g, b = mv[pos], mv[pos + 1], mv[pos + 2]
            pos += 3
        elif byte == 0xFF:
            r, g, b, a = mv[pos], mv[pos + 1], mv[pos + 2], mv[pos + 3]
            pos += 4
        else:
            op = byte >> 6
            if op == 0:
                r, g, b, a = seen[byte & 63]
            elif op == 1:
                r = (r + ((byte >> 4) & 3) - 2) & 255
                g = (g + ((byte >> 2) & 3) - 2) & 255
                b = (b + (byte & 3) - 2) & 255
            elif op == 2:
                second = mv[pos]
                pos += 1
                dg = (byte & 63) - 32
                r = (r + dg + (second >> 4) - 8) & 255
                g = (g + dg) & 255
                b = (b + dg + (second & 15) - 8) & 255
            else:
                run = (byte & 63) + 1
                out[i:i + run] = (r, g, b, a)
                i += run
                continue
        seen[(r * 3 + g * 5 + b * 7 + a * 11) % 64] = (r, g, b, a)
        out[i] = (r, g, b, a)
        i += 1
    image = out[:total].reshape(h, w, 4)
    return np.ascontiguousarray(image[:, :, :bands]), {}


def _signed(d: np.ndarray) -> np.ndarray:
    d = d & 255
    return np.where(d >= 128, d - 256, d)


def encode_qoi(image: np.ndarray) -> bytes:
    """uint8 (H, W, 3|4) → Pillow's QOI bytes."""
    a = np.asarray(image)
    h, w, c = a.shape
    if c not in (3, 4):
        raise ValueError("Unsupported QOI image mode")
    px = np.empty((h * w, 4), np.int32)
    px[:, :c] = a.reshape(-1, c)
    if c == 3:
        px[:, 3] = 255
    prev = np.empty_like(px)
    prev[0] = (0, 0, 0, 255)
    prev[1:] = px[:-1]
    same = (px == prev).all(axis=1)

    # runs: each stretch of pixels equal to the one before, in chunks of 62
    edge = np.diff(np.concatenate([[0], same.astype(np.int8), [0]]))
    starts, ends = np.flatnonzero(edge == 1), np.flatnonzero(edge == -1)
    lengths = ends - starts
    chunks = (lengths + 61) // 62
    run_key = np.repeat(starts, chunks)
    first = np.repeat(np.cumsum(chunks) - chunks, chunks)
    k = np.arange(len(run_key)) - first                 # chunk number within its stretch
    run_len = np.minimum(62, np.repeat(lengths, chunks) - 62 * k)
    run_bytes = np.zeros((len(run_key), 5), np.int32)
    run_bytes[:, 0] = 0xC0 | (run_len - 1)
    run_n = np.ones(len(run_key), np.int32)

    # the other pixels: an index hit, else DIFF, LUMA, RGB or RGBA
    idx = np.flatnonzero(~same)
    p, q = px[idx], prev[idx]
    hsh = (p[:, 0] * 3 + p[:, 1] * 5 + p[:, 2] * 7 + p[:, 3] * 11) % 64
    order = np.argsort(hsh, kind="stable")
    hit = np.zeros(len(idx), bool)
    sh = hsh[order]
    po = p[order]
    same_group = sh[1:] == sh[:-1]
    hit_sorted = np.zeros(len(idx), bool)
    hit_sorted[1:] = same_group & (po[1:] == po[:-1]).all(axis=1)
    group_first = np.ones(len(idx), bool)
    group_first[1:] = ~same_group
    hit_sorted |= group_first & (sh == 0) & (po == 0).all(axis=1)
    hit[order] = hit_sorted
    dr, dg, db = (_signed(p[:, ch] - q[:, ch]) for ch in range(3))
    dgr, dgb = _signed(dr - dg), _signed(db - dg)
    same_a = p[:, 3] == q[:, 3]
    diff = same_a & (dr >= -2) & (dr < 2) & (dg >= -2) & (dg < 2) & (db >= -2) & (db < 2)
    luma = same_a & ~diff & (dgr >= -8) & (dgr < 8) & (dg >= -32) & (dg < 32) & \
        (dgb >= -8) & (dgb < 8)
    rgb = same_a & ~diff & ~luma
    op = np.zeros((len(idx), 5), np.int32)
    nb = np.ones(len(idx), np.int32)
    op[:, 0] = np.where(hit, hsh, 0)
    m = ~hit & diff
    op[m, 0] = 0x40 | (dr[m] + 2) << 4 | (dg[m] + 2) << 2 | (db[m] + 2)
    m = ~hit & luma
    op[m, 0] = 0x80 | (dg[m] + 32)
    op[m, 1] = (dgr[m] + 8) << 4 | (dgb[m] + 8)
    nb[m] = 2
    m = ~hit & rgb
    op[m, 0] = 0xFE
    op[m, 1:4] = p[m, :3]
    nb[m] = 4
    m = ~hit & ~same_a
    op[m, 0] = 0xFF
    op[m, 1:5] = p[m]
    nb[m] = 5

    keys = np.concatenate([run_key, idx])
    allb = np.concatenate([run_bytes, op])
    alln = np.concatenate([run_n, nb])
    order = np.argsort(keys, kind="stable")
    allb, alln = allb[order], alln[order]
    body = allb[np.arange(5)[None, :] < alln[:, None]].astype(np.uint8).tobytes()
    return (b"qoif" + struct.pack(">IIBB", w, h, c, 1) + body
            + bytes((0, 0, 0, 0, 0, 0, 0, 1)))
