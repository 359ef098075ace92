"""JPEG 2000 as the JAX package's Pillow 12.1 reads and writes it through
OpenJPEG 2.5.4: the entry points of the codec.

``decode_jpeg2000(data)`` → uint8 (H, W, C) pixels as Pillow's ``convert``
sees the mode ``Image.open`` gives, and the ``info`` Pillow fills
(``comment`` from the first COM marker, ``dpi`` from a ``resc`` box).  The
codestream (``utils/j2k_codestream``) is read tile by tile: tier-2
(``utils/j2k_t2``), tier-1 for every code-block of the image at once
(``utils/j2k_t1``), dequantization, the inverse wavelet
(``utils/j2k_dwt``), the inverse RCT or ICT, the DC level shift with
OpenJPEG's rounding and clamping; then Pillow's unpackers
(``Jpeg2KDecode.c``: the shift to 8 bits with its rounding offset, the sign
offset, nearest-neighbour subsampled components, sYCC → RGB as Pillow's
YCbCr conversion within 1 level) and ``utils/image_modes``.

``encode_jpeg2000(image, kind)`` writes Pillow's bytes for JAX's
``image.save(f, format="JPEG2000")`` of an L, LA, RGB or RGBA image:
OpenJPEG's defaults as Pillow sets them (one layer, LRCP, no MCT, 64×64
code-blocks, the reversible 5/3 with as many as five levels, fewer for a
small image; its COM), a raw codestream for ``kind`` "j2k" and JP2 boxes
for "jp2".  The keyword arguments after `kind` are encoder settings the
fixture tool alone passes."""

from __future__ import annotations

import numpy as np

from sdwebui_tpu_torch.utils import j2k_codestream as j2c
from sdwebui_tpu_torch.utils import j2k_dwt, j2k_t1, j2k_t2, jp2
from sdwebui_tpu_torch.utils.image_modes import NotThisFormat, as_output
from sdwebui_tpu_torch.utils.png import check_image_size

# -- reading


def _pillow_comment(data: bytes, o: int):
    """Pillow's ``_parse_comment`` from offset `o` (just past SIZ)."""
    while o + 2 <= len(data):
        typ = data[o + 1]
        if typ in (0x90, 0xD9):
            return None
        if o + 4 > len(data):
            return None
        length = int.from_bytes(data[o + 2:o + 4], "big")
        if typ == 0x64:
            return bytes(data[o + 4:o + 2 + length][2:])
        o += 2 + length
    return None


def _codestream_mode(data: bytes, o: int) -> str:
    """Pillow's ``_parse_codestream`` on the SIZ at `o` (past SOC)."""
    if len(data) < o + 42:
        raise NotThisFormat("a truncated SIZ marker")
    csiz = int.from_bytes(data[o + 36:o + 38], "big")
    if csiz == 1:
        return "I;16" if (data[o + 38] & 0x7F) + 1 > 8 else "L"
    mode = {2: "LA", 3: "RGB", 4: "RGBA"}.get(csiz)
    if mode is None:
        raise NotThisFormat("unable to determine J2K image mode")
    return mode


# Pillow's ImagingConvertYCbCr2RGB: tables in 1/64 (ConvertYCbCr.c, SCALE 6).
# Its tables are not these (ROADMAP C): these come within 1 level of them.
def _ycc_table(coef: float) -> np.ndarray:
    return np.trunc(coef * (np.arange(256) - 128) * 64).astype(np.int64)


_R_CR, _G_CB, _G_CR, _B_CB = (_ycc_table(1.40200), _ycc_table(-0.34414),
                              _ycc_table(-0.71414), _ycc_table(1.77200))


def _ycbcr_to_rgb(ycc: np.ndarray) -> np.ndarray:
    y, cb, cr = (ycc[..., k].astype(np.int64) for k in range(3))
    r = y + (_R_CR[cr] >> 6)
    g = y + ((_G_CB[cb] + _G_CR[cr]) >> 6)
    b = y + (_B_CB[cb] >> 6)
    return np.clip(np.stack([r, g, b], -1), 0, 255)


#: Pillow's (mode, colour space, components) → unpacker, and whether the
#: unpacker reads subsampled components
_UNPACKERS = {
    ("L", "grey", 1): ("gray_l", False), ("P", "sRGB", 1): ("gray_l", False),
    ("PA", "sRGB", 2): ("graya_la", False), ("I;16", "grey", 1): ("gray_i", False),
    ("LA", "grey", 2): ("graya_la", False),
    ("RGB", "grey", 1): ("gray_rgb", False), ("RGB", "grey", 2): ("gray_rgb", False),
    ("RGB", "sRGB", 3): ("srgb_rgb", True), ("RGB", "sYCC", 3): ("sycc_rgb", True),
    ("RGB", "sRGB", 4): ("srgb_rgb", True), ("RGB", "sYCC", 4): ("sycc_rgb", True),
    ("RGBA", "grey", 1): ("gray_rgb", False), ("RGBA", "grey", 2): ("graya_la", False),
    ("RGBA", "sRGB", 3): ("srgb_rgb", True), ("RGBA", "sYCC", 3): ("sycc_rgb", True),
    ("RGBA", "sRGB", 4): ("srgba_rgba", True), ("RGBA", "sYCC", 4): ("sycca_rgba", True),
    ("CMYK", "CMYK", 4): ("srgba_rgba", True),
}


def _words(samples, comps, w, h, n, subsampled):
    """Pillow's view of component `n` of a tile: int32 (h, w).  OpenJPEG's
    tile data holds every component's samples, each at its own size, in
    (prec + 7) / 8 bytes; Pillow reads component n at (y / dy)·(w / dx) +
    x / dx past the sizes it assumes for the components before it (its
    grey unpackers assume no subsampling).  Where those components are
    whole (h, w) planes, that is component n's own samples' low bytes."""
    csiz = [(c.prec + 7) >> 3 for c in comps]
    sub = [(c.dx, c.dy) if subsampled else (1, 1) for c in comps]
    if all(samples[k].shape == (h, w) and sub[k] == (1, 1) for k in range(n + 1)):
        return samples[n].astype(np.int32) & ((1 << (8 * csiz[n])) - 1)
    parts = [np.ascontiguousarray(s, "<i4").reshape(-1, 1).view(np.uint8)[:, :csiz[k]].reshape(-1)
             for k, s in enumerate(samples)]
    buf = np.concatenate(parts + [np.zeros(4 * w * h + 16, np.uint8)])
    base = sum(csiz[k] * (w // sub[k][0]) * (h // sub[k][1]) for k in range(n))
    dx, dy = sub[n]
    off = base + csiz[n] * ((np.arange(h, dtype=np.int64) // dy)[:, None] * (w // dx)
                            + (np.arange(w, dtype=np.int64) // dx)[None, :])
    word = buf[off].astype(np.int32)
    if csiz[n] == 2:
        word |= buf[off + 1].astype(np.int32) << 8
    return word


def _unpack(name, samples, comps, w, h, mode):
    """One tile through Pillow's unpacker `name` → (h, w, C) samples of `mode`."""
    subsampled = name in ("srgb_rgb", "sycc_rgb", "srgba_rgba", "sycca_rgba")

    def chan(n, bits=8):
        c = comps[n]
        shift = bits - c.prec
        offset = (1 << (c.prec - 1)) if c.sgnd else 0
        if shift < 0:
            offset += 1 << (-shift - 1)
        v = offset + _words(samples, comps, w, h, n, subsampled)
        v = (v >> -shift if shift < 0 else v << shift) & ((1 << bits) - 1)
        return v.astype(np.uint8 if bits == 8 else np.uint16)

    if name == "gray_i":
        return chan(0, 16)[:, :, None]
    if name == "gray_l":
        return chan(0)[:, :, None]
    if name == "gray_rgb":
        g = chan(0)
        return np.stack([g, g, g] + ([np.full_like(g, 255)] if mode == "RGBA" else []), -1)
    if name == "graya_la":
        g, a = chan(0), chan(1)
        return np.stack([g, a] if mode in ("LA", "PA") else [g, g, g, a], -1)
    k = 4 if name in ("srgba_rgba", "sycca_rgba") else 3
    px = np.stack([chan(n) for n in range(k)], -1)
    if name in ("sycc_rgb", "sycca_rgba"):
        px = np.concatenate([_ycbcr_to_rgb(px).astype(np.uint8), px[..., 3:]], -1)
    if mode == "RGBA" and k == 3:
        px = np.concatenate([px, np.full(px.shape[:2] + (1,), 255, np.uint8)], -1)
    return px


def _dequantize(values, band, reversible):
    if reversible:
        return np.where(values < 0, -((-values) >> 1), values >> 1)
    return values.astype(np.float32) * np.float32(np.float32(0.5) * np.float32(band.step))


def decode_codestream(data: bytes) -> tuple[j2c.Codestream, list]:
    """Decode every tile of a codestream → (codestream, [(tile rect,
    [component samples])]) with OpenJPEG's DC shift and clamping."""
    cs = j2c.read(data)
    tiles = []
    blocks = []
    for t in sorted(cs.tiles):
        tile = cs.tiles[t]
        rect = j2k_t2.tile_rect(cs, t)
        comps = j2k_t2.build_tile(cs, tile.coding, rect)
        order = j2k_t2.packet_order(cs, tile.coding, comps, rect)
        if tile.ppm_parts:
            headers = b"".join(tile.ppm_parts)
        elif tile.ppt:
            headers = b"".join(d for _, d in sorted(tile.ppt, key=lambda z: z[0]))
        else:
            headers = None
        body = b"".join(tile.parts)
        if not body:           # OpenJPEG's opj_j2k_decode_tile fails on a tile of no data
            raise j2c.CodestreamError("a tile with no data")
        j2k_t2.decode_packets(comps, tile.coding, order, body, headers)
        for tc in comps:
            for res in tc.res:
                for band in res.bands:
                    for prc in band.precincts:
                        for cb in prc.built:
                            if cb.segs:        # included: a block no packet gave is 0
                                blocks.append(cb)
                                cb.enc = j2k_t1.CodeBlock(
                                    cb.x1 - cb.x0, cb.y1 - cb.y0, band.orient, cb.numbps,
                                    tc.style.cblksty, tc.style.roishift,
                                    [(s[0], bytes(s[2])) for s in cb.segs])
        tiles.append((t, rect, tile.coding, comps))
    values = j2k_t1.decode_blocks([cb.enc for cb in blocks])
    for cb, v in zip(blocks, values):
        cb.enc = v
    del blocks, values
    out = []
    for t, rect, coding, comps in tiles:
        samples = []
        for tc in comps:
            rev = tc.style.reversible
            planes = []
            for res in tc.res:
                bands = []
                for band in res.bands:
                    a = np.zeros((band.y1 - band.y0, band.x1 - band.x0),
                                 np.int32 if rev else np.float32)
                    for prc in band.precincts:
                        for cb in prc.built:
                            if cb.segs:
                                a[cb.y0 - band.y0:cb.y1 - band.y0,
                                  cb.x0 - band.x0:cb.x1 - band.x0] = _dequantize(cb.enc, band, rev)
                                cb.enc = None
                    bands.append(a)
                planes.append((res, bands))
            ll = planes[0][1][0]
            levels = [(b[0], b[1], b[2], res.x0 % 2, res.y0 % 2) for res, b in planes[1:]]
            samples.append(j2k_dwt.inverse(ll, levels, rev))
        if coding.mct and len(comps) >= 3:
            if len({s.shape for s in samples[:3]}) == 1:
                if comps[0].style.reversible:
                    y, u, v = (s.astype(np.int32) for s in samples[:3])
                    g = y - ((u + v) >> 2)
                    samples[:3] = [v + g, g, u + g]
                else:
                    y, u, v = (s.astype(np.float32) for s in samples[:3])
                    r = y + v * np.float32(1.402)
                    g = y - u * np.float32(0.34413) - v * np.float32(0.71414)
                    b = y + u * np.float32(1.772)
                    samples[:3] = [r, g, b]
        final = []
        for tc, s in zip(comps, samples):
            c = tc.comp
            lo, hi = (-(1 << (c.prec - 1)), (1 << (c.prec - 1)) - 1) if c.sgnd else \
                (0, (1 << c.prec) - 1)
            shift = 0 if c.sgnd else 1 << (c.prec - 1)
            if s.dtype.kind == "f":
                # OpenJPEG: past INT_MAX hi, below INT_MIN lo, else lrintf + the
                # shift, clamped (NaN as lrintf gives it on x86, INT_MIN)
                s = np.nan_to_num(np.rint(s), nan=-2.0 ** 31) + np.float32(shift)
            else:
                s = s + shift
            final.append(np.clip(s, lo, hi).astype(np.int32))
        out.append((rect, final))
    return cs, out


def decode_jpeg2000(data: bytes) -> tuple[np.ndarray, dict]:
    """JPEG 2000 bytes (a codestream or a JP2 file) → (uint8 (H, W, C), info)."""
    info = {}
    palette = None
    if data[:4] == b"\xff\x4f\xff\x51":
        mode = _codestream_mode(data, 4)
        lsiz = int.from_bytes(data[4:6], "big")
        comment = _pillow_comment(data, 4 + lsiz)
        space = "unspecified"
        stream = data
        hx = hy = None
    elif data[:12] == jp2.SIGNATURE:
        hdr = jp2.read_header(data)
        check_image_size(hdr.width, hdr.height)       # Image.open's bomb check, on ihdr's size
        mode, space = hdr.mode, hdr.space
        if hdr.dpi is not None:
            info["dpi"] = hdr.dpi
        palette = hdr.palette
        comment = None
        o = hdr.codestream - 8
        if data[o:o + 12].endswith(b"jp2c\xff\x4f\xff\x51"):
            lsiz = int.from_bytes(data[o + 12:o + 14], "big")
            comment = _pillow_comment(data, o + 12 + lsiz)
        stream = data[hdr.codestream:]
        hx, hy = hdr.width, hdr.height
    else:
        raise NotThisFormat("not a JPEG 2000 file")
    if comment is not None:
        info["comment"] = comment
    cs, tiles = decode_codestream(stream)
    width, height = (hx, hy) if hx is not None else (cs.xsiz - cs.xosiz, cs.ysiz - cs.yosiz)
    if space == "unspecified":
        space = "grey" if len(cs.comps) <= 2 else "sRGB"
    key = (mode, space, len(cs.comps))
    if key not in _UNPACKERS or len(cs.comps) > 4:
        raise OSError("broken data stream when reading image file")
    name, subsampled = _UNPACKERS[key]
    if not subsampled and (cs.comps[0].dx != 1 or cs.comps[0].dy != 1):
        raise OSError("broken data stream when reading image file")
    nch = {"L": 1, "P": 1, "I;16": 1, "LA": 2, "PA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4}[mode]
    img = np.zeros((height, width, nch), np.uint16 if mode == "I;16" else np.uint8)
    for (x0, y0, x1, y1), samples in tiles:
        w, h = x1 - x0, y1 - y0
        px = _unpack(name, samples, cs.comps, w, h, mode)
        ox, oy = x0 - cs.xosiz, y0 - cs.yosiz
        if ox < 0 or oy < 0 or ox + w > width or oy + h > height:
            raise OSError("broken data stream when reading image file")
        img[oy:oy + h, ox:ox + w] = px
    if mode in ("P", "PA"):
        colours = palette[0]
        if len(colours) > 256:
            raise ValueError("cannot allocate more than 256 colors")
        pal = np.array([c[:3] + (0,) * (3 - len(c[:3])) for c in colours], np.uint8) \
            if colours else np.zeros((0, 3), np.uint8)
        return as_output("P", img[:, :, 0], pal), info
    return as_output(mode, img), info


# -- writing


def _levels_for(width: int, height: int, wanted: int = 6) -> int:
    """Pillow's shrink of OpenJPEG's resolutions to fit a small image."""
    n = wanted
    while n > 1 and ((1 << (n - 1)) > width or (1 << (n - 1)) > height):
        n -= 1
    return n - 1


def encode_codestream(planes: list, width: int, height: int, cblk=(6, 6),
                      cblksty=0, progression=0, precincts=None, sop=False, eph=False,
                      prec=8, subsampling=None, roi=None,
                      pocs=None, tile=None, offset=(0, 0), tile_offset=(0, 0), mct=0,
                      packed=None, layers=1) -> bytes:
    """Component planes (integers, each on its own sampling grid) of a
    `width` × `height` image → OpenJPEG's lossless codestream.  With no
    keyword: Pillow's defaults.  The keywords are the fixture tool's:
    code-block style bits, progression, precinct exponents per resolution,
    SOP / EPH, precision, per-component subsampling ``[(dx, dy)]``,
    an ROI ``(component, resolutions)`` (those resolutions' coefficients
    scaled by the max-shift, signalled in RGN), POC entries, tiles and
    offsets, RCT, ``packed`` ("ppm" / "ppt") headers, and layers (each
    code-block's passes split evenly)."""
    nc = len(planes)
    x0, y0 = offset
    subsampling = subsampling or [(1, 1)] * nc
    levels = _levels_for(width, height)
    tw, th = tile or (x0 + width - tile_offset[0], y0 + height - tile_offset[1])
    csty = (1 if precincts else 0) | (2 if sop else 0) | (4 if eph else 0)
    expns = [prec] + [prec + g for _ in range(levels) for g in (1, 1, 2)]
    cs = j2c.Codestream(x0 + width, y0 + height, x0, y0, tw, th, tile_offset[0], tile_offset[1],
                        [j2c.Component(prec, False, dx, dy) for dx, dy in subsampling])
    style = j2c.CodingStyle(levels, cblk[0], cblk[1], cblksty, True, list(precincts or []),
                            0, 2, [(e, 0) for e in expns])
    coding = j2c.TileCoding(csty, progression, layers, mct, [style.copy() for _ in range(nc)],
                            list(pocs or []))
    tiles = []
    for t in range(cs.numxtiles * cs.numytiles):
        rect = j2k_t2.tile_rect(cs, t)
        tcs = j2k_t2.build_tile(cs, coding, rect)
        samples = []
        for c, tc in enumerate(tcs):
            dx, dy = subsampling[c]
            cx0, cy0 = j2k_t2.ceil_div(x0, dx), j2k_t2.ceil_div(y0, dy)
            plane = np.asarray(planes[c], np.int64)
            s = plane[tc.y0 - cy0:tc.y1 - cy0, tc.x0 - cx0:tc.x1 - cx0]
            samples.append(s - (1 << (prec - 1)))
        if mct and nc >= 3:
            r, g, b = samples[:3]
            samples[:3] = [(r + 2 * g + b) >> 2, b - g, r - g]
        for c, tc in enumerate(tcs):
            cas = [(res.x0 % 2, res.y0 % 2) for res in tc.res[:0:-1]]
            ll, details = j2k_dwt.forward53(samples[c], cas)
            arrays = {0: ll}
            for k, bands in enumerate(details):
                r = len(tc.res) - 1 - k
                for o in range(3):
                    arrays[3 * (r - 1) + 1 + o] = bands[o]
            for r, res in enumerate(tc.res):
                for band in res.bands:
                    arr = arrays[band.index]
                    for prc in band.precincts:
                        for cb in prc.cblks:
                            co = arr[cb.y0 - band.y0:cb.y1 - band.y0,
                                     cb.x0 - band.x0:cb.x1 - band.x0]
                            cb.enc = j2k_t1.CodeBlock(co.shape[1], co.shape[0], band.orient, 0,
                                                      cblksty, coefs=co)
                            cb.enc.in_roi = roi is not None and roi[0] == c and r < roi[1]
        tiles.append((t, rect, tcs))
    blocks = [cb.enc for _, _, tcs in tiles for tc in tcs for res in tc.res
              for band in res.bands for prc in band.precincts for cb in prc.cblks]
    shift = 0
    if roi is not None:
        # the max-shift: the decoder compares it with its values, which
        # carry one bit below the magnitude, so it passes every background
        # coefficient by one bit more than its magnitude needs
        background = [b for _, _, tcs in tiles for res in tcs[roi[0]].res for band in res.bands
                      for prc in band.precincts for cb in prc.cblks
                      for b in (cb.enc,) if not b.in_roi]
        shift = max([int(np.abs(b.coefs).max()).bit_length() for b in background
                     if b.coefs.size] + [0]) + 1
        for _, _, tcs in tiles:
            for res in tcs[roi[0]].res:
                for band in res.bands:
                    for prc in band.precincts:
                        for cb in prc.cblks:
                            if cb.enc.in_roi:
                                cb.enc.coefs = cb.enc.coefs << shift
                            else:
                                cb.enc.numbps = shift      # coded past the signalled planes
    j2k_t1.encode_blocks(blocks)
    header = (b"\xff\x4f" + j2c.siz(x0 + width, y0 + height,
                                  [(prec, False, dx, dy) for dx, dy in subsampling],
                                  x0, y0, tw, th, *tile_offset) +
              j2c.cod(csty, progression, layers, mct,
                      j2c.spcod(levels, cblk[0], cblk[1], cblksty, True, precincts)) +
              j2c.qcd_none(2, expns))
    if roi is not None:
        header += j2c.marker(j2c.RGN, bytes([roi[0], 0, shift]))
        for _, _, tcs in tiles:
            for res in tcs[roi[0]].res:
                for band in res.bands:
                    for prc in band.precincts:
                        for cb in prc.cblks:
                            if cb.enc.passes:
                                cb.enc.numbps = max(cb.enc.numbps - shift, 0)
    if pocs:
        header += j2c.marker(j2c.POC, b"".join(
            bytes([rs, cs_]) + lye.to_bytes(2, "big") + bytes([re_, ce, order])
            for rs, cs_, lye, re_, ce, order in pocs))
    header += j2c.com(j2c.OPENJPEG_COMMENT)
    ppm_chunks = []
    body = b""
    for t, rect, tcs in tiles:
        order = j2k_t2.packet_order(cs, coding, tcs, rect)
        heads, bodies = [], []
        for n, (l, r, c, p) in enumerate(order):
            def layer_passes(cb, l=l):
                e = cb.enc
                stop = e.passes if l == layers - 1 else (e.passes * (l + 1)) // layers
                start = cb.npasses
                if stop <= start:
                    return 0, []
                lens, prev, group = [], (e.pass_ends[start - 1] if start else 0), 0
                for q in range(start, stop):
                    group += 1
                    if e.pass_terms[q] or q == stop - 1:
                        lens.append((group, e.pass_ends[q] - prev))
                        prev = e.pass_ends[q]
                        group = 0
                return stop - start, lens
            hd, bd = j2k_t2.encode_packet(tcs[c], r, p, l, layer_passes,
                                          sop_index=n if sop else None, eph=eph)
            heads.append(hd)
            bodies.append(bd)
        tp_header = b""
        if packed:
            data = b"".join(bodies)
            hdr = b"".join(heads)
            if packed == "ppt":
                tp_header = j2c.marker(j2c.PPT, b"\x00" + hdr)
            else:
                ppm_chunks.append(len(hdr).to_bytes(4, "big") + hdr)
        else:
            data = b"".join(hd + bd for hd, bd in zip(heads, bodies))
        body += j2c.sot(t, 14 + len(tp_header) + len(data)) + tp_header + b"\xff\x93" + data
    if packed == "ppm":
        header += j2c.marker(j2c.PPM, b"\x00" + b"".join(ppm_chunks))
    return header + body + b"\xff\xd9"


def encode_jpeg2000(image: np.ndarray, kind: str = "jp2", **settings) -> bytes:
    """uint8 (H, W, 1|2|3|4) → Pillow's JPEG 2000 bytes (``kind`` "j2k": a
    raw codestream, else JP2)."""
    a = np.asarray(image)
    if a.ndim == 2:
        a = a[:, :, None]
    stream = encode_codestream([a[:, :, c] for c in range(a.shape[2])], a.shape[1], a.shape[0],
                               **settings)
    if kind == "j2k":
        return stream
    h, w, c = a.shape
    return jp2.wrap(stream, w, h, c, settings.get("prec", 8))
