"""Write the JPEG 2000 fixtures of ``tests/fixtures/jpeg2000/``: files that
Pillow's writer cannot make (every code-block style, SOP / EPH, POC,
subsampled components, an ROI, 12- and 16-bit samples, packed headers, a
palette) and two 512² files Pillow writes (lossless and 9/7), each with
Pillow's pixels and ``info`` beside it as ``<name>.npz`` (for the two 512²
files the SHA-256 of the pixels, their shape and first rows, so that the
folder stays under 1 MB).

The files Pillow cannot write are made by ``sdwebui_tpu_torch.utils.
jpeg2000.encode_codestream`` with settings only this tool passes; each is
held to Pillow (OpenJPEG) here: it must open, and a lossless file must
decode to its samples as Pillow's unpacker maps them.  The card's machine
has no Pillow: chip_smoke reads these files and their pixels.

    python tools/write_jpeg2000_fixtures.py [--out tests/fixtures/jpeg2000]

Needs Pillow with OpenJPEG (``PIL.features.check("jpg_2000")``)."""

from __future__ import annotations

import argparse
import hashlib
import io
import os
import struct
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from PIL import Image  # noqa: E402

from sdwebui_tpu_torch.utils import jp2  # noqa: E402
from sdwebui_tpu_torch.utils.jpeg2000 import encode_codestream  # noqa: E402

#: pixels past this many samples are kept as a digest
BIG = 256 * 256 * 3
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests", "fixtures",
                   "jpeg2000")


def sample(h: int, w: int, c: int, seed: int, peak: int = 255) -> np.ndarray:
    """A smooth image with texture: gradients, a ring, noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = [x * 3 + y, y * 2 + 40 * np.sin(x / 5.0), 120 + 80 * np.cos((x - y) / 9.0),
            255 - x - y]
    planes = [base[k % 4] + rng.normal(0, 6, (h, w)) for k in range(c)]
    a = np.stack(planes, -1) * (peak / 255.0)
    return np.clip(np.rint(a), 0, peak).astype(np.int64)


def pillow_pixels(data: bytes) -> tuple[np.ndarray, dict]:
    """Pillow's image of the bytes as the port's decoders give it."""
    with Image.open(io.BytesIO(data)) as im:
        im.load()
        mode = im.mode
        info = {k: v for k, v in im.info.items() if k in ("comment", "dpi")}
        if mode in ("L", "LA", "RGB", "RGBA"):
            a = np.asarray(im)
        elif mode == "I;16":
            a = np.asarray(im.convert("L"))
        else:                      # P, PA, CMYK
            a = np.asarray(im.convert("RGB"))
    if a.ndim == 2:
        a = a[:, :, None]
    return a.astype(np.uint8), info


def pillow_file(a: np.ndarray, **kw) -> bytes:
    im = Image.fromarray(a[:, :, 0].astype(np.uint8) if a.shape[2] == 1 else a.astype(np.uint8))
    buf = io.BytesIO()
    im.save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def wrap(stream: bytes, w: int, h: int, nc: int, prec: int, enumcs: int,
         extra: bytes = b"") -> bytes:
    """A JP2 file round a codestream, with colr's enumerated space and
    further jp2h boxes."""
    ihdr = jp2.box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, prec - 1, 7, 0, 0))
    colr = jp2.box(b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs))
    return (jp2.SIGNATURE + jp2.box(b"ftyp", b"jp2 \x00\x00\x00\x00jp2 ") +
            jp2.box(b"jp2h", ihdr + colr + extra) + jp2.box(b"jp2c", stream))


def _planes(a):
    return [a[:, :, c] for c in range(a.shape[2])]


def fixtures() -> dict:
    """name → (file bytes, the samples a lossless file holds or None, their
    precision)."""
    out = {}
    rgb = sample(40, 48, 3, 1)
    for name, sty in (("style_bypass", 1), ("style_reset", 2), ("style_termall", 4),
                      ("style_vsc", 8), ("style_pterm", 16), ("style_segsym", 32),
                      ("style_bypass_termall", 5), ("style_bypass_vsc_segsym", 41),
                      ("style_all", 63)):
        out[name + ".j2k"] = (encode_codestream(_planes(rgb), 48, 40, cblk=(5, 5),
                                                cblksty=sty), rgb, 8)
    out["sop.j2k"] = (encode_codestream(_planes(rgb), 48, 40, sop=True), rgb, 8)
    out["eph.j2k"] = (encode_codestream(_planes(rgb), 48, 40, eph=True), rgb, 8)
    out["sop_eph_rpcl.j2k"] = (encode_codestream(
        _planes(rgb), 48, 40, sop=True, eph=True, progression=2,
        precincts=[(3, 3), (3, 3), (4, 4), (4, 4), (5, 5), (5, 5)]), rgb, 8)
    out["poc.j2k"] = (encode_codestream(
        _planes(rgb), 48, 40, layers=2, progression=0,
        pocs=[(0, 0, 2, 3, 3, 1), (3, 0, 2, 6, 2, 4), (0, 0, 2, 6, 3, 3)]), rgb, 8)
    out["ppm.j2k"] = (encode_codestream(_planes(rgb), 48, 40, packed="ppm",
                                        tile=(24, 24)), rgb, 8)
    out["ppt.j2k"] = (encode_codestream(_planes(rgb), 48, 40, packed="ppt", layers=2,
                                        tile=(32, 16)), rgb, 8)
    out["rgn.j2k"] = (encode_codestream(_planes(rgb), 48, 40, roi=(0, 3)), rgb, 8)
    out["rct_tiles_offset.j2k"] = (encode_codestream(
        _planes(rgb), 48, 40, mct=1, tile=(20, 17), offset=(5, 3), tile_offset=(2, 1)), rgb, 8)
    rgb12 = sample(24, 32, 3, 2, 4095)
    out["rgb12.j2k"] = (encode_codestream(_planes(rgb12), 32, 24, prec=12), rgb12, 12)
    rgb16 = sample(24, 32, 3, 3, 65535)
    out["rgb16.jp2"] = (wrap(encode_codestream(_planes(rgb16), 32, 24, prec=16), 32, 24, 3, 16,
                             16), rgb16, 16)
    grey12 = sample(24, 32, 1, 4, 15)         # Pillow's I;16 → L clips at 255
    out["grey12.j2k"] = (encode_codestream(_planes(grey12), 32, 24, prec=12), grey12, 12)
    # 2×2-subsampled chroma, as sRGB and as sYCC
    full = sample(32, 40, 3, 5)
    planes = [full[:, :, 0], full[::2, ::2, 1], full[::2, ::2, 2]]
    sub = encode_codestream(planes, 40, 32, subsampling=[(1, 1), (2, 2), (2, 2)])
    out["subsampled_srgb.jp2"] = (wrap(sub, 40, 32, 3, 8, 16), None, 8)
    out["subsampled_sycc.jp2"] = (wrap(sub, 40, 32, 3, 8, 18), None, 8)
    # a palette: one component of indices, pclr and cmap
    idx = (sample(24, 32, 1, 6) // 16)[:, :, :1]
    pal = [(k * 16, 255 - k * 12, (k * 37) % 256) for k in range(16)]
    pclr = jp2.box(b"pclr", struct.pack(">HB", len(pal), 3) + bytes([7, 7, 7]) +
                   b"".join(bytes(p) for p in pal))
    cmap = jp2.box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, k) for k in range(3)))
    out["pclr.jp2"] = (wrap(encode_codestream(_planes(idx), 32, 24), 32, 24, 1, 8, 16,
                            pclr + cmap), None, 8)
    # Pillow's own: 512² lossless and 9/7
    big = sample(512, 512, 3, 7).astype(np.uint8)
    out["pillow_512_lossless.jp2"] = (pillow_file(big), big, 8)
    out["pillow_512_irreversible.jp2"] = (pillow_file(big, irreversible=True,
                                                      quality_layers=[24]), None, 8)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    for name, (data, samples, prec) in fixtures().items():
        pixels, info = pillow_pixels(data)
        if samples is not None:
            # a lossless file: Pillow's pixels are its samples through the unpacker
            s = np.asarray(samples, np.int64)
            shift = 8 - prec
            want = (s << shift if shift >= 0 else (s + (1 << (-shift - 1))) >> -shift) & 0xFF
            if s.shape[2] == 1 and prec > 8:       # mode I;16, then convert("L")
                want = np.clip(s << (16 - prec), 0, 255)
            if pixels.shape != want.shape or not np.array_equal(pixels, want):
                raise SystemExit(f"{name}: Pillow does not decode it to its samples")
        with open(os.path.join(args.out, name), "wb") as fh:
            fh.write(data)
        extra = {}
        if "comment" in info:
            extra["comment"] = np.frombuffer(info["comment"], np.uint8)
        if "dpi" in info:
            extra["dpi"] = np.array(info["dpi"], np.float64)
        if pixels.size > BIG:
            # a 512² image's pixels do not compress under 1 MB with the rest:
            # their SHA-256, shape and first rows stand for them
            extra.update(sha256=np.frombuffer(hashlib.sha256(pixels.tobytes()).digest(),
                                              np.uint8),
                         shape=np.array(pixels.shape), head=pixels[:8])
        else:
            extra["pixels"] = pixels
        np.savez_compressed(os.path.join(args.out, os.path.splitext(name)[0] + ".npz"),
                            **extra)
        print(f"{name}: {len(data)} bytes, {pixels.shape}")


if __name__ == "__main__":
    main()
