"""PDF and EPS writing, as Pillow's ``PdfImagePlugin`` (with its
``PdfParser``) and ``EpsImagePlugin`` write an image.

PDF: ``%PDF-1.4``, the catalog, the page tree, the image as a DCTDecode
XObject (the JPEG of ``utils/jpeg.encode_jpeg`` at the quality given) for
grey or RGB, or as a JPXDecode XObject with ``SMaskInData 1`` (the JP2 of
``utils/jpeg2000.encode_jpeg2000``) for grey + alpha or RGBA, the
page at 72 dpi, its content stream, the document information (the file's
base name as its UTF-16 title, the creation and modification times), the
cross-reference table and the trailer, in Pillow's object order and
layout.  EPS: Pillow's EPSF-3.0 header, then the pixels in hex, 39 bytes
a line, then ``%%%%EndBinary``, as Pillow writes it."""

from __future__ import annotations

import os
import time

import numpy as np

from sdwebui_tpu_torch.utils.jpeg import encode_jpeg
from sdwebui_tpu_torch.utils.jpeg2000 import encode_jpeg2000


def _text(s: str) -> bytes:
    raw = b"\xfe\xff" + s.encode("utf-16-be")
    return b"(" + raw.replace(b"\\", b"\\\\").replace(b"(", b"\\(").replace(b")", b"\\)") + b")"


def _date(t: time.struct_time) -> bytes:
    return b"(D:" + time.strftime("%Y%m%d%H%M%SZ", t).encode("ascii") + b")"


def encode_pdf(image: np.ndarray, quality: int, filename: str = "",
               now: time.struct_time | None = None) -> bytes:
    """uint8 (H, W, 1|2|3|4) → Pillow's one-page PDF bytes; `filename` is the
    file written to (its base name is the title), `now` the creation time
    (default: the current UTC time, as Pillow takes it)."""
    a = np.asarray(image)
    if a.ndim == 2:
        a = a[:, :, None]
    h, w, c = a.shape
    if c not in (1, 2, 3, 4):
        raise ValueError(f"cannot save a {c}-channel image as PDF")
    now = now or time.gmtime()
    procset = b"/ImageB" if c in (1, 2) else b"/ImageC"
    if c in (2, 4):
        stream = encode_jpeg2000(a, "j2k" if str(filename).endswith(".j2k") else "jp2")
        image = b"/Filter /JPXDecode\n/SMaskInData 1\n"
    else:
        stream = encode_jpeg(a[:, :, 0] if c == 1 else a, int(quality))
        image = b"/Filter /DCTDecode\n/BitsPerComponent 8\n/ColorSpace %s\n" % (
            b"/DeviceGray" if c == 1 else b"/DeviceRGB")
    title = os.path.splitext(os.path.basename(filename))[0]
    out = bytearray(b"%PDF-1.4\n% created by Pillow PDF driver\n")
    offsets = {}

    def obj(num: int, body: bytes, stream: bytes | None = None):
        offsets[num] = len(out)
        out.extend(b"%d 0 obj<<\n" % num + body)
        if stream is None:
            out.extend(b">>endobj\n")
        else:
            out.extend(b"/Length %d\n>>stream\n" % len(stream) + stream + b"\nendstream\nendobj\n")

    obj(4, b"/Type /Catalog\n/Pages 5 0 R\n")
    obj(5, b"/Type /Pages\n/Count 1\n/Kids [ 2 0 R ]\n")
    obj(1, b"/Type /XObject\n/Subtype /Image\n/Width %d\n/Height %d\n" % (w, h) + image, stream)
    size = (repr(float(w)).encode(), repr(float(h)).encode())
    obj(2, b"/Resources <<\n/ProcSet [ /PDF %s ]\n/XObject <<\n/image 1 0 R\n>>\n>>\n"
           b"/MediaBox [ 0 0 %s %s ]\n/Contents 3 0 R\n/Type /Page\n/Parent 5 0 R\n"
        % ((procset,) + size))
    obj(3, b"", b"q %f 0 0 %f 0 0 cm /image Do Q\n" % (float(w), float(h)))
    info = (b"/Title " + _text(title) + b"\n" if title else b"") + \
        b"/CreationDate " + _date(now) + b"\n/ModDate " + _date(now) + b"\n"
    obj(6, info)
    xref = len(out)
    out.extend(b"xref\n0 7\n0000000000 65536 f \n")
    for num in range(1, 7):
        out.extend(b"%010d 00000 n \n" % offsets[num])
    out.extend(b"trailer\n<<\n/Root 4 0 R\n/Size 7\n/Info 6 0 R\n>>\nstartxref\n%d\n%%%%EOF"
               % xref)
    return bytes(out)


def encode_eps(image: np.ndarray) -> bytes:
    """uint8 (H, W, 1|3) → Pillow's EPS bytes."""
    a = np.asarray(image)
    if a.ndim == 2:
        a = a[:, :, None]
    h, w, c = a.shape
    if c not in (1, 3):
        raise ValueError("image mode is not supported")
    bands, op = (1, b"image") if c == 1 else (3, b"false 3 colorimage")
    head = (b"%!PS-Adobe-3.0 EPSF-3.0\n%%Creator: PIL 0.1 EpsEncode\n"
            + b"%%%%BoundingBox: 0 0 %d %d\n" % (w, h)
            + b"%%Pages: 1\n%%EndComments\n%%Page: 1 1\n"
            + b"%%ImageData: %d %d " % (w, h) + b'%d %d 0 1 1 "%s"\n' % (8, bands, op)
            + b"gsave\n10 dict begin\n" + b"/buf %d string def\n" % (w * bands)
            + b"%d %d scale\n" % (w, h) + b"%d %d 8\n" % (w, h)
            + b"[%d 0 0 -%d 0 %d]\n" % (w, h, h)
            + b"{ currentfile buf readhexstring pop } bind\n" + op + b"\n")
    hexed = a.tobytes().hex().encode("ascii")
    lines = [hexed[i:i + 78] for i in range(0, len(hexed), 78)]
    return head + b"\n".join(lines) + b"\n%%%%EndBinary\ngrestore end\n"
