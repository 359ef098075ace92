"""IFUNC Image Memory (IM) reading and writing and IM Tools (IMT)
reading, as Pillow's ``ImImagePlugin`` and ``ImtImagePlugin`` do.

IM: a text header of ``Key: value`` lines (CR LF or LF) up to a ``\\x1a``
byte, an optional 768-byte planar palette ("Lut"), then rows bottom-up,
each a line of every band in turn ("RGB;L").  The reader takes the types
Pillow's ``OPEN`` maps to "1", "L", "LA", "P", "RGB" (line-interleaved or
"X 24" pixel-interleaved), "RGBA", "RGBX", "CMYK", the 16- and 32-bit
integer types and "L 32F"; other types raise naming themselves.  The writer
gives Pillow's bytes for grey, grey + alpha, RGB and RGBA images: the
header names the file written to (Pillow writes the name of the file it
saves to, a temporary file's included).

IMT: ``width``, ``height`` and ``pixel n8`` lines, then 8-bit grey rows
after a form feed."""

from __future__ import annotations

import os
import re

import numpy as np

from sdwebui_tpu_torch.utils.image_modes import NotThisFormat, as_output, from_palette
from sdwebui_tpu_torch.utils.png import check_image_size, unpack_bits

_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_TAGS = ("Comment", "Date", "Digitalization equipment", "File size (no of images)", "Lut",
         "Name", "Scale (x,y)", "Image size (x*y)", "Image type")
#: image type → (Pillow mode, bands in the file, bytes a sample, dtype, line-interleaved)
_TYPES = {"0 1 image": ("1",), "L 1 image": ("1",), "B1 image": ("1",),
          "Greyscale image": ("L", 1, 1, "u1", True), "Grayscale image": ("L", 1, 1, "u1", True),
          "RGB image": ("RGB", 3, 1, "u1", True), "X 24 image": ("RGB", 3, 1, "u1", False),
          "LA image": ("LA", 2, 1, "u1", True), "RGBA image": ("RGBA", 4, 1, "u1", True),
          "RGBX image": ("RGB", 4, 1, "u1", True), "CMYK image": ("CMYK", 4, 1, "u1", True),
          "L 16 image": ("I;16", 1, 2, "<u2", True), "L*16 image": ("I;16", 1, 2, "<u2", True),
          "L 16L image": ("I;16", 1, 2, "<u2", True), "L 16B image": ("I;16", 1, 2, ">u2", True),
          "L 32S image": ("I", 1, 4, "<i4", True), "L*32S image": ("I", 1, 4, "<i4", True),
          "L 32 S image": ("I", 1, 4, "<i4", True), "L 32F image": ("F", 1, 4, "<f4", True),
          "L*32F image": ("F", 1, 4, "<f4", True), "L 32 F image": ("F", 1, 4, "<f4", True)}


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def _header(data: bytes) -> tuple[dict, int]:
    """Pillow's header loop → (info, offset of the byte after ``\\x1a``)."""
    if b"\n" not in data[:100]:
        raise NotThisFormat("not an IM file")
    info = {"Image type": "L", "Image size (x*y)": (512, 512), "File size (no of images)": 1}
    pos, n, tags = 0, len(data), 0
    s = b""
    while True:
        s = data[pos:pos + 1]
        pos += 1
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        end = n if end < 0 else end + 1
        s += data[pos:end]
        pos = end
        if len(s) > 100:
            raise NotThisFormat("not an IM file")
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = _SPLIT.match(s)
        if not m:
            raise NotThisFormat("syntax error in IM header")
        k = m.group(1).decode("latin-1", "replace")
        v = m.group(2).decode("latin-1", "replace")
        if k in ("File size (no of images)", "Scale (x,y)", "Image size (x*y)"):
            nums = tuple(_number(p) for p in v.replace("*", ",").split(","))
            v = nums[0] if len(nums) == 1 else nums
        if k == "Comment":
            info.setdefault(k, []).append(v)
        else:
            info[k] = v
        tags += k in _TAGS
    if not tags:
        raise NotThisFormat("not an IM file")
    while s and not s.startswith(b"\x1a"):
        s = data[pos:pos + 1]
        pos += 1
    if not s:
        raise NotThisFormat("IM file truncated")
    return info, pos


def decode_im(data: bytes) -> tuple[np.ndarray, dict]:
    """IM bytes → (uint8 (H, W, C), info)."""
    info, pos = _header(data)
    kind = info["Image type"]
    if kind not in _TYPES:
        raise ValueError(f"IM image type {kind!r} is not read")
    size = info["Image size (x*y)"]
    if not isinstance(size, tuple) or len(size) != 2 or min(size) <= 0:
        raise NotThisFormat("IM without a size")
    w, h = (int(v) for v in size)
    check_image_size(w, h)
    palette = None
    spec = _TYPES[kind]
    mode = spec[0]
    if "Lut" in info:
        lut = np.frombuffer(data[pos:pos + 768].ljust(768, b"\0"), np.uint8).reshape(3, 256)
        pos += 768
        grey = (lut[0] == lut[1]).all() and (lut[1] == lut[2]).all()
        if mode in ("L", "LA") and not grey:
            mode = "P" if mode == "L" else "PA"
            palette = lut.T
    if mode == "1":
        row = (w + 7) // 8
        raw = data[pos:pos + row * h]
        if len(raw) < row * h:
            raise ValueError("IM: image file is truncated")
        bits = unpack_bits(np.frombuffer(raw, np.uint8).reshape(h, row), 1, w)
        return as_output("1", bits[::-1]), info
    _, bands, size_b, dtype, lines = spec
    need = w * h * bands * size_b
    raw = data[pos:pos + need]
    if len(raw) < need:
        raise ValueError("IM: image file is truncated")
    a = np.frombuffer(raw, dtype)
    a = a.reshape(h, bands, w).transpose(0, 2, 1) if lines else a.reshape(h, w, bands)
    a = a[::-1]
    if kind == "RGBX image":
        a = a[:, :, :3]
    if mode == "P":
        return from_palette(a[:, :, 0], palette), info
    if mode == "PA":
        return from_palette(a[:, :, 0], palette), info
    return as_output(mode, np.ascontiguousarray(a)), info


def encode_im(image: np.ndarray, filename: str = "") -> bytes:
    """uint8 (H, W, 1|2|3|4) → Pillow's IM bytes; `filename` is the file
    the bytes are written to (its name goes in the header)."""
    a = np.asarray(image)
    if a.ndim == 2:
        a = a[:, :, None]
    h, w, c = a.shape
    kind = {1: "Greyscale", 2: "LA", 3: "RGB", 4: "RGBA"}[c]
    head = f"Image type: {kind} image\r\n"
    if filename:
        name, ext = os.path.splitext(os.path.basename(filename))
        head += f"Name: {name[:92 - len(ext)]}{ext}\r\n"
    head += f"Image size (x*y): {w}*{h}\r\nFile size (no of images): 1\r\n"
    head = head.encode("ascii")
    head += b"\0" * (511 - len(head)) + b"\x1a"
    return head + np.ascontiguousarray(a[::-1].transpose(0, 2, 1)).tobytes()


_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def imt_header(data: bytes) -> tuple[int, int, str, int] | None:
    """Pillow's IMT ``_open``: (width, height, mode, offset of the pixels),
    or None where it gives no tile (SyntaxError where it raises one)."""
    buffer = data[:100]
    pos = len(buffer)
    if b"\n" not in buffer:
        raise NotThisFormat("not an IM file")
    xsize = ysize = 0
    mode = ""
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = data[pos:pos + 1]
            pos += 1
        if not s:
            return None
        if s == b"\x0c":
            return xsize, ysize, mode, pos - len(buffer)
        if b"\n" not in buffer:
            more = data[pos:pos + 100]
            buffer += more
            pos += len(more)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            return None
        if s[0] == ord(b"*"):
            continue
        m = _IMT_FIELD.match(s)
        if not m:
            return None
        k, v = m.group(1, 2)
        if k == b"width":
            xsize = int(v)
        elif k == b"height":
            ysize = int(v)
        elif k == b"pixel" and v == b"n8":
            mode = "L"


def decode_imt(data: bytes) -> tuple[np.ndarray, dict]:
    """IMT bytes → (uint8 (H, W, 1), {})."""
    head = imt_header(data)
    if head is None or head[2] != "L" or min(head[:2]) <= 0:
        raise NotThisFormat("not an IMT file")
    w, h, _, pos = head
    check_image_size(w, h)
    raw = data[pos:pos + w * h]
    if len(raw) < w * h:
        raise ValueError("IMT: image file is truncated")
    return np.frombuffer(raw, np.uint8).reshape(h, w, 1).copy(), {}
