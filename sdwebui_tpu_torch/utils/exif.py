"""EXIF UserComment embedding for JPEG and WebP infotext — port of
``sdwebui_tpu/utils/exif.py``.

The JAX package builds the block with Pillow's ``Image.Exif`` writer; the
port writes the same bytes with ``struct``: ``Exif\\0\\0``, a big-endian
TIFF header, IFD0 holding one ExifIFD pointer (0x8769) and the Exif IFD
holding one UserComment (0x9286) of type BYTE, whose value is the EXIF
``UNICODE\\0`` charset prefix + the UTF-16-BE infotext.  ``read_user_comment``
walks the TIFF structure of an APP1 payload back to that tag, in either byte
order and for the UNDEFINED or BYTE type cameras and piexif write; it also
reads a WebP's EXIF chunk and a PNG's eXIf, which hold the TIFF block
without the ``Exif\\0\\0`` header (``utils/webp``, ``utils/png``).
"""

from __future__ import annotations

import struct

EXIF_IFD = 0x8769
USER_COMMENT = 0x9286

_HEADER = b"Exif\x00\x00"
#: bytes per value of the TIFF field types
_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8}


def build_exif_bytes(geninfo: str) -> bytes:
    """The APP1 payload Pillow writes for ``{ExifIFD: {UserComment: ...}}``:
    IFD0 at offset 8 (one entry), the Exif IFD after it at 26 (one entry),
    the comment's bytes after that at 44."""
    comment = b"UNICODE\x00" + (geninfo or "").encode("utf-16-be")
    ifd0 = struct.pack(">HHHII", 1, EXIF_IFD, 4, 1, 26) + struct.pack(">I", 0)
    exif_ifd = struct.pack(">HHHII", 1, USER_COMMENT, 1, len(comment), 44) + struct.pack(">I", 0)
    return _HEADER + b"MM\x00*" + struct.pack(">I", 8) + ifd0 + exif_ifd + comment


def decode_user_comment(raw: bytes) -> str | None:
    if not isinstance(raw, bytes) or len(raw) < 8:
        return None
    charset, payload = raw[:8], raw[8:]
    if charset.startswith(b"UNICODE"):
        # BOM-less UTF-16; piexif writes BE, some cameras write LE
        try:
            text = payload.decode("utf-16-be")
            if "\x00" in text.rstrip("\x00"):
                text = payload.decode("utf-16-le")
            return text.rstrip("\x00")
        except UnicodeDecodeError:
            return None
    if charset.startswith(b"ASCII") or charset == b"\x00" * 8:
        return payload.decode("ascii", errors="replace").rstrip("\x00")
    return None


def _ifd_entries(tiff: bytes, offset: int, order: str) -> dict:
    """{tag: raw value bytes} of the IFD at `offset` of a TIFF block."""
    (count,) = struct.unpack_from(order + "H", tiff, offset)
    out = {}
    for i in range(count):
        tag, typ, n, value = struct.unpack_from(order + "HHI4s", tiff, offset + 2 + 12 * i)
        size = _TYPE_SIZES.get(typ, 1) * n
        if size <= 4:
            out[tag] = (typ, value[:size])
        else:
            (pos,) = struct.unpack(order + "I", value)
            out[tag] = (typ, tiff[pos:pos + size])
    return out


def read_exif_tags(payload: bytes) -> tuple[dict, dict]:
    """An APP1 EXIF payload (with or without its ``Exif\\0\\0`` header) →
    (IFD0, Exif IFD), each {tag: (type, raw value bytes)}; ValueError when
    it is not a TIFF block."""
    tiff = payload[6:] if payload.startswith(_HEADER) else payload
    if tiff[:4] not in (b"MM\x00*", b"II*\x00"):
        raise ValueError("not an EXIF TIFF block")
    order = ">" if tiff[:2] == b"MM" else "<"
    try:
        (first,) = struct.unpack_from(order + "I", tiff, 4)
        ifd0 = _ifd_entries(tiff, first, order)
        exif = {}
        if EXIF_IFD in ifd0:
            (pos,) = struct.unpack(order + "I", ifd0[EXIF_IFD][1].ljust(4, b"\0"))
            exif = _ifd_entries(tiff, pos, order)
    except struct.error as e:
        raise ValueError(f"truncated EXIF block: {e}") from e
    return ifd0, exif


def read_user_comment(payload: bytes | None) -> str | None:
    """The infotext in an APP1 EXIF payload's UserComment, or None."""
    if not payload:
        return None
    try:
        _, exif = read_exif_tags(payload)
    except ValueError:
        return None
    raw = exif.get(USER_COMMENT)
    return decode_user_comment(raw[1]) if raw is not None else None
