"""Reading image bytes as the JAX package's Pillow does: ``Image.open``'s
choice of plugin, then its decoder.

``Image.open`` tries its plugins in a fixed order: first the ones it loads
before the others (BMP, DIB, GIF, JPEG, PPM, PNG), then every plugin in
the order of ``Image.ID`` (``PLUGINS``).  A plugin is tried when its
``_accept`` takes the first 16 bytes (a plugin without one is always
tried); when its ``_open`` refuses the bytes with a ``SyntaxError`` (or an
error Pillow turns into one), the next plugin is tried.  Each decoder here
raises ``NotThisFormat`` where Pillow's ``_open`` would refuse, so the same
bytes reach the same decoder; any other error stops the search, as it does
in Pillow.

The decoders give uint8 (H, W, C) pixels as Pillow's ``convert`` sees the
mode ``Image.open`` gives (``utils/image_modes``: grey, grey + alpha, RGB or
RGBA; palettes expanded) and the ``info`` Pillow fills.  The formats Pillow
reads and the port does not (AVIF) and those Pillow opens but
cannot load here (EPS without Ghostscript, WMF/EMF, MPEG, BUFR, GRIB and
HDF5 stubs) raise ``UnsupportedImageFormat`` naming theirs."""

from __future__ import annotations

import struct

import numpy as np

from sdwebui_tpu_torch.utils import (dds, fli, ico, im, netpbm, pcd, pcx, psd, qoi, rasters,
                                     sgi, tga)
from sdwebui_tpu_torch.utils.bmp import decode_bmp
from sdwebui_tpu_torch.utils.gif import decode_gif
from sdwebui_tpu_torch.utils.image_modes import NotThisFormat
from sdwebui_tpu_torch.utils.jpeg import decode_jpeg
from sdwebui_tpu_torch.utils.jpeg2000 import decode_jpeg2000
from sdwebui_tpu_torch.utils.png import decode_png
from sdwebui_tpu_torch.utils.tiff import decode_tiff
from sdwebui_tpu_torch.utils.webp import decode_webp

#: the DIB header sizes Pillow's DIB reader takes as a headerless BMP
_DIB_HEADERS = (12, 40, 52, 56, 64, 108, 124)


class UnsupportedImageFormat(ValueError):
    """Image bytes of a format the port does not read; ``fmt`` names it."""

    def __init__(self, fmt: str):
        super().__init__(f"a {fmt} image; the port reads every format Pillow reads here but "
                         "AVIF, and Pillow itself cannot load EPS, WMF, EMF, MPEG, BUFR, GRIB "
                         "or HDF5 images")
        self.fmt = fmt


def _refuse(fmt: str):
    def decode(data: bytes):
        raise UnsupportedImageFormat(fmt)
    return decode


def _accept_avif(p: bytes) -> bool:
    return p[4:8] == b"ftyp" and p[8:12] in (b"avif", b"avis", b"mif1", b"msf1")


def _decode_dib(data: bytes):
    return decode_bmp(data, dib=True)


def _decode_wmf(data: bytes):
    if data.startswith(b"\xd7\xcd\xc6\x9a\x00\x00"):
        raise UnsupportedImageFormat("WMF")
    if data[40:44] == b" EMF":
        raise UnsupportedImageFormat("EMF")
    raise NotThisFormat("unsupported metafile")


def _decode_tiff(data: bytes):
    if data[:4] in (b"MM\x2a\x00", b"II\x00\x2a"):
        raise ValueError("not a TIFF file (its byte order and magic disagree)")
    return decode_tiff(data)


#: (name, _accept on the first 16 bytes or None, decoder), in Image.ID's order
PLUGINS = (
    ("AVIF", _accept_avif, _refuse("AVIF")),
    ("BLP", dds.accept_blp, dds.decode_blp),
    ("BMP", lambda p: p[:2] == b"BM", decode_bmp),
    ("DIB", lambda p: len(p) >= 4 and struct.unpack_from("<I", p)[0] in _DIB_HEADERS,
     _decode_dib),
    ("BUFR", lambda p: p.startswith((b"BUFR", b"ZCZC")), _refuse("BUFR")),
    ("CUR", ico.accept_cur, ico.decode_cur),
    ("PCX", pcx.accept, pcx.decode_pcx),
    ("DCX", pcx.accept_dcx, pcx.decode_dcx),
    ("DDS", dds.accept, dds.decode_dds),
    ("EPS", lambda p: p.startswith(b"%!PS") or (len(p) >= 4 and struct.unpack_from(
        "<I", p)[0] == 0xC6D3D0C5), _refuse("EPS")),
    ("FITS", rasters.accept_fits, rasters.decode_fits),
    ("FLI", fli.accept, fli.decode_fli),
    ("FTEX", dds.accept_ftex, dds.decode_ftex),
    ("GBR", rasters.accept_gbr, rasters.decode_gbr),
    ("GIF", lambda p: p[:6] in (b"GIF87a", b"GIF89a"), decode_gif),
    ("GRIB", lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1, _refuse("GRIB")),
    ("HDF5", lambda p: p.startswith(b"\x89HDF\r\n\x1a\n"), _refuse("HDF5")),
    ("PNG", lambda p: p.startswith(b"\x89PNG\r\n\x1a\n"), decode_png),
    ("JPEG2000", lambda p: p.startswith((b"\xff\x4f\xff\x51",
                                         b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a")),
     decode_jpeg2000),
    ("ICNS", ico.accept_icns, ico.decode_icns),
    ("ICO", ico.accept_ico, ico.decode_ico),
    ("IM", None, im.decode_im),
    ("IMT", None, im.decode_imt),
    ("IPTC", None, rasters.decode_iptc),
    ("JPEG", lambda p: p.startswith(b"\xff\xd8\xff"), decode_jpeg),
    ("MCIDAS", rasters.accept_mcidas, rasters.decode_mcidas),
    ("MPEG", lambda p: p.startswith(b"\x00\x00\x01\xb3"), _refuse("MPEG")),
    ("TIFF", lambda p: p[:4] in (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a",
                                 b"MM\x00\x2b", b"II\x2b\x00"), _decode_tiff),
    ("MSP", rasters.accept_msp, rasters.decode_msp),
    ("PCD", None, pcd.decode_pcd),
    ("PIXAR", rasters.accept_pixar, rasters.decode_pixar),
    ("PPM", netpbm.accept, netpbm.decode_netpbm),
    ("PSD", psd.accept, psd.decode_psd),
    ("QOI", lambda p: p.startswith(b"qoif"), qoi.decode_qoi),
    ("SGI", sgi.accept, sgi.decode_sgi),
    ("SPIDER", None, rasters.decode_spider),
    ("SUN", rasters.accept_sun, rasters.decode_sun),
    ("TGA", None, tga.decode_tga),
    ("WEBP", lambda p: p[:4] == b"RIFF" and p[8:12] == b"WEBP", decode_webp),
    ("WMF", lambda p: p.startswith((b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00")),
     _decode_wmf),
    ("XBM", rasters.accept_xbm, rasters.decode_xbm),
    ("XPM", rasters.accept_xpm, rasters.decode_xpm),
    ("XVTHUMB", rasters.accept_xvthumb, rasters.decode_xvthumb),
)
#: the plugins Image.open tries first (``Image.preinit``)
PREINIT = ("BMP", "DIB", "GIF", "JPEG", "PPM", "PNG")
_BY_NAME = {name: (accept, decoder) for name, accept, decoder in PLUGINS}


def _order():
    for name in PREINIT:
        yield (name,) + _BY_NAME[name]
    yield from PLUGINS


def decode_image(data: bytes) -> tuple[np.ndarray, dict]:
    """Image bytes → (uint8 (H, W, C), info)."""
    for _name, accept, decoder in _order():
        if accept is not None and not accept(data[:16]):
            continue
        try:
            return decoder(data)
        except NotThisFormat:
            continue
    raise ValueError("not an image of a format the port reads")


def read_image_file(path: str) -> tuple[np.ndarray, dict]:
    with open(path, "rb") as f:
        return decode_image(f.read())
