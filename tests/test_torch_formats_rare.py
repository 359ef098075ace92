"""The rarer image formats JAX's Pillow reads, read by the port: TGA,
Netpbm, QOI, SGI, PCX and DCX, ICO, CUR and ICNS, PSD, DDS (BC1-BC7,
uncompressed), FTEX, BLP, IM and IMT, SUN, MSP, XBM, XPM, PIXAR, SPIDER,
GBR, XV thumbnails, FITS, McIdas, IPTC, FLI / FLC and PCD.

Each reader is held to Pillow's ``Image.open`` on the same bytes, in every
pixel, through JAX's ``flatten`` (img2img's RGB) and ``convert("L")``
(masks), with the ``info`` keys both give: Pillow's own files where Pillow
writes the format, the numpy writers of ``tests/torch_image_files``
otherwise.  ``Image.open``'s choice of plugin is held to the port's on
bytes two plugins could claim; the formats left refused name themselves;
and the request routes (a base64 img2img init image, the img2img batch, a
dataset directory) answer a TGA, a PSD and a Zstandard TIFF as JAX's do."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)
import base64
import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

import torch_image_files as f
from sdwebui_tpu.pipeline import img2img as jax_i2i
from sdwebui_tpu.pipeline.params import GenerationParams as JaxParams
from sdwebui_tpu.server import api as jax_api
from sdwebui_tpu.server import app as jax_app
from sdwebui_tpu.training import dataset as jax_ds
from sdwebui_tpu.utils import images as jax_images
from sdwebui_tpu_torch.server.api import Api
from sdwebui_tpu_torch.server.app import Engine
from sdwebui_tpu_torch.training import dataset as port_ds
from sdwebui_tpu_torch.utils import image_io, images as images_util
from sdwebui_tpu_torch.utils.image_io import UnsupportedImageFormat, decode_image
from sdwebui_tpu_torch.utils.jpeg import encode_jpeg
from sdwebui_tpu_torch.utils.png import decode_png, encode_png
from test_torch_img2img import f32_policies, models  # noqa: F401
from test_torch_save_routes import _jax_self
from test_torch_saving import both, fixed_clock  # noqa: F401
from test_torch_training import _rel

_BG = "#ffffff"
#: the info keys a reader's info is held to, where Pillow gives them
_INFO_KEYS = ("dpi", "compression", "orientation", "duration", "sizes", "hotspot", "scale",
              "spacing", "comment", "id_section", "gamma")


def _pillow(a: np.ndarray, fmt: str, mode: str | None = None, **kw) -> bytes:
    buf = io.BytesIO()
    im = Image.fromarray(a)
    if mode:
        im = im.convert(mode)
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _sample(h: int = 29, w: int = 37, seed: int = 0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    rgb = np.clip(np.stack([x * 7, y * 8, (x + y) * 4], 2) + rng.integers(0, 9, (h, w, 3)),
                  0, 255).astype(np.uint8)
    rgba = np.concatenate([rgb, rng.integers(0, 256, (h, w, 1), dtype=np.uint8)], 2)
    pal = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    idx = rng.integers(0, 256, (h, w)).astype(np.uint8)
    bits = (rng.random((h, w)) > 0.5).astype(np.uint8)
    return rgb, rgba, rgb[:, :, 1].copy(), pal, idx, bits


def _cases() -> dict:
    rgb, rgba, grey, pal, idx, bits = _sample()
    rng = np.random.default_rng(7)
    sq = rgba[:16, :16]
    big = (rng.integers(0, 3, (128, 128, 3)) * 100).astype(np.uint8)
    b1, _ = f.bc_blocks(rgba, "bc1")
    b3, _ = f.bc_blocks(rgba, "bc3")
    b7, _ = f.bc_blocks(rgba, "bc7")
    jp = encode_jpeg(rgb, 90)
    c = {
        # JPEG 2000, refused before the port read it
        "jpeg2000_jp2": lambda: _pillow(rgb, "JPEG2000"),
        "jpeg2000_j2k": lambda: _pillow(rgb, "JPEG2000", no_jp2=True),
        "icns_jpeg2000": lambda: f.icns_file(None, kind=b"icp4",
                                             png=_pillow(rgb[:16, :16], "JPEG2000")),
        # Netpbm
        "ppm_P6": lambda: _pillow(rgb, "PPM"), "ppm_P5": lambda: _pillow(grey, "PPM"),
        "ppm_P4": lambda: _pillow(bits.astype(bool), "PPM"),
        "ppm_P5_16": lambda: _pillow(grey.astype(np.uint16) * 200, "PPM", "I;16"),
        "ppm_P6_maxval": lambda: b"P6 37 29 1000\n" + (rgb.astype(">u2") * 3).tobytes(),
        "ppm_P3_comments": lambda: b"P3\n# a comment\n37 29\n255\n" + " \n#c\n".join(
            map(str, rgb.ravel())).encode() + b"\n",
        "ppm_P2_maxval": lambda: b"P2 37 29 15 " + " ".join(map(str, grey.ravel() // 17))
        .encode(),
        "ppm_P1": lambda: b"P1\n37 29\n" + "".join(map(str, bits.ravel())).encode(),
        "pfm": lambda: _pillow(grey.astype(np.float32) * 1.7 - 20, "PPM"),
        # TGA
        "tga_pillow_rgb": lambda: _pillow(rgb, "TGA"), "tga_pillow_rgba_rle":
            lambda: _pillow(rgba, "TGA", rle=True),
        "tga_pillow_grey_top": lambda: _pillow(grey, "TGA", orientation=1),
        "tga_pillow_palette": lambda: _pillow(rgb, "TGA", "P", rle=True),
        "tga_pillow_1": lambda: _pillow(bits.astype(bool), "TGA"),
        "tga_rle_top_right": lambda: f.tga_file(rgb, rle=True, top=True, right=True),
        "tga_16": lambda: f.tga_file(rgba, bits16=True, rle=True),
        "tga_map16": lambda: f.tga_file(idx, palette=pal, map_depth=16),
        "tga_map24_id": lambda: f.tga_file(idx, palette=pal, rle=True, id_section=b"abc"),
        # QOI, SGI
        "qoi_rgb": lambda: _pillow(rgb, "QOI"), "qoi_rgba": lambda: _pillow(rgba, "QOI"),
        "sgi_rgb": lambda: _pillow(rgb, "SGI"), "sgi_rgba": lambda: _pillow(rgba, "SGI"),
        "sgi_grey": lambda: _pillow(grey, "SGI"),
        "sgi_rle": lambda: f.sgi_rle_file(rgb),
        "sgi_rle_16": lambda: f.sgi_rle_file(rgba.astype(np.int64) * 257, 2),
        # PCX, DCX
        "pcx_rgb": lambda: _pillow(rgb, "PCX"), "pcx_grey": lambda: _pillow(grey, "PCX"),
        "pcx_P": lambda: _pillow(rgb, "PCX", "P"),
        "pcx_1": lambda: _pillow(bits.astype(bool), "PCX"),
        "pcx_4planes": lambda: f.pcx_file(idx % 16, pal[:16], bits=1, planes=4),
        "pcx_8_palette": lambda: f.pcx_file(idx, pal),
        "dcx": lambda: f.dcx_file([f.pcx_file(idx, pal), f.pcx_file(grey, None)]),
        # ICO, CUR, ICNS
        "ico_pillow_rgb": lambda: _pillow(rgb, "ICO"),
        "ico_pillow_rgba": lambda: _pillow(rgba, "ICO"),
        "ico_bmp32": lambda: f.ico_file([(37, 29, 32, f._dib(rgba, 32, None))]),
        "ico_bmp8_mask": lambda: f.ico_file([(37, 29, 8, f._dib(idx, 8, bits, pal))]),
        "ico_bmp24_mask_and_png": lambda: f.ico_file([(16, 16, 32, encode_png(sq)),
                                                      (37, 29, 24, f._dib(rgb, 24, bits))]),
        "cur": lambda: f.ico_file([(16, 16, 24, f._dib(rgb[:16, :16], 24, None)),
                                   (37, 29, 24, f._dib(rgb, 24, bits))], cursor=True),
        "icns_pillow_rgba": lambda: _pillow(rgba[:16, :16], "ICNS"),
        "icns_is32_mask": lambda: f.icns_file(sq[:, :, :3], sq[:, :, 3], b"is32"),
        "icns_it32_mask": lambda: f.icns_file(big, big[:, :, 0], b"it32"),
        "icns_ih32": lambda: f.icns_file(big[:48, :48], None, b"ih32"),
        # PSD
        **{f"psd_{name}_{'packbits' if pb else 'raw'}": (
            lambda planes=planes, mode=mode, pb=pb, kw=kw: f.psd_file(planes, mode, pb, **kw))
           for pb in (False, True) for name, planes, mode, kw in (
               ("rgb", rgb.transpose(2, 0, 1), 3, {}), ("rgba", rgba.transpose(2, 0, 1), 3, {}),
               ("grey", grey[None], 1, {}), ("cmyk", rgba.transpose(2, 0, 1), 4, {}),
               ("indexed", idx[None], 2, {"palette": pal}),
               ("bitmap", bits[None], 0, {"bits": 1}))},
        # DDS, FTEX, BLP
        "dds_dxt1": lambda: f.dds_file(37, 29, rng.integers(0, 256, 120 * 8, dtype=np.uint8)
                                       .tobytes(), b"DXT1"),
        "dds_dxt3": lambda: f.dds_file(37, 29, rng.integers(0, 256, 120 * 16, dtype=np.uint8)
                                       .tobytes(), b"DXT3"),
        "dds_dxt5": lambda: f.dds_file(37, 29, b3, b"DXT5"),
        "dds_ati1": lambda: f.dds_file(37, 29, rng.integers(0, 256, 120 * 8, dtype=np.uint8)
                                       .tobytes(), b"ATI1"),
        "dds_ati2": lambda: f.dds_file(37, 29, rng.integers(0, 256, 120 * 16, dtype=np.uint8)
                                       .tobytes(), b"ATI2"),
        "dds_bc5s": lambda: f.dds_file(37, 29, rng.integers(0, 256, 120 * 16, dtype=np.uint8)
                                       .tobytes(), b"BC5S"),
        "dds_bc1_dx10": lambda: f.dds_file(37, 29, b1, dxgi=71),
        "dds_bc7": lambda: f.dds_file(37, 29, b7, dxgi=98),
        **{f"dds_bc7_mode{m}": (lambda m=m: f.dds_file(37, 29, _bc7_random(m), dxgi=98))
           for m in range(8)},
        **{f"dds_bc6h_{'sf16' if dxgi == 96 else 'uf16'}_mode{m}": (
            lambda m=m, dxgi=dxgi: f.dds_file(37, 29, _bc6_random(m), dxgi=dxgi))
           for m in range(16) for dxgi in (95, 96)},
        "dds_rgba8_dx10": lambda: f.dds_file(37, 29, rgba.tobytes(), dxgi=28),
        "dds_pillow_rgb": lambda: _pillow(rgb, "DDS"), "dds_pillow_la":
            lambda: _pillow(rgba, "DDS", "LA"),
        "ftex_dxt1": lambda: f.ftex_file(37, 29, b1, 0),
        "ftex_raw": lambda: f.ftex_file(37, 29, rgb.tobytes(), 1),
        "blp1_palette": lambda: f.blp_file(1, 37, 29, idx.tobytes(), pal, encoding=5),
        "blp1_jpeg": lambda: f.blp_file(1, 37, 29, jp[2:], None, compression=0,
                                        jpeg_header=jp[:2]),
        "blp2_palette": lambda: f.blp_file(2, 37, 29, idx.tobytes(), pal, encoding=1),
        "blp2_dxt1": lambda: f.blp_file(2, 36, 28, f.bc_blocks(rgba[:28, :36], "bc1")[0], pal,
                                        encoding=2),
        "blp2_dxt3": lambda: f.blp_file(2, 36, 28, rng.integers(0, 256, 63 * 16, dtype=np.uint8)
                                        .tobytes(), pal, encoding=2, alpha=True,
                                        alpha_encoding=1),
        "blp2_dxt5": lambda: f.blp_file(2, 36, 28, f.bc_blocks(rgba[:28, :36], "bc3")[0], pal,
                                        encoding=2, alpha=True, alpha_encoding=7),
        # IM, IMT
        **{f"im_pillow_{m}": (lambda m=m: _pillow(rgba, "IM", m))
           for m in ("RGB", "RGBA", "L", "LA", "1", "P", "I", "F", "CMYK")},
        "imt": lambda: f.imt_file(grey),
        # the small rasters
        "sun_24": lambda: f.sun_file(rgb, 24), "sun_24_rle": lambda: f.sun_file(rgb, 24, True),
        "sun_32_rgb": lambda: f.sun_file(rgb, 32, rgb_order=True),
        "sun_8_palette": lambda: f.sun_file(idx, 8, palette=pal),
        "sun_8_rle": lambda: f.sun_file(idx, 8, True), "sun_1": lambda: f.sun_file(bits, 1),
        "msp_1": lambda: _pillow(bits.astype(bool), "MSP"),
        "msp_2_rle": lambda: f.msp_file(bits, True),
        "xbm_pillow": lambda: _pillow(bits.astype(bool), "XBM"),
        "xbm_hotspot": lambda: f.xbm_file(bits, (3, 4)),
        "xpm": lambda: f.xpm_file(idx % 20, pal[:20]), "pixar": lambda: f.pixar_file(rgb),
        "spider": lambda: _pillow(grey.astype(np.float32) * 1.3 - 9, "SPIDER"),
        "gbr_1_grey": lambda: f.gbr_file(grey, 1), "gbr_2_rgba": lambda: f.gbr_file(rgba, 2),
        "xvthumb": lambda: f.xvthumb_file(idx),
        "fits_8": lambda: f.fits_file(grey, 8),
        "fits_16": lambda: f.fits_file(grey.astype(np.uint16) * 3, 16),
        "fits_32": lambda: f.fits_file(grey.astype(np.int32) - 50, 32),
        "fits_float": lambda: f.fits_file(grey.astype(np.float32) * 1.7, -32),
        "mcidas_1": lambda: f.mcidas_file(grey, 1),
        "mcidas_2": lambda: f.mcidas_file(grey.astype(np.uint16) * 2, 2),
        "iptc": lambda: f.iptc_file(grey),
        "iptc_jpeg": lambda: f.iptc_file(grey, jpeg=_pillow(grey, "JPEG")),
        "iptc_rgb_band": lambda: f.iptc_file(grey, 3, 2),
        "iptc_cmyk_band": lambda: f.iptc_file(grey, 4, 1),
        # FLI / FLC, PCD
        "fli_brun": lambda: f.fli_file(idx, pal, ("COLOR256", "BRUN")),
        "fli_color_copy": lambda: f.fli_file(idx, pal & 0xFC, ("COLOR", "COPY")),
        "fli_black_lc": lambda: f.fli_file(idx, pal, ("COLOR256", "BLACK", "LC")),
        "fli_ss2": lambda: f.fli_file(idx[:, :36], pal, ("COLOR256", "SS2")),
        **{f"pcd_orientation{o}": (lambda o=o: f.pcd_file(
            rng.integers(0, 256, (512, 768), dtype=np.uint8),
            rng.integers(0, 256, (256, 384), dtype=np.uint8),
            rng.integers(0, 256, (256, 384), dtype=np.uint8), o)) for o in (0, 1, 3)},
    }
    return c


def _bc6_random(mode: int) -> bytes:
    """120 random BC6H blocks of one of the 14 modes (or, past them, a
    reserved mode, which reads black)."""
    bits = (0b00, 0b01, 0x02, 0x06, 0x0A, 0x0E, 0x12, 0x16, 0x1A, 0x1E, 0x03, 0x07, 0x0B, 0x0F,
            0x13, 0x1F)[mode]
    blocks = np.random.default_rng(50 + mode).integers(0, 256, (120, 16), dtype=np.uint8)
    blocks[:, 0] = (blocks[:, 0] & (0xFC if mode < 2 else 0xE0)) | bits
    return blocks.tobytes()


def _bc7_random(mode: int) -> bytes:
    """120 random BC7 blocks of one mode (its bit set above zero bits)."""
    blocks = np.random.default_rng(mode).integers(0, 256, (120, 16), dtype=np.uint8)
    blocks[:, 0] = (blocks[:, 0].astype(int) & ((0xFF << (mode + 1)) & 0xFF)) | (1 << mode)
    return blocks.tobytes()


_CASES = _cases()


def assert_like_pillow(data: bytes) -> np.ndarray:
    """The port's decode equals Pillow's image of the same bytes: through
    JAX's flatten (img2img's RGB) and convert("L"), with the info keys of
    ``_INFO_KEYS`` both give."""
    got, info = decode_image(data)
    with Image.open(io.BytesIO(data)) as im:
        ref_info = {k: v for k, v in im.info.items() if k in _INFO_KEYS}
        want_l = np.asarray(im.convert("L"))
        if im.format == "ICNS" and im.mode == "RGBA":
            # an ICNS reports RGBA until loaded; an RGB PNG entry makes JAX's
            # flatten fail ("bad transparency mask"): held to convert()
            im.load()
        want_rgb = np.asarray(jax_images.flatten(im, _BG))
    info = {k: v for k, v in info.items() if k in ref_info}
    assert info == ref_info
    np.testing.assert_array_equal(images_util.flatten(got, _BG), want_rgb)
    np.testing.assert_array_equal(images_util.to_l(got), want_l)
    return got


@pytest.mark.parametrize("case", sorted(_CASES))
def test_reader_matches_pillow(case):
    assert_like_pillow(_CASES[case]())


def test_palette_tga_rle_reads_where_pillow_overruns():
    """A colour-mapped RLE TGA whose packets cross rows where Pillow's
    decoder loses its place ("buffer overrun when reading image file"):
    the port reads the packets as the TGA format lays them out, so it reads
    the pixels (ROADMAP departures)."""
    rng = np.random.default_rng(0)
    pal = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    rng.integers(0, 256, (4, 8, 8))
    idx = rng.integers(0, 256, (128, 160)).astype(np.uint8)   # a layout Pillow overruns on
    data = f.tga_file(idx, palette=pal, rle=True)
    with pytest.raises(OSError, match="overrun"):
        Image.open(io.BytesIO(data)).load()
    np.testing.assert_array_equal(decode_image(data)[0], pal[idx])


def test_icns_rgb_png_reads_where_jax_flatten_fails():
    """Pillow's own ICNS of an RGB image holds RGB PNGs; Image.open calls it
    RGBA until it loads, so JAX's flatten (img2img) raises "bad transparency
    mask" on it.  The port reads the pixels (ROADMAP departures)."""
    rgb = _sample(16, 16)[0]
    data = _pillow(rgb, "ICNS")
    got = decode_image(data)[0]
    with Image.open(io.BytesIO(data)) as im:
        with pytest.raises(ValueError, match="bad transparency mask"):
            jax_images.flatten(im, _BG)
    with Image.open(io.BytesIO(data)) as im:
        np.testing.assert_array_equal(got, np.asarray(im.convert("RGB")))
    assert got.shape == (1024, 1024, 3)


# --------------------------------------------------------------------------
# Image.open's order
# --------------------------------------------------------------------------

def _plugin(data: bytes) -> str | None:
    """The plugin Pillow opens the bytes with, or None."""
    try:
        with Image.open(io.BytesIO(data)) as im:
            return {"JPEG2000": "JPEG2000", "XVThumb": "XVTHUMB"}.get(im.format, im.format)
    except Exception:
        return None


def _port_plugin(data: bytes) -> str | None:
    """The port's plugin for the bytes: the first whose accept takes them
    and whose decoder does not refuse them as not its own."""
    for name, accept, decoder in image_io._order():
        if accept is not None and not accept(data[:16]):
            continue
        try:
            decoder(data)
        except image_io.NotThisFormat:
            continue
        except ValueError:
            return name
        return name
    return None


def _order_cases() -> dict:
    rgb = _sample(8, 8)[0]
    tga = f.tga_file(rgb)
    return {
        # a DIB header size at the start: the DIB plugin (pre-init) first
        "dib_before_tga": b"(\0\0\0" + struct.pack("<iiHHIIiiII", 4, 4, 1, 24, 0, 0, 0, 0, 0, 0)
        + bytes(48),
        # TGA bytes with an image type it takes, shaped by the other magics
        "tga_plain": tga,
        "tga_id_0x0a": bytes([10, 0]) + tga[2:],           # not PCX: byte 1 is no version
        "pcx_not_tga": _pillow(rgb, "PCX"),
        "ico_not_tga": _pillow(rgb, "ICO"),
        "cur_not_tga": f.ico_file([(8, 8, 24, f._dib(rgb, 24, None))], cursor=True),
        # the PPM plugin takes P1-P6 and Pf, refuses P7 (PAM) and PF
        "pam_falls_through": b"P7\nWIDTH 2\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nTUPLTYPE RGB\n"
                             b"ENDHDR\n" + bytes(12),
        "colour_pfm_falls_through": b"PF\n2 2\n-1.0\n" + bytes(48),
        "xvthumb_after_ppm": f.xvthumb_file(np.zeros((4, 4), np.uint8)),
        # text: IM and IMT refuse an XPM, which reads as XPM
        "xpm_not_im": f.xpm_file(np.zeros((4, 4), np.uint8), np.zeros((2, 3), np.uint8)),
        "im_header": _pillow(rgb, "IM"),
        "imt_header": f.imt_file(np.zeros((4, 4), np.uint8)),
        "xbm_text": f.xbm_file(np.ones((4, 9), np.uint8)),
        "plain_text": b"hello world\nthis is not an image\n",
        # SPIDER and IPTC have no accept either
        "spider": _pillow(np.zeros((4, 4), np.float32), "SPIDER"),
        "iptc": f.iptc_file(np.zeros((4, 4), np.uint8)),
        "pcd": f.pcd_file(np.zeros((512, 768), np.uint8), np.full((256, 384), 156, np.uint8),
                          np.full((256, 384), 137, np.uint8)),
        # a PSD with 16-bit channels: Pillow's table has no mode, so it falls
        # through (and nothing else takes it)
        "psd_16bit": b"8BPS" + struct.pack(">H6xHIIHH", 1, 3, 2, 2, 16, 3) + bytes(20),
        # GBR's accept is two big-endian integers
        "gbr": f.gbr_file(np.zeros((4, 4), np.uint8), 1),
        # SUN and MCIDAS magics
        "sun": f.sun_file(rgb, 24), "mcidas": f.mcidas_file(np.zeros((4, 4), np.uint8)),
        # FLI and FITS
        "fli": f.fli_file(np.zeros((4, 4), np.uint8), np.zeros((256, 3), np.uint8)),
        "fits": f.fits_file(np.zeros((4, 4), np.uint8), 8),
        # QOI, DDS, ICNS, PSD, SGI, PIXAR, MSP, XPM, BLP and FTEX magics
        "qoi": _pillow(rgb, "QOI"), "dds": _pillow(rgb, "DDS"), "icns": _pillow(rgb, "ICNS"),
        "psd": f.psd_file(rgb.transpose(2, 0, 1), 3), "sgi": _pillow(rgb, "SGI"),
        "pixar": f.pixar_file(rgb), "msp": _pillow(np.zeros((8, 8), bool), "MSP"),
        "blp": f.blp_file(2, 8, 8, bytes(64), np.zeros((256, 3), np.uint8)),
        "ftex": f.ftex_file(8, 8, rgb.tobytes(), 1),
        "dcx": f.dcx_file([_pillow(rgb, "PCX")]),
    }


_ORDER = _order_cases()


@pytest.mark.parametrize("case", sorted(_ORDER))
def test_open_order_matches_pillow(case):
    data = _ORDER[case]
    want = _plugin(data)
    got = _port_plugin(data)
    if want is None:
        # Pillow opens nothing (or a plugin's error stops it): neither does the port
        with pytest.raises(ValueError):
            decode_image(data)
    else:
        assert got == want
        assert_like_pillow(data)


# --------------------------------------------------------------------------
# what still refuses names itself
# --------------------------------------------------------------------------

def _refused() -> dict:
    rgb = _sample(8, 8)[0]
    tiff = lambda code: f.tiff_file(rgb, tags={259: (3, [code])})  # noqa: E731
    return {
        "AVIF": _pillow(rgb, "AVIF"),
        "EPS": _pillow(rgb, "EPS"),
        "WMF": b"\xd7\xcd\xc6\x9a\x00\x00" + bytes(40),
        "EMF": b"\x01\x00\x00\x00" + bytes(36) + b" EMF" + bytes(40),
        "MPEG": b"\x00\x00\x01\xb3" + bytes(12),
        "BUFR": b"BUFR" + bytes(12), "GRIB": b"GRIB\0\0\0\x01" + bytes(8),
        "HDF5": b"\x89HDF\r\n\x1a\n" + bytes(8),
        "TIFF with WebP": tiff(50001), "TIFF with ThunderScan": tiff(32809),
        "TIFF with SGILog": tiff(34676), "TIFF with raw_16": tiff(32771),
    }


_REFUSED = _refused()


@pytest.mark.parametrize("fmt", sorted(_REFUSED))
def test_refusals_name_their_format(fmt):
    with pytest.raises(UnsupportedImageFormat) as e:
        decode_image(_REFUSED[fmt])
    name = fmt.replace(" codestream", "").split(" with ")[-1]
    assert name.split()[0] in e.value.fmt


# --------------------------------------------------------------------------
# the request routes
# --------------------------------------------------------------------------

def _route_files() -> dict:
    """A TGA (RLE), a PSD (PackBits) and a Zstandard TIFF of three images."""
    out = {}
    for k, name in enumerate(("tga", "psd", "zstd_tiff")):
        rng = np.random.default_rng(30 + k)
        y, x = np.mgrid[0:64, 0:64]
        img = np.clip(np.stack([x * 3 + k * 40, y * 3, (x + y) * 2], 2)
                      + rng.integers(0, 12, (64, 64, 3)), 0, 255).astype(np.uint8)
        if name == "tga":
            data = f.tga_file(img, rle=True)
        elif name == "psd":
            data = f.psd_file(img.transpose(2, 0, 1), 3, packbits=True)
        else:
            data = f.tiff_file(img, "zstd", rows_per_strip=16)
        out[name] = data
    return out


@pytest.fixture(scope="module")
def port_api(models):  # noqa: F811
    return Api(Engine(model=models[1], device="cpu", hash_cache=None))


@pytest.mark.parametrize("name", ["tga", "psd", "zstd_tiff"])
def test_img2img_init_image_matches_jax(models, f32_policies, port_api, both, name):  # noqa: F811
    """A base64 init image: the port's answer within 1 level of JAX's
    pipeline on the image JAX's route decodes from the same field
    (``decode_base64_to_image``), the same infotext."""
    both(sdtpu_vae_bf16=False)
    b64 = base64.b64encode(_route_files()[name]).decode()
    kw = dict(prompt="a cat", seed=13, steps=2, width=64, height=64, denoising_strength=0.7)
    ref = jax_i2i.process_img2img(models[0], JaxParams(
        init_images=[jax_app.decode_base64_to_image(b64)], **kw))
    status, out = port_api.handle("POST", "/sdapi/v1/img2img", dict(kw, init_images=[b64]))
    assert status == 200, out
    got, text = decode_png(base64.b64decode(out["images"][0]))
    assert np.abs(got.astype(int) - np.asarray(ref.images[0], int)).max() <= 1
    assert text["parameters"] == ref.infotexts[0]


def test_img2img_batch_matches_jax(models, f32_policies, port_api, tmp_path, both,  # noqa: F811
                                   fixed_clock):  # noqa: F811
    """The three files under .png, .bmp and .webp names: the port's batch
    and JAX's give the same outputs (within 1 level) and infotexts."""
    both(sdtpu_vae_bf16=False)
    src = tmp_path / "in"
    src.mkdir()
    for (name, data), ext in zip(_route_files().items(), ("png", "bmp", "webp")):
        (src / f"{name}.{ext}").write_bytes(data)
    body = {"input_dir": str(src), "prompt": "base", "seed": 9, "steps": 2, "width": 64,
            "height": 64, "denoising_strength": 0.6}
    ref = jax_api.Api.img2img_batch(_jax_self(models[0]),
                                    dict(body, output_dir=str(tmp_path / "jax")))
    status, out = port_api.handle("POST", "/internal/img2img-batch",
                                  dict(body, output_dir=str(tmp_path / "port")))
    assert status == 200, out
    assert out["processed"] == ref["processed"] == 3
    for ours, theirs in zip(out["outputs"], ref["outputs"]):
        assert os.path.basename(ours) == os.path.basename(theirs)
        img, text = decode_png(open(ours, "rb").read())
        with Image.open(theirs) as im:
            assert np.abs(img.astype(int) - np.asarray(im, int)).max() <= 1
            assert text["parameters"] == im.info["parameters"]


def test_dataset_directory_matches_jax(models, f32_policies, tmp_path):  # noqa: F811
    """A dataset directory of the three files (under image extensions):
    the port's entries and latents as JAX's (latents within 1e-5 of their
    largest magnitude)."""
    jm, pm = models
    for (name, data), ext in zip(_route_files().items(), ("png", "jpg", "webp")):
        (tmp_path / f"{name}.{ext}").write_bytes(data)
    kw = dict(width=64, height=64, template="subject_filewords", placeholder="tok", seed=2)
    ref = jax_ds.PersonalizedDataset(str(tmp_path), jm, **kw)
    out = port_ds.PersonalizedDataset(str(tmp_path), pm, **kw)
    assert len(out.entries) == len(ref.entries) == 3
    for e, r in zip(out.entries, ref.entries):
        assert (e.filename, e.filename_text, e.bucket) == (r.filename, r.filename_text, r.bucket)
        assert _rel(e.latent.numpy().transpose(1, 2, 0), r.latent) <= 1e-5


@pytest.mark.parametrize("fmt", ["PSD", "QOI", "PPM", "TGA", "JPEG2000"])
@pytest.mark.parametrize("route,field", [("/sdapi/v1/img2img", "init_images"),
                                         ("/sdapi/v1/img2img", "mask"),
                                         ("/sdapi/v1/extra-single-image", "image"),
                                         ("/sdapi/v1/png-info", "image")])
def test_rare_input_formats_are_read(port_api, route, field, fmt):
    """Each image field reads the format: the answer is the one the PNG of
    the same pixels gets (PSD, QOI, PPM and JPEG 2000 were refused before
    this port read them)."""
    img = _sample(64, 64, 3)[0]
    mask = np.zeros((64, 64, 3), np.uint8)
    mask[16:48, 16:48] = 255
    src = mask if field == "mask" else img
    data = {"PSD": lambda: f.psd_file(src.transpose(2, 0, 1), 3, packbits=True),
            "QOI": lambda: _pillow(src, "QOI"), "PPM": lambda: _pillow(src, "PPM"),
            "TGA": lambda: f.tga_file(src, rle=True),
            "JPEG2000": lambda: _pillow(src, "JPEG2000")}[fmt]()
    answers = []
    for payload in (data, encode_png(src)):
        b64 = base64.b64encode(payload).decode()
        if route.endswith("img2img"):
            body = {"init_images": [base64.b64encode(encode_png(img)).decode()], "steps": 1,
                    "width": 64, "height": 64, "seed": 5, "inpaint_full_res": False}
            body[field] = [b64] if field == "init_images" else b64
        elif "extra" in route:
            body = {"image": b64, "upscaler_1": "Lanczos", "upscaling_resize": 1.5}
        else:
            body = {"image": b64}
        status, out = port_api.handle("POST", route, body)
        assert status == 200, out
        answers.append(out.get("images") or out.get("image") or out.get("info"))
    assert answers[0] == answers[1]


_RARE_SAMPLE = np.clip(np.stack(np.mgrid[0:128, 0:160], 2).sum(2, keepdims=True) // 2
                       + np.random.default_rng(12).integers(0, 40, (128, 160, 3)), 0, 255) \
    .astype(np.uint8)
_RARE = f.rare_files(_RARE_SAMPLE)


@pytest.mark.parametrize("name", sorted(_RARE))
def test_rare_files_decode_to_their_pixels(name):
    """The files the card's smoke run decodes (chip_smoke 4t (a), there at
    512²): the port's decode equals the pixels each writer put in, and
    Pillow's image of the same bytes."""
    data, want = _RARE[name]
    got = decode_image(data)[0]
    np.testing.assert_array_equal(got, want)
    with Image.open(io.BytesIO(data)) as im:
        ref = np.asarray(im.convert({1: "L", 3: "RGB", 4: "RGBA"}[got.shape[2]]))
    np.testing.assert_array_equal(got.reshape(ref.shape), ref)


@pytest.mark.parametrize("route,field", [("/sdapi/v1/img2img", "init_images"),
                                         ("/sdapi/v1/img2img", "mask"),
                                         ("/sdapi/v1/extra-single-image", "image"),
                                         ("/sdapi/v1/png-info", "image")])
def test_zstd_tiff_bomb_answers_400(port_api, route, field):
    """A 64² Zstandard TIFF of 4 KB whose one strip is 1000 RLE blocks, each
    declaring 2 MiB (2 GB in all), answers 400 without a large allocation:
    libzstd refuses a block over its frame's window or 128 KiB, and so does
    the port (JAX's Pillow raises OSError on the same bytes)."""
    import tracemalloc

    frame = struct.pack("<IBB", 0xFD2FB528, 0, 0x38) + b"".join(
        struct.pack("<I", (i == 999) | (1 << 1) | (((1 << 21) - 1) << 3))[:3] + b"\x07"
        for i in range(1000))
    data = f.tiff_file(np.full((64, 64, 3), 7, np.uint8), "zstd", encoder=lambda _: frame)
    with pytest.raises(OSError), Image.open(io.BytesIO(data)) as im:
        im.load()
    b64 = base64.b64encode(data).decode()
    body = {"init_images": [_b64_png()], "steps": 1, "width": 64, "height": 64} \
        if route.endswith("img2img") else {"upscaler_1": "Lanczos"} if "extra" in route else {}
    body[field] = [b64] if field == "init_images" else b64
    tracemalloc.start()
    try:
        status, res = port_api.handle("POST", route, body)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert status == 400 and "zstd: a block of 2097151 bytes" in res["detail"], res
    assert peak < 16 << 20


def _b64_png() -> str:
    return base64.b64encode(encode_png(np.full((64, 64, 3), 90, np.uint8))).decode()
