"""The port's TrueType reader, hinter and rasterizer against Pillow 12.1
with FreeType 2.14 and raqm (``utils/truetype.py``,
``utils/truetype_hint.py``, ``utils/text_raster.py``).

For every printable ASCII and Latin-1 character of DejaVuSans (the font
JAX's grids draw with) at each size 6–64: the hinted glyph box equal to
Pillow's ``getbbox`` and the glyph mask to ``getmask2``, level for level.
Words and word pairs: ``getlength`` equal to Pillow's to 1/64 px, with
GPOS kerning and the fi ligature, and their masks at the anchors and
fractional start points the legend draws with.  Pillow's default font
(the Aileron subset at 10 px the embedding card draws with): every box,
advance and mask.  Planted faults must fail the comparisons: the hinting
skipped (boxes off, as the reference figure of about 18% said) and the
kerning dropped.  What raqm shapes and the port does not raises.
"""

import torch_threads  # noqa: F401  (one thread share per xdist worker)

import numpy as np
import pytest
from PIL import Image, ImageDraw, ImageFont

from sdwebui_tpu_torch.utils import text_raster, truetype, truetype_hint

SYSTEM_DEJAVU = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"
CHARS = [chr(c) for c in range(33, 127)] + [chr(c) for c in range(161, 256) if c != 0xAD]
WORDS = ["AV", "To", "fine fish", "Wave", "Yo, LT", "hello world", "0.5", "7.5", "1024",
         "Prompt S/R: cat", "Euler a", "CFG Scale: 7", "DPM++ 2M Karras", "Tyre", "VA",
         "AVATAR", "P.J.", "a photograph of an astronaut", "ÀÉÎõü ßæ", "Привет", "x\xady",
         "Seed: -1", "(masterpiece:1.2)"]


def _pil_font(size):
    return ImageFont.truetype(SYSTEM_DEJAVU, size)


def _mask(m) -> np.ndarray:
    w, h = m.size
    return np.asarray(m, np.uint8).reshape(h, w) if w * h else np.zeros((h, w), np.uint8)


def test_the_packaged_font_is_the_one_pillow_opens():
    with open(SYSTEM_DEJAVU, "rb") as a, open(text_raster.DEJAVU_SANS, "rb") as b:
        assert a.read() == b.read()
    assert ImageFont.truetype("DejaVuSans.ttf", 12).path == SYSTEM_DEJAVU


@pytest.mark.parametrize("size", range(6, 65))
def test_glyph_boxes_and_masks_equal_pillow(size):
    """Every glyph's hinted box and mask, and the share of boxes an unhinted
    outline would get wrong at this size (the planted fault), returned to
    the size sweep below."""
    pil, port = _pil_font(size), text_raster.Face(text_raster.DEJAVU_SANS, size)
    for ch in CHARS:
        assert port.getbbox(ch) == tuple(pil.getbbox(ch)), ch
        want, off = pil.getmask2(ch, "L")
        got, got_off = port.getmask2(ch)
        assert got_off == tuple(off), ch
        np.testing.assert_array_equal(got, _mask(want), err_msg=ch)


def test_skipping_the_hinting_fails_the_boxes():
    """The planted fault: the same glyphs drawn from their unhinted outline
    miss Pillow's box in a sizeable share of cases (the reference figure:
    701 of 3808, 18%)."""
    off = total = 0
    for size in range(6, 65, 3):
        pil = _pil_font(size)
        raw = text_raster.Face(text_raster.DEJAVU_SANS, size, hinting=False)
        for ch in CHARS:
            total += 1
            off += raw.getbbox(ch) != tuple(pil.getbbox(ch))
    assert off / total > 0.05, (off, total)


@pytest.mark.parametrize("size", [6, 9, 12, 16, 20, 27, 33, 40, 51, 64])
def test_words_length_box_and_mask_equal_pillow(size):
    """getlength to 1/64 px (kerning, ligatures, a hidden soft hyphen),
    getbbox at "la" and "mm", and getmask2 at fractional starts."""
    pil, port = _pil_font(size), text_raster.truetype(text_raster.DEJAVU_SANS, size)
    rng = np.random.default_rng(size)
    for word in WORDS:
        assert port.getlength(word) == pil.getlength(word), word
        for anchor in ("la", "mm"):
            assert port.getbbox(word, anchor) == tuple(pil.getbbox(word, anchor=anchor)), word
            for start in ((0.0, 0.0), (0.5, 0.5), tuple(rng.random(2))):
                want, off = pil.getmask2(word, "L", anchor=anchor, start=start)
                got, got_off = port.getmask2(word, anchor, start)
                assert got_off == tuple(off), (word, anchor, start)
                np.testing.assert_array_equal(got, _mask(want), err_msg=f"{word} {start}")


def test_dropping_the_kerning_fails_the_lengths():
    """The planted fault: without GPOS kerning the kerned pairs' lengths
    differ from Pillow's."""
    pairs = ["AV", "To", "Wa", "Yo", "LT", "P.", "VA", "Ty"]
    for size in (12, 40):
        pil = _pil_font(size)
        plain = text_raster.Face(text_raster.DEJAVU_SANS, size, kerning=False)
        kerned = text_raster.Face(text_raster.DEJAVU_SANS, size)
        assert all(kerned.getlength(p) == pil.getlength(p) for p in pairs)
        assert sum(plain.getlength(p) != pil.getlength(p) for p in pairs) >= len(pairs) - 1


def test_default_font_equals_pillows():
    """ImageFont.load_default(): the Aileron subset at 10 px, basic layout,
    through FreeType's auto-hinter (glyphs from the recorded table):
    boxes, lengths and masks of strings; another size raises."""
    pil, port = ImageFont.load_default(), text_raster.load_default()
    for word in ["my-embedding", "step 500", "AV To", "fine", "ünïcode 中", "0123456789 %$#"]:
        assert port.getlength(word) == pil.getlength(word), word
        assert port.getbbox(word) == tuple(pil.getbbox(word)), word
        want, off = pil.getmask2(word, "L")
        got, got_off = port.getmask2(word)
        assert got_off == tuple(off)
        np.testing.assert_array_equal(got, _mask(want), err_msg=word)
    with pytest.raises(NotImplementedError, match="auto-hinter"):
        text_raster.load_default(size=40)


def test_draw_text_and_strike_line_on_rgb_equal_pillow():
    """ImageDraw.text's ink blend on an RGB image at fractional anchors, and
    ImageDraw.line of width 4, pixel for pixel."""
    img = np.full((90, 320, 3), 240, np.uint8)
    img[:, 160:] = (20, 90, 200)
    pil = Image.fromarray(img.copy())
    draw = ImageDraw.Draw(pil)
    for (xy, text, size, fill) in (((150.5, 30.25), "Hello AV world", 23, (0, 0, 0)),
                                   ((210.75, 60.5), "struck, fi", 17, (153, 153, 153)),
                                   ((-3.5, 80.0), "off the edge", 20, (255, 0, 0))):
        draw.text(xy, text, fill=fill, font=_pil_font(size), anchor="mm")
        text_raster.draw_text(img, xy, text, text_raster.truetype(text_raster.DEJAVU_SANS,
                                                                  size), fill, "mm")
    for x0, x1, y in ((10.5, 150.5, 20.5), (100, 300, 60), (-3.2, 40.9, 88.7)):
        draw.line((x0, y, x1, y), fill=(9, 8, 7), width=4)
        text_raster.draw_hline(img, x0, x1, y, (9, 8, 7), 4)
    np.testing.assert_array_equal(img, np.asarray(pil))


@pytest.mark.parametrize("text,match", [
    ("שלום", "right-to-left"), ("مرحبا", "right-to-left"), ("é", "combining"),
    ("नमस्ते", "Devanagari"), ("abc αβγ", "mixing scripts")])
def test_unported_shaping_raises(text, match):
    font = truetype.Font(open(text_raster.DEJAVU_SANS, "rb").read())
    with pytest.raises(NotImplementedError, match=match):
        truetype.shape(font, text)


def test_font_files_the_reader_refuses(tmp_path):
    cff = tmp_path / "a.otf"
    cff.write_bytes(b"OTTO" + bytes(60))
    with pytest.raises(NotImplementedError, match="CFF"):
        truetype.Font(cff.read_bytes())
    with pytest.raises(OSError):
        truetype.Font(b"not a font at all")


def test_reader_tables_match_the_file():
    """cmap, hmtx and the glyf points against fontTools' reading of the
    same file."""
    from fontTools.ttLib import TTFont

    ft = TTFont(text_raster.DEJAVU_SANS)
    font = truetype.Font(open(text_raster.DEJAVU_SANS, "rb").read())
    order = ft.getGlyphOrder()
    cmap = ft.getBestCmap()
    assert {c: order[g] for c, g in font.cmap.items()} == cmap
    for ch in CHARS:
        name = cmap[ord(ch)]
        gid = font.cmap[ord(ch)]
        assert (int(font.advances[gid]), int(font.lsbs[gid])) == ft["hmtx"][name]
        g = ft["glyf"][name]
        if g.isComposite():
            assert [order[c[0]] for c in font.glyph(gid).components] == \
                [c.glyphName for c in g.components]
        elif g.numberOfContours > 0:
            np.testing.assert_array_equal(font.glyph(gid).points,
                                          np.asarray(g.getCoordinates(ft["glyf"])[0]))


def test_fixed_point_helpers():
    """FreeType's rounding: FT_MulFix and TT_MulFix14 round half away from
    zero, FT_MulDiv likewise, and FT_Vector_NormLen gives unit vectors."""
    assert truetype_hint.mulfix(0x8000, 1) == 1 and truetype_hint.mulfix(-0x8000, 1) == -1
    assert truetype_hint.mulfix14(0x2000, 1) == 1 and truetype_hint.mulfix14(-0x2000, 1) == -1
    assert truetype_hint.muldiv(3, 5, 2) == 8 and truetype_hint.muldiv(-3, 5, 2) == -8
    for v in [(3, 4), (-100, 7), (1, 1), (5000, -12), (0, -9)]:
        ux, uy = truetype_hint.norm_len(*v)
        assert abs(np.hypot(ux, uy) / 65536 - 1) < 1e-4
        assert abs(np.arctan2(uy, ux) - np.arctan2(v[1], v[0])) < 1e-3
