"""The JPEG 2000 encoder (``utils/jpeg2000.encode_jpeg2000``) against
Pillow 12.1 with OpenJPEG 2.5.4, and tier-1 alone.

The encoder's bytes equal Pillow's for L, LA, RGB and RGBA at 1×1, 7×5,
64×48, 33×200 and 256², for JAX's ``image.save(f"x.{ext}")`` under each of
the six extensions (a raw codestream for .j2k, JP2 for the others).
Tier-1 (``utils/j2k_t1``) round-trips coefficients under every code-block
style and their mixes, in blocks of several sizes and orientations, and
decodes random code-block bytes as OpenJPEG does."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
import functools
import io

import numpy as np
import pytest
from PIL import Image

from sdwebui_tpu_torch.utils import j2k_t1
from sdwebui_tpu_torch.utils.jpeg2000 import encode_jpeg2000
from test_torch_jpeg2000 import CHANNELS, _sample

_SIZES = [(1, 1), (7, 5), (64, 48), (33, 200), (256, 256)]
_EXTS = ["jp2", "j2k", "jpx", "jpf", "j2c", "jpc"]


@functools.lru_cache(maxsize=None)
def _encoded(mode: str, size: tuple, kind: str) -> bytes:
    w, h = size
    return encode_jpeg2000(_sample(h, w, CHANNELS[mode], w * 7 + h), kind)


@pytest.mark.parametrize("ext", _EXTS)
@pytest.mark.parametrize("size", _SIZES, ids=[f"{w}x{h}" for w, h in _SIZES])
@pytest.mark.parametrize("mode", list(CHANNELS))
def test_encoder_bytes_equal_pillow(tmp_path, mode, size, ext):
    """Pillow's ``image.save(f"x.{ext}")`` (JAX's call): a raw codestream
    for .j2k alone, JP2 for the other five, OpenJPEG's defaults."""
    w, h = size
    a = _sample(h, w, CHANNELS[mode], w * 7 + h)
    path = str(tmp_path / f"x.{ext}")
    Image.fromarray(a[:, :, 0] if a.shape[2] == 1 else a, mode).save(path, quality=80)
    kind = "j2k" if ext == "j2k" else "jp2"
    assert _encoded(mode, size, kind) == open(path, "rb").read()


# -- tier-1 alone


@pytest.mark.parametrize("style", range(64))
def test_tier1_round_trip(style):
    """Blocks of several sizes and orientations coded and decoded under
    every code-block style and mix of them: the coefficients come back."""
    rng = np.random.default_rng(style)
    blocks = []
    for k, (h, w) in enumerate([(32, 32), (13, 7), (4, 4), (1, 1), (17, 24), (6, 40)]):
        c = rng.laplace(0, 9, (h, w)).astype(np.int64)
        blocks.append(j2k_t1.CodeBlock(w, h, k % 4, 0, style=style, coefs=c))
    j2k_t1.encode_blocks(blocks)
    dec = []
    for b in blocks:
        segs, start, first = [], 0, 0
        for p in range(b.passes):
            if b.pass_terms[p]:
                segs.append((p + 1 - first, b.data[start:b.pass_ends[p]]))
                start, first = b.pass_ends[p], p + 1
        dec.append(j2k_t1.CodeBlock(b.w, b.h, b.orient, b.numbps, style=style, segments=segs))
    for b, v in zip(blocks, j2k_t1.decode_blocks(dec)):
        np.testing.assert_array_equal(np.where(v < 0, -((-v) >> 1), v >> 1), b.coefs)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("style", [0, 1, 2, 4, 8, 16, 32, 63])
def test_tier1_decodes_any_bytes_as_openjpeg(style, seed):
    """A codestream whose code-block data is random bytes (0xFF followed
    by carries and by markers among them), its packet headers packed in
    PPM: the port decodes it to Pillow's pixels, 0 levels apart."""
    from test_torch_jpeg2000 import _held_to_pillow
    from sdwebui_tpu_torch.utils.jpeg2000 import encode_codestream

    a = _sample(36, 40, 3, seed)
    data = bytearray(encode_codestream([a[:, :, c] for c in range(3)], 40, 36, cblk=(4, 4),
                                       cblksty=style, packed="ppm"))
    sod = data.index(b"\xff\x93") + 2
    end = len(data) - 2                      # EOC
    rng = np.random.default_rng(seed * 64 + style)
    body = rng.integers(0, 256, end - sod, dtype=np.uint8)
    ff = np.flatnonzero(rng.random(body.size - 1) < 0.05)
    body[ff] = 0xFF
    body[ff + 1] = np.where(rng.random(ff.size) < 0.8, rng.integers(0x80, 0x90, ff.size),
                            body[ff + 1])
    data[sod:end] = body.tobytes()
    _held_to_pillow(bytes(data), False, f"style {style}")
