"""Write ``sdwebui_tpu_torch/fonts/aileron_10.npz``: Pillow's default font
(``ImageFont.load_default()``, the Aileron Regular subset at 10 px, basic
layout) as FreeType draws each of its glyphs.

    python3 tools/make_default_font_atlas.py

The subset has no TrueType instructions, so FreeType auto-hints it (its
``autofit`` module, which ``utils/truetype_hint.py`` does not restate).
This records, for every character of the subset's cmap and for
``.notdef``, what that gives at the one size the embedding card draws
with: the glyph's mask and its offset from the pen at the baseline
(``getmask2(ch, anchor="ls")``), its box (``getbbox(ch, anchor="ls")``)
and its advance (``getlength``).  ``utils/text_raster.load_default`` lays
strings out from these.  Needs Pillow with FreeType (run it where the
tests run, not on the card's machine).
"""

from __future__ import annotations

import os
import sys

import numpy as np
from PIL import ImageFont

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from sdwebui_tpu_torch.utils import text_raster, truetype  # noqa: E402

SIZE = 10
NOTDEF_PROBE = "一"           # a character the subset lacks: drawn as glyph 0


def main() -> int:
    font = ImageFont.load_default()
    with open(text_raster.AILERON, "rb") as f:
        sub = truetype.Font(f.read())
    chars = sorted(sub.cmap)
    gids = [sub.cmap[c] for c in chars] + [0]
    texts = [chr(c) for c in chars] + [NOTDEF_PROBE]
    masks, shapes, offsets, boxes, advances = [], [], [], [], []
    for t in texts:
        m, off = font.getmask2(t, "L", anchor="ls")
        a = np.asarray(m, np.uint8).reshape(m.size[1], m.size[0]) if m.size[0] * m.size[1] \
            else np.zeros((m.size[1], m.size[0]), np.uint8)
        masks.append(a.ravel())
        shapes.append(a.shape)
        offsets.append(off)
        boxes.append(font.getbbox(t, anchor="ls"))
        advances.append(round(font.getlength(t) * 64))
    path = os.path.join(text_raster.FONT_DIR, f"aileron_{SIZE}.npz")
    np.savez_compressed(path, gids=np.asarray(gids, np.int32),
                        shapes=np.asarray(shapes, np.int32),
                        offsets=np.asarray(offsets, np.int32),
                        boxes=np.asarray(boxes, np.int32),
                        advances=np.asarray(advances, np.int32),
                        masks=np.concatenate(masks))
    print(f"wrote {path}: {len(gids)} glyphs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
