"""Grid legends and the prompt matrix's legend, on numpy images.

Port of ``sdwebui_tpu/utils/grid_annotations.py``: the same measure pass
(``_layout_labels``: greedy word wrap to the cell or gutter width, each
line's box) and paint pass (``_paint_label_block``: each line shrinks its
font until it fits, centred at its anchor "mm", inactive lines struck
through with a 4-px line), the same gutters (the left one 3/4 of a cell
when a row label has text, the top one the tallest column label plus one
line of spacing above and below) and the same options (``font``,
``grid_text_active_color``, ``grid_text_inactive_color``,
``grid_background_color``, read through Pillow's colour grammar,
``utils/image_color``).  Images are uint8 HWC arrays, as the port's
``image_grid`` makes them; the text is drawn by ``utils/text_raster`` as
Pillow draws it (``_load_font``: the ``font`` option's file, else
DejaVuSans from the package, else the default font at that size).
"""

from __future__ import annotations

import functools
import math
import os
from dataclasses import dataclass, field

import numpy as np

from sdwebui_tpu_torch.utils import image_color, text_raster


class GridAnnotation:
    """One label fragment for a grid row/column (public API)."""

    def __init__(self, text: str = "", is_active: bool = True):
        self.text = text
        self.is_active = is_active


@dataclass
class _Line:
    """A single wrapped, measured line of label text."""

    text: str
    active: bool
    w: int = 0
    h: int = 0


@dataclass
class _LabelBlock:
    """All wrapped lines for one row/column label + the width they may use."""

    lines: list = field(default_factory=list)
    max_width: int = 0

    def height(self, spacing: int, per_line_spacing: bool) -> int:
        """Total painted height.  Column blocks separate lines by `spacing`;
        row blocks deduct spacing per line (the reference's geometry)."""
        if not self.lines:
            return 0
        total = sum(ln.h + spacing for ln in self.lines)
        return total - spacing * (len(self.lines) if per_line_spacing else 1)


@functools.lru_cache(maxsize=64)
def _load_font(path: str, fontsize: int):
    """``ImageFont.truetype(path or "DejaVuSans.ttf", fontsize)``, and
    Pillow's default font at that size when the file cannot be opened
    (``grid_annotations.py:61-68``).  "DejaVuSans.ttf" is the package's
    copy, as Pillow finds the system's.  A font Pillow would read and the
    port does not (CFF outlines, a collection) raises NotImplementedError
    rather than fall back."""
    name = path or "DejaVuSans.ttf"
    if name == "DejaVuSans.ttf":
        name = text_raster.DEJAVU_SANS
    try:
        return text_raster.truetype(os.fspath(name), fontsize)
    except NotImplementedError:        # a font Pillow reads and the port does not
        raise
    except Exception:                  # a file Pillow cannot open either
        return text_raster.load_default(size=fontsize)


def get_font(fontsize: int):
    from sdwebui_tpu_torch.utils.options import opts

    return _load_font(opts.get("font") or "", max(int(fontsize), 1))


def _measure(text: str, font) -> tuple:
    left, top, right, bottom = font.getbbox(text)
    return right - left, bottom - top


def _wrap_words(text: str, font, max_width: int) -> list:
    """Greedy word wrap: keep appending words while the line still fits."""
    out = [""]
    for word in text.split():
        candidate = (out[-1] + " " + word).strip()
        if font.getlength(candidate) <= max_width:
            out[-1] = candidate
        else:
            out.append(word)
    return out


def _layout_labels(annotations, font, max_width: int) -> _LabelBlock:
    """Wrap + measure one label's annotation fragments into a _LabelBlock."""
    block = _LabelBlock(max_width=max_width)
    for ann in annotations:
        for piece in _wrap_words(ann.text, font, max_width):
            w, h = _measure(piece, font)
            block.lines.append(_Line(piece, ann.is_active, w, h))
    return block


def _paint_label_block(canvas: np.ndarray, center_x: float, top_y: float, block: _LabelBlock,
                       base_fontsize: int, spacing: int, color_active,
                       color_inactive) -> None:
    """Paint a measured block centred on center_x, flowing down from top_y.
    Each line shrinks its font until it fits the block width; inactive
    lines get a strike-through."""
    y = top_y
    for line in block.lines:
        size = base_fontsize
        font = get_font(size)
        while size > 0 and _measure(line.text, font)[0] > block.max_width:
            size -= 1
            font = get_font(size)
        color = color_active if line.active else color_inactive
        text_raster.draw_text(canvas, (center_x, y + line.h / 2), line.text, font, color,
                              anchor="mm")
        if not line.active:
            mid = y + line.h / 2
            text_raster.draw_hline(canvas, center_x - line.w // 2, center_x + line.w // 2, mid,
                                   color_inactive, width=4)
        y += line.h + spacing


def draw_grid_annotations(im: np.ndarray, width: int, height: int, hor_texts, ver_texts,
                          margin: int = 0) -> np.ndarray:
    """Annotate a (rows·height, cols·width) grid image with column labels
    above and row labels to the left; hor_texts / ver_texts are lists (one
    per column / row) of lists of GridAnnotation."""
    from sdwebui_tpu_torch.utils.options import opts

    color_active = image_color.getcolor_rgb(opts.get("grid_text_active_color", "#000000"))
    color_inactive = image_color.getcolor_rgb(opts.get("grid_text_inactive_color", "#999999"))
    color_background = image_color.getcolor_rgb(opts.get("grid_background_color", "#ffffff"))

    im = np.asarray(im)
    cols = im.shape[1] // width
    rows = im.shape[0] // height
    if cols != len(hor_texts):
        raise AssertionError(f"column label count {len(hor_texts)} != grid columns {cols}")
    if rows != len(ver_texts):
        raise AssertionError(f"row label count {len(ver_texts)} != grid rows {rows}")

    base_fontsize = (width + height) // 25
    spacing = base_fontsize // 2
    font = get_font(base_fontsize)

    # left gutter only when some row label has text; 3/4 of a cell width
    have_row_labels = any(ann.text for label in ver_texts for ann in label)
    gutter_left = width * 3 // 4 if have_row_labels else 0

    col_blocks = [_layout_labels(label, font, width) for label in hor_texts]
    row_blocks = [_layout_labels(label, font, gutter_left) for label in ver_texts]
    col_heights = [b.height(spacing, per_line_spacing=False) for b in col_blocks]
    gutter_top = (max(col_heights) + spacing * 2) if any(col_heights) else 0

    canvas = np.empty((im.shape[0] + gutter_top + margin * (rows - 1),
                       im.shape[1] + gutter_left + margin * (cols - 1), 3), np.uint8)
    canvas[...] = np.asarray(color_background, np.uint8)
    for row in range(rows):
        for col in range(cols):
            cell = im[height * row:height * (row + 1), width * col:width * (col + 1), :3]
            y = gutter_top + (height + margin) * row
            x = gutter_left + (width + margin) * col
            canvas[y:y + height, x:x + width] = cell

    for col, block in enumerate(col_blocks):
        cx = gutter_left + (width + margin) * col + width / 2
        top = gutter_top / 2 - col_heights[col] / 2
        _paint_label_block(canvas, cx, top, block, base_fontsize, spacing, color_active,
                           color_inactive)
    for row, block in enumerate(row_blocks):
        cx = gutter_left / 2
        top = (gutter_top + (height + margin) * row + height / 2
               - block.height(spacing, per_line_spacing=True) / 2)
        _paint_label_block(canvas, cx, top, block, base_fontsize, spacing, color_active,
                           color_inactive)
    return canvas


def draw_prompt_matrix(im: np.ndarray, width: int, height: int, all_prompts,
                       margin: int = 0) -> np.ndarray:
    """The prompt matrix's legend: each cell's active prompt parts in the
    active colour, inactive ones struck through; the variable parts split
    half and half between the column axis (low bits of the cell index) and
    the row axis (high bits)."""
    parts = all_prompts[1:]
    n_cols_bits = math.ceil(len(parts) / 2)
    col_parts, row_parts = parts[:n_cols_bits], parts[n_cols_bits:]

    def axis_labels(axis_parts):
        return [[GridAnnotation(text, is_active=bool(idx >> bit & 1))
                 for bit, text in enumerate(axis_parts)]
                for idx in range(1 << len(axis_parts))]

    return draw_grid_annotations(im, width, height, axis_labels(col_parts),
                                 axis_labels(row_parts), margin)
