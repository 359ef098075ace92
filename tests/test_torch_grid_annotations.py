"""Grid legends, the prompt matrix's legend and the embedding card in the
port (``utils/grid_annotations.py``, ``training/textual_inversion.py``)
against the JAX package's, which draws with Pillow; and Pillow's colour
grammar (``utils/image_color.py``) through ``image_grid``, ``flatten`` and
the legend.

Every canvas must have JAX's size and every label line JAX's wrap and box;
over each painted line's box the port's pixels are held to mean |Δ| <= 2
levels with at most 1% of them off by more than 16 (measured: 0 levels
everywhere, PERF.md).  Cells: X/Y/Z legends at 256², 512² and 768×512,
with labels that wrap and labels that force the shrink loop; the prompt
matrix with struck-through parts at 512², 768×512 and 256²; the ``font``
option naming DejaVuSans and a missing file.  Inputs come from numpy seeds.
"""

import torch_threads  # noqa: F401  (one thread share per xdist worker)

import os

import numpy as np
import pytest
from PIL import Image

from sdwebui_tpu.training import textual_inversion as jax_ti
from sdwebui_tpu.utils import grid_annotations as jax_ga
from sdwebui_tpu.utils import images as jax_images
from sdwebui_tpu.utils.options import opts as jax_opts
from sdwebui_tpu_torch.pipeline import processing as port_proc
from sdwebui_tpu_torch.training import textual_inversion as port_ti
from sdwebui_tpu_torch.utils import grid_annotations as port_ga
from sdwebui_tpu_torch.utils import image_color
from sdwebui_tpu_torch.utils import images as port_images
from sdwebui_tpu_torch.utils.options import opts

SYSTEM_DEJAVU = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"
MEAN_TOL, SHARE_TOL, OFF_LEVELS = 2.0, 0.01, 16


@pytest.fixture(autouse=True)
def _options():
    keys = ("font", "grid_text_active_color", "grid_text_inactive_color",
            "grid_background_color")
    saved = [{k: o.data.get(k) for k in keys} for o in (jax_opts, opts)]
    yield
    for o, old in zip((jax_opts, opts), saved):
        for k, v in old.items():
            if v is None:
                o.data.pop(k, None)
            else:
                o.data[k] = v
    jax_ga._load_font.cache_clear()
    port_ga._load_font.cache_clear()


def _set(**kw):
    for o in (jax_opts, opts):
        o.data.update(kw)


def _grid(cols, rows, w, h, seed=0):
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 256, (rows, cols, 1, 1, 3), dtype=np.uint8)
    img = np.broadcast_to(cells, (rows, cols, h, w, 3)).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(img.reshape(rows * h, cols * w, 3))


def _ann(cls, labels):
    return [[cls(text, active) for text, active in label] for label in labels]


def _line_boxes(hor, ver, width, height):
    """The painted box of every label line, as the paint pass places it."""
    base = (width + height) // 25
    spacing = base // 2
    font = port_ga.get_font(base)
    gutter_left = width * 3 // 4 if any(a.text for label in ver for a in label) else 0
    cols = [port_ga._layout_labels(label, font, width) for label in hor]
    rows = [port_ga._layout_labels(label, font, gutter_left) for label in ver]
    heights = [b.height(spacing, False) for b in cols]
    gutter_top = max(heights) + spacing * 2 if any(heights) else 0
    boxes = []

    def walk(cx, top, block):
        y = top
        for line in block.lines:
            boxes.append((line.text, int(cx - line.w / 2) - 1, int(y) - 1,
                          int(cx + line.w / 2) + 2, int(y + line.h) + 2))
            y += line.h + spacing

    for c, block in enumerate(cols):
        walk(gutter_left + width * c + width / 2, gutter_top / 2 - heights[c] / 2, block)
    for r, block in enumerate(rows):
        walk(gutter_left / 2, gutter_top + height * r + height / 2
             - block.height(spacing, True) / 2, block)
    return boxes, [(ln.text, ln.w, ln.h) for b in cols + rows for ln in b.lines]


def _compare(ref_pil, out, hor, ver, width, height):
    ref = np.asarray(ref_pil.convert("RGB"))
    assert out.shape == ref.shape and out.dtype == np.uint8
    boxes, lines = _line_boxes(hor, ver, width, height)
    jax_font = jax_ga.get_font((width + height) // 25)
    from PIL import ImageDraw

    scratch = ImageDraw.Draw(Image.new("RGB", (1, 1)))
    jax_lines = []
    for label in hor + ver:
        limit = width if label in hor else (width * 3 // 4)
        for ann in label:
            for piece in jax_ga._wrap_words(scratch, ann.text, jax_font, limit):
                jax_lines.append((piece,) + jax_ga._measure(scratch, piece, jax_font))
    assert lines == jax_lines
    worst = 0.0
    for _, x0, y0, x1, y1 in boxes:
        d = np.abs(out[max(y0, 0):y1, max(x0, 0):x1].astype(int)
                   - ref[max(y0, 0):y1, max(x0, 0):x1].astype(int)).max(-1)
        if d.size:
            assert d.mean() <= MEAN_TOL and (d > OFF_LEVELS).mean() <= SHARE_TOL
            worst = max(worst, float(d.max()))
    return worst, np.abs(out.astype(int) - ref.astype(int)).max()


XYZ_CASES = {
    "seed_cfg_256": (256, 256, ["Seed: 1", "Seed: 2", "Seed: 3"],
                     ["CFG Scale: 5", "CFG Scale: 7.5"]),
    "wrapping_512": (512, 512, ["Prompt S/R: a photograph of an astronaut riding a horse",
                                "Prompt S/R: a watercolour of a fox in the snow at dusk"],
                     ["Sampler: DPM++ 2M Karras", "Sampler: Euler a"]),
    "shrink_768x512": (768, 512, ["Checkpoint name: sd_xl_base_1.0_0.9vae_refiner_pruned_fp16",
                                  "Nothing"], ["Steps: 20"]),
    "x_only_256": (256, 256, ["Hires steps: 10", "Hires steps: 20"], [""]),
}


@pytest.mark.parametrize("case", list(XYZ_CASES))
def test_xyz_legend_matches_jax(case):
    w, h, xs, ys = XYZ_CASES[case]
    labels_x = [[(t, True)] for t in xs]
    labels_y = [[(t, True)] for t in ys]
    img = _grid(len(xs), len(ys), w, h, seed=len(case))
    ref = jax_ga.draw_grid_annotations(Image.fromarray(img), w, h,
                                       _ann(jax_ga.GridAnnotation, labels_x),
                                       _ann(jax_ga.GridAnnotation, labels_y))
    hor, ver = _ann(port_ga.GridAnnotation, labels_x), _ann(port_ga.GridAnnotation, labels_y)
    out = port_ga.draw_grid_annotations(img, w, h, hor, ver)
    _compare(ref, out, hor, ver, w, h)


def test_z_titles_match_jax():
    """The z grid: titles above, one empty row label (builtin.py:415-421)."""
    img = _grid(2, 1, 128, 192, seed=5)
    titles = [[("CFG Scale: 5", True)], [("CFG Scale: 7", True)]]
    ref = jax_ga.draw_grid_annotations(Image.fromarray(img), 128, 192,
                                       _ann(jax_ga.GridAnnotation, titles),
                                       [[jax_ga.GridAnnotation()]])
    hor = _ann(port_ga.GridAnnotation, titles)
    out = port_ga.draw_grid_annotations(img, 128, 192, hor, [[port_ga.GridAnnotation()]])
    _compare(ref, out, hor, [[port_ga.GridAnnotation()]], 128, 192)


@pytest.mark.parametrize("w,h", [(512, 512), (768, 512), (256, 256)])
def test_prompt_matrix_matches_jax(w, h):
    """Three variable parts: 8 cells, 2 column bits and 1 row bit, the
    inactive parts struck through in grid_text_inactive_color."""
    prompts = ["a castle", "at night", "oil painting, by a famous artist", "snow"]
    img = _grid(4, 2, w, h, seed=w)
    ref = jax_ga.draw_prompt_matrix(Image.fromarray(img), w, h, prompts)
    out = port_ga.draw_prompt_matrix(img, w, h, prompts)
    parts = prompts[1:]

    def axis(ps):
        return [[port_ga.GridAnnotation(t, bool(i >> b & 1)) for b, t in enumerate(ps)]
                for i in range(1 << len(ps))]

    _compare(ref, out, axis(parts[:2]), axis(parts[2:]), w, h)
    assert (out == (153, 153, 153)).all(-1).sum() > 0         # the strike lines


def test_font_option_names_dejavu_or_a_missing_file(tmp_path):
    """font = the DejaVuSans file draws as with no option; a file that
    cannot be opened falls back, in JAX, to Pillow's default font at the
    legend's size, which FreeType auto-hints: the port raises naming it."""
    labels = [[("Seed: 1", True)], [("Seed: 2", True)]]
    img = _grid(2, 1, 256, 256, seed=9)
    _set(font=SYSTEM_DEJAVU)
    ref = jax_ga.draw_grid_annotations(Image.fromarray(img), 256, 256,
                                       _ann(jax_ga.GridAnnotation, labels), [[]])
    hor = _ann(port_ga.GridAnnotation, labels)
    out = port_ga.draw_grid_annotations(img, 256, 256, hor, [[]])
    _compare(ref, out, hor, [[]], 256, 256)
    _set(font=str(tmp_path / "missing.ttf"))
    jax_ga.draw_grid_annotations(Image.fromarray(img), 256, 256,
                                 _ann(jax_ga.GridAnnotation, labels), [[]])
    with pytest.raises(NotImplementedError, match="auto-hinter"):
        port_ga.draw_grid_annotations(img, 256, 256, hor, [[]])


def test_embedding_card_matches_jax(tmp_path):
    """The card JAX writes beside a trained embedding: its name at (24, 230)
    and "step N" at (24, 260) in Pillow's default font, and the data
    panels; the port's card equals it."""
    import jax.numpy as jnp

    vec = np.random.default_rng(3).standard_normal((2, 32)).astype(np.float32)
    for name, step in (("my-embedding", 500), ("chipemb ünï", 7)):
        path = str(tmp_path / f"{step}.safetensors")
        jax_ti._save_embedding(name, jnp.asarray(vec), step, path)
        ref = np.asarray(Image.open(os.path.splitext(path)[0] + ".png").convert("RGB"))
        out = port_ti.card_image(name, vec, step)
        assert out.shape == ref.shape
        left = (out.shape[1] - 512) // 2
        text = np.abs(out[220:275, left:left + 512].astype(int)
                      - ref[220:275, left:left + 512].astype(int)).max(-1)
        assert text.mean() <= MEAN_TOL and (text > OFF_LEVELS).mean() <= SHARE_TOL
        assert (out[228:242, left + 24:left + 100] != (32, 38, 48)).any()
        np.testing.assert_array_equal(out, ref)


COLOURS = ["#f00", "red", "RED", "rgb(0,128,255)", "rgb(10%, 50%, 100%)", "#12345", "#ffffff",
           "#00ff0080", "#abcd", "hsl(120, 50%, 50%)", "hsv(300,20%,90%)", "hsb(30,100%,100%)",
           "rgba(1,2,3,4)", "lightgoldenrodyellow", "grey", "nope", ""]


@pytest.mark.parametrize("colour", COLOURS)
def test_colours_through_grid_flatten_and_legend_match_jax(colour):
    """grid_background_color through image_grid (JAX falls back to white on
    an invalid one), img2img_background_color through flatten (an invalid
    one raises ValueError in both), and the legend's three colours."""
    rng = np.random.default_rng(len(colour))
    imgs = [rng.integers(0, 256, (24, 16 + 8 * i, 3), dtype=np.uint8) for i in range(3)]
    _set(grid_background_color=colour)
    ref = np.asarray(jax_images.image_grid([Image.fromarray(i) for i in imgs], rows=1))
    np.testing.assert_array_equal(port_proc.image_grid(imgs, rows=1), ref)
    rgba = rng.integers(0, 256, (9, 7, 4), dtype=np.uint8)
    try:
        want = np.asarray(jax_images.flatten(Image.fromarray(rgba), colour))
    except ValueError:
        with pytest.raises(ValueError):
            port_images.flatten(rgba, colour)
    else:
        np.testing.assert_array_equal(port_images.flatten(rgba, colour), want)
    try:
        expect = image_color.getcolor_rgb(colour)
    except ValueError:
        expect = None
    _set(grid_background_color="#ffffff", grid_text_active_color=colour,
         grid_text_inactive_color=colour)
    img = _grid(2, 1, 128, 128, seed=2)
    labels = [[("a cat", True)], [("a dog", False)]]
    if expect is None:
        with pytest.raises(ValueError):
            jax_ga.draw_grid_annotations(Image.fromarray(img), 128, 128,
                                         _ann(jax_ga.GridAnnotation, labels), [[]])
        with pytest.raises(ValueError):
            port_ga.draw_grid_annotations(img, 128, 128,
                                          _ann(port_ga.GridAnnotation, labels), [[]])
        return
    ref = jax_ga.draw_grid_annotations(Image.fromarray(img), 128, 128,
                                       _ann(jax_ga.GridAnnotation, labels), [[]])
    hor = _ann(port_ga.GridAnnotation, labels)
    out = port_ga.draw_grid_annotations(img, 128, 128, hor, [[]])
    _compare(ref, out, hor, [[]], 128, 128)
