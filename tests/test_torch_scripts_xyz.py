"""The X/Y/Z plot in the port against JAX's ``Engine.run_script`` on one
tiny SD1.5 carried across by ``from_jax`` (64², f32, 2-3 steps): field
axes and their range grammar, Prompt S/R, a Size axis of unequal cells, z
grids with their sub-grids, the reference's index convention, the
megapixel guard, and every options axis swept over two values.  Where
JAX's cells leave an axis's value unread (its two cells come out equal)
the port raises naming the axis; every other axis changes JAX's cells and
the port's match them: images within 1 uint8 level, identical
infotexts."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)

import numpy as np
import pytest

from sdwebui_tpu.scripts import builtin as jax_builtin
from sdwebui_tpu.utils.options import opts as jax_opts
from sdwebui_tpu_torch.scripts import builtin
from sdwebui_tpu_torch.server.app import CheckpointNotFound
from sdwebui_tpu_torch.utils.options import opts
from test_torch_img2img import f32_policies, models  # noqa: F401
from torch_scripts_common import as_arrays, make_engines, params, run_both


@pytest.fixture
def engines(models, f32_policies, tmp_path):  # noqa: F811
    return make_engines(models, tmp_path)


def _xyz(x="Nothing", xv="", y="Nothing", yv="", z="Nothing", zv="", legend=False, sub=False):
    return [x, xv, y, yv, z, zv, legend, sub]


def test_axis_tables_equal_jax():
    assert list(builtin.AXIS_OPTIONS) == list(jax_builtin.AXIS_OPTIONS)
    assert builtin.OPTS_AXES == jax_builtin.OPTS_AXES
    assert builtin.REF_AXES_TXT2IMG == jax_builtin.REF_AXES_TXT2IMG
    assert builtin.REF_AXES_IMG2IMG == jax_builtin.REF_AXES_IMG2IMG
    assert set(builtin.UNPORTED_AXES) <= set(builtin.AXIS_OPTIONS) | set(builtin.OPTS_AXES)


@pytest.mark.parametrize("axis,values", [
    ("Seed", "1-3"), ("Seed", "1-10 (+3)"), ("Steps", "10-20 [3]"), ("CFG Scale", "1-2 (+0.5)"),
    ("CFG Scale", "3, 5.5 ,7"), ("Denoising", "0.2-0.6 [3]"), ("Var. strength", "0-1 [5]"),
    ("Sampler", "Euler a, DPM++ 2M"), ("Size", "64x64, 96x64"), ("Nothing", "1-3"),
    ("Steps", ""), ("Seed", ["4", "5"]), ("Seed", "-3--1"), ("Eta noise seed delta", "1-3"),
])
def test_parse_axis_values_matches_jax(axis, values):
    assert builtin.parse_axis_values(axis, values) == jax_builtin.parse_axis_values(axis, values)


@pytest.mark.parametrize("args,n", [
    (_xyz("Seed", "1-2"), 3),
    (_xyz("Steps", "2,3", "CFG Scale", "5,7.5"), 5),
    (_xyz("Prompt S/R", "cat, dog, bird"), 4),
    (_xyz("Prompt order", "blue; fluffy, fluffy; cat"), 3),
    (_xyz("Var. seed", "1-2", "Var. strength", "0, 0.5"), 5),
    # z grids side by side, then each z's own grid
    (_xyz("Seed", "1-2", "Nothing", "", "CFG Scale", "5, 7", sub=True), 7),
    # the reference's index convention: 1 Seed, 6 CFG Scale; a dropdown list
    # wins over the values text
    ([1, "1-2", [], 6, "3,7", [], 0, "", [], False, False, False, False], 5),
    ([1, "1-9", ["4", "5"], 0, "", [], 0, "", [], False, False, False, False], 3),
], ids=["seed", "steps_cfg", "prompt_sr", "prompt_order", "variation", "z_sub_grids",
        "index", "index_dropdown"])
def test_xyz_matches_jax(engines, args, n):
    _, out = run_both(engines, "X/Y/Z plot", args)
    assert len(out.images) == n


def test_xyz_size_axis_centres_unequal_cells(engines):
    """A Size axis gives cells of unequal sizes: each is centred in a cell of
    the largest, the rest grid_background_color."""
    _, out = run_both(engines, "X/Y/Z plot", _xyz("Size", "64x64, 96x64, 64x96"))
    grid = out.images[0]
    assert grid.shape == (96, 288, 3)
    assert (grid[:16, :16] == 255).all() and (grid[:16, 96:192] == 255).all()
    assert (grid[:, 192:192 + 16] == 255).all() and not (grid[16:80, 112:176] == 255).all()
    assert [im.shape for im in out.images[1:]] == [(64, 64, 3), (64, 96, 3), (96, 64, 3)]


def test_xyz_megapixel_guard_matches_jax(engines):
    jax_engine, port_engine = engines
    jp, pp = params(width=512, height=512)
    args = _xyz("Seed", "1-3", "CFG Scale", "5,6,7")
    with jax_opts.override({"img_max_size_mp": 2}), opts.override({"img_max_size_mp": 2}):
        with pytest.raises(ValueError) as ref:
            jax_engine.run_script("X/Y/Z plot", jp, args)
        with pytest.raises(ValueError) as out:
            port_engine.run_script("X/Y/Z plot", pp, args)
    assert str(out.value) == str(ref.value) and "2 MPixels" in str(out.value)


def test_xyz_legend_names_the_font(engines):
    """draw_legend (on by default) answers 200 over the route with JAX's
    legend: the x labels in a top gutter drawn in DejaVuSans as Pillow
    draws it, the whole grid within 1 level of JAX's (its text exactly)."""
    _, out = run_both(engines, "X/Y/Z plot", _xyz("Seed", "1-2", legend=True))
    grid = out.images[0]
    assert grid.shape[1] == 128 and grid.shape[0] > 64
    gutter = grid[:grid.shape[0] - 64]
    assert (gutter != 255).any() and (gutter[:, :, 0] == gutter[:, :, 1]).all()


HIRES = dict(enable_hr=True, hr_scale=1.5, denoising_strength=0.6, hr_upscaler="Latent")

#: every options axis the JAX package's cells read: two values and the
#: request that makes them matter
HONOURED = {
    "Token merging ratio": ("0, 0.5", {}),
    "Token merging ratio high-res": ("0, 0.5", HIRES),
    "RNG source": ("NV, CPU", {}),
    "Eta noise seed delta": ("0, 31337", {}),
    "Schedule min sigma": ("0.03, 0.3", dict(scheduler="Karras")),
    "Schedule max sigma": ("5, 14", dict(scheduler="Karras")),
    "Schedule rho": ("5, 9", dict(scheduler="Karras", steps=3)),
    "UniPC Order": ("1, 2", dict(sampler_name="UniPC", steps=3)),
    "UniPC Variant": ("bh1, bh2", dict(sampler_name="UniPC", steps=3)),
    "Face restore model": ("CodeFormer, GFPGAN", dict(restore_faces=True)),
    "Always discard next-to-last sigma": ("False, True", dict(steps=3)),
    "SGM noise multiplier": ("False, True", {}),
    "Extra noise": ("0, 0.5", dict(img2img=True)),
}

#: the axes JAX's cells leave unread, with a request where the value would
#: matter
IGNORED = {
    "VAE": ("Automatic, None", {}),
    "Beta schedule alpha": ("0.6, 0.9", dict(scheduler="Beta")),
    "Beta schedule beta": ("0.6, 0.9", dict(scheduler="Beta")),
    "Emphasis": ("Original, No norm", dict(prompt="a (cat:1.5), (blue:0.5)")),
    "Cond. Image Mask Weight": ("1.0, 0.5", {}),
    "FP8 mode": ("Disable, Enable", {}),
    "Styles": ("red; blue, none", {}),
}


def test_every_options_axis_is_classified():
    assert set(HONOURED) | set(IGNORED) == set(builtin.OPTS_AXES) - {"Checkpoint name"} \
        | {"Styles"}
    assert set(IGNORED) == set(builtin.UNPORTED_AXES)


@pytest.mark.parametrize("axis", list(HONOURED))
def test_honoured_options_axis_matches_jax(engines, axis):
    values, kw = HONOURED[axis]
    kw = dict(kw)
    ref, out = run_both(engines, "X/Y/Z plot", _xyz(axis, values), img2img=kw.pop("img2img", False),
                        **kw)
    cells = as_arrays(ref.images)[1:]
    assert not np.array_equal(cells[0], cells[1]) or ref.infotexts[1] != ref.infotexts[2]


@pytest.mark.parametrize("axis", list(IGNORED))
def test_ignored_options_axis_raises_naming_it(engines, axis):
    """JAX's two cells are the same image; the port refuses the axis."""
    jax_engine, port_engine = engines
    values, kw = IGNORED[axis]
    jp, pp = params(**kw)
    if axis == "Styles":
        from sdwebui_tpu.text.styles import PromptStyle

        jax_engine.styles.styles["red"] = PromptStyle("red", "{prompt}, red", "")
    ref = jax_engine.run_script("X/Y/Z plot", jp, _xyz(axis, values))
    cells = as_arrays(ref.images)[1:]
    np.testing.assert_array_equal(cells[0], cells[1])
    with pytest.raises(NotImplementedError, match=f"axis {axis!r}"):
        port_engine.run_script("X/Y/Z plot", pp, _xyz(axis, values))


def test_checkpoint_axis(engines):
    """The cell's checkpoint: the served model's own title runs; another name
    raises CheckpointNotFound, which the API answers with 422 (JAX skips a
    name its registry lacks)."""
    jax_engine, port_engine = engines
    title = port_engine.sd_model.title
    run_both(engines, "X/Y/Z plot", _xyz("Checkpoint name", title))
    with pytest.raises(CheckpointNotFound, match="no-such-model"):
        port_engine.run_script("X/Y/Z plot", params()[1], _xyz("Checkpoint name", "no-such-model"))


def test_options_axis_writes_the_requests_dict(engines):
    """As in JAX, the cells share the request's override_settings (a shallow
    copy): the last cell's value stays in the caller's dict."""
    jax_engine, port_engine = engines
    jp, pp = params()
    args = _xyz("Eta noise seed delta", "7, 31337")
    jax_engine.run_script("X/Y/Z plot", jp, args)
    port_engine.run_script("X/Y/Z plot", pp, args)
    assert pp.override_settings == jp.override_settings
    assert pp.override_settings["eta_noise_seed_delta"] == 31337
