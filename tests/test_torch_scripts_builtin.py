"""The built-in scripts other than the X/Y/Z plot in the port against JAX's
``Engine.run_script``, on one tiny SD1.5 carried across by ``from_jax``
(64², f32, 2-4 steps): prompts from file with the seed iterated, loopback
over its three curves, SD upscale in batches of tiles at a size that is
not a multiple of the tile, both outpaintings, img2img alternative (its
inverted noise held first), custom code behind its flag, and the main
UI's ``postprocessing`` field.  Images within 1 uint8 level, identical
infotexts."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)

import numpy as np
import pytest
from PIL import Image

from sdwebui_tpu.pipeline import processing as jax_proc
from sdwebui_tpu.server import cmd_flags
from sdwebui_tpu_torch.pipeline import processing as port_proc
from test_torch_img2img import f32_policies, models  # noqa: F401
from torch_scripts_common import (as_arrays, assert_same, make_engines, params, run_both,
                                  run_route)

#: max |Δ| of img2img alternative's inverted noise (unit std, f32) against
#: JAX's jitted scan (its eager loop agrees with the scan to 2e-5 here, so
#: the scan is the reference; ROADMAP C)
INVERT_TOL = 1e-4


@pytest.fixture
def engines(models, f32_policies, tmp_path):  # noqa: F811
    return make_engines(models, tmp_path)


def test_prompts_from_file_iterates_the_seed(engines):
    jax_engine, port_engine = engines
    ref, out = run_both(engines, "Prompts from file or textbox",
                        [True, False, "a cat\n\n  a dog on a hill  \n"])
    assert len(out.images) == 2
    assert "Seed: 3," in out.infotexts[0] and "Seed: 4," in out.infotexts[1]
    assert out.all_prompts == ["a cat", "a dog on a hill"]


def test_prompts_from_file_keeps_the_seed(engines):
    _, out = run_both(engines, "Prompts from file or textbox", [False, False, "a cat\na dog"])
    assert all("Seed: 3," in text for text in out.infotexts)


@pytest.mark.parametrize("curve", ["Linear", "Aggressive", "Lazy"])
def test_loopback_matches_jax(engines, curve):
    """Three loops from 0.6 to 0.4 along the curve: the strengths (in the
    infotexts) equal JAX's and the first loop's image is within 1 level of
    JAX's.  Each later loop starts from the loop before's image, so a 1-level
    difference there feeds the next loop (on this random tiny model, up to 7
    levels by the third): each later loop is held as one step of the chain
    instead, the port's img2img of JAX's previous image within 1 level of
    JAX's image, and the port's own chain exactly its img2img of its previous
    image."""
    jax_engine, port_engine = engines
    ref = jax_engine.run_script("Loopback", params(True)[0], [3, 0.4, curve])
    out = run_route(port_engine, "Loopback", [3, 0.4, curve], img2img=True)
    ref_imgs = as_arrays(ref.images)
    assert len(out.images) == len(ref_imgs) == 3 and out.infotexts == ref.infotexts
    assert np.abs(out.images[0].astype(int) - ref_imgs[0].astype(int)).max() <= 1
    for i in (1, 2):
        ratio = (i + 1) / 3
        ratio = {"Aggressive": np.sin(ratio * np.pi / 2),
                 "Lazy": 1 - np.cos(ratio * np.pi / 2)}.get(curve, ratio)
        strength = 0.6 + (0.4 - 0.6) * ratio
        assert f"Denoising strength: {strength}," in out.infotexts[i]
        own = port_engine.img2img_inner(params(True, init=out.images[i - 1],
                                               denoising_strength=strength)[1])
        np.testing.assert_array_equal(own.images[0], out.images[i])
        step = port_engine.img2img_inner(params(True, init=ref_imgs[i - 1],
                                                denoising_strength=strength)[1])
        assert np.abs(step.images[0].astype(int) - ref_imgs[i].astype(int)).max() <= 1


def test_sd_upscale_batched_tiles_match_jax(engines):
    """64² ×1.4 → 90², split into 48² tiles at overlap 16 (9 tiles, 3
    batches of at most 4): 90 is no multiple of the tile's 32-pixel stride,
    so the edge tiles overlap their neighbours more and the combine crops."""
    from sdwebui_tpu.utils import images as jax_images
    from sdwebui_tpu_torch.utils import images as port_images

    _, out = run_both(engines, "SD upscale", [16, "Lanczos", 1.4], img2img=True,
                      batch_size=4, width=48, height=48, denoising_strength=0.4)
    assert out.images[0].shape == (90, 90, 3)
    # the combine alone, on tiles that differ, against JAX's
    rng = np.random.default_rng(4)
    big = rng.integers(0, 256, (90, 90, 3), dtype=np.uint8)
    jgrid = jax_images.split_grid(Image.fromarray(big), 48, 48, 16)
    pgrid = port_images.split_grid(big, 48, 48, 16)
    for jrow, prow in zip(jgrid.tiles, pgrid.tiles):
        for jt, pt in zip(jrow[2], prow[2]):
            tile = rng.integers(0, 256, (48, 48, 3), dtype=np.uint8)
            jt[2], pt[2] = Image.fromarray(tile), tile
    np.testing.assert_array_equal(port_images.combine_grid(pgrid),
                                  np.asarray(jax_images.combine_grid(jgrid)))


@pytest.mark.parametrize("fill", [0, 1])
def test_poor_mans_outpainting_matches_jax(engines, fill):
    _, out = run_both(engines, "Poor man's outpainting", [16, 4, fill, "left, right"],
                      img2img=True)
    assert out.images[0].shape == (64, 96, 3)


def test_outpainting_mk2_matches_jax(engines):
    _, out = run_both(engines, "Outpainting mk2", [16, 4, "left, right", 0.7, 0.2],
                      img2img=True)
    assert out.images[0].shape == (64, 96, 3)


def test_img2img_alternative_matches_jax(engines):
    """The image over the route; the inverted noise the script leaves in
    the request (unit std, within INVERT_TOL of JAX's)."""
    jax_engine, port_engine = engines
    args = ["a cat", "ugly", True, 4, 1.5]
    jp, pp = params(True, prompt="a dog, blue")
    ref = jax_engine.run_script("img2img alternative test", jp, list(args))
    assert_same(ref, run_route(port_engine, "img2img alternative test", args, img2img=True,
                               prompt="a dog, blue"))
    port_engine.run_script("img2img alternative test", pp, list(args))
    noise = pp.init_noise_override.numpy()
    ref_noise = np.asarray(jp.init_noise_override).transpose(0, 3, 1, 2)
    assert abs(noise.std() - 1.0) < 1e-5
    assert np.abs(noise - ref_noise).max() <= INVERT_TOL
    # the request is set in place, as JAX sets it
    assert (pp.steps, pp.cfg_scale, pp.sampler_name, pp.denoising_strength) == \
        (jp.steps, jp.cfg_scale, jp.sampler_name, jp.denoising_strength) == (4, 1.5, "Euler", 1.0)


@pytest.mark.parametrize("prediction", ["eps", "v"])
def test_invert_noise_matches_jax(models, f32_policies, prediction):  # noqa: F811
    """invert_noise alone over a CFG schedule, ε and v prediction: unit std,
    within INVERT_TOL of JAX's jitted scan."""
    import dataclasses

    import jax.numpy as jnp
    import torch

    from sdwebui_tpu.sampling.discretization import Discretization as JaxDisc
    from sdwebui_tpu.sampling.schedulers import get_schedule
    from sdwebui_tpu_torch.sampling.discretization import Discretization

    jm, pm = models
    jm = dataclasses.replace(jm, disc=JaxDisc(jm.disc.alphas_cumprod, prediction_type=prediction))
    pm = dataclasses.replace(pm, disc=Discretization(pm.disc.alphas_cumprod,
                                                     prediction_type=prediction))
    jp, pp = params(prompt="a (cat:1.2) AND a dog :0.5", cfg_scale=3.0)
    jp.all_prompts, jp.all_negative_prompts = [jp.prompt], [jp.negative_prompt]
    pp.all_prompts, pp.all_negative_prompts = [pp.prompt], [pp.negative_prompt]
    steps = 2
    sigmas = get_schedule("Automatic", steps, jm.disc)[::-1].copy()
    latent = np.random.default_rng(8).standard_normal((1, 4, 8, 8)).astype(np.float32)
    ref = np.asarray(jax_proc.invert_noise(
        jm, jax_proc._build_conds(jm, jp, steps + 1), jnp.asarray(latent.transpose(0, 2, 3, 1)),
        sigmas)).transpose(0, 3, 1, 2)
    out = port_proc.invert_noise(pm, port_proc._build_conds(pm, pp, steps + 1),
                                 torch.from_numpy(latent), sigmas).numpy()
    assert abs(out.std() - 1.0) < 1e-5
    assert np.abs(out - ref).max() <= INVERT_TOL


def test_custom_code_is_gated_then_runs(models, f32_policies, tmp_path):  # noqa: F811
    """Without the flag both refuse; with it, display() and a plain cell
    match JAX's."""
    jax_engine, port_engine = make_engines(models, tmp_path)
    code = ("import numpy as np\n"
            "img = np.zeros((8, 8, 3), np.uint8) + np.uint8(p.seed)\n"
            "display([img], s=p.seed, i='custom')\n")
    cmd_flags.cmd_opts = type(cmd_flags.cmd_opts)()
    jp, pp = params()
    with pytest.raises(RuntimeError, match="allow-code"):
        jax_engine.run_script("Custom code", jp, [code])
    with pytest.raises(PermissionError, match="allow-code"):
        port_engine.run_script("Custom code", pp, [code])
    port_engine.allow_code = True
    cmd_flags.cmd_opts.allow_code = True
    try:
        jax_code = code.replace("display([img]", "from PIL import Image\n"
                                "display([Image.fromarray(img)]")
        ref = jax_engine.run_script("Custom code", params()[0], [jax_code])
        out = run_route(port_engine, "Custom code", [code])
        assert_same(ref, out)
        assert out.infotexts == ["custom"] and out.images[0][0, 0, 0] == 3
        # no display(): the request runs as a cell
        run_both((jax_engine, port_engine), "Custom code", ["x = 1"])
    finally:
        cmd_flags.cmd_opts = type(cmd_flags.cmd_opts)()


POSTPROCESSING = {"enable": ["Upscale"], "upscaler_1": "Lanczos", "upscaling_resize": 1.5}


@pytest.mark.parametrize("img2img", [False, True], ids=["txt2img", "img2img"])
def test_postprocessing_field_matches_jax(engines, img2img):
    """The main UI's postprocessing runs Extras' stages on each image before
    the infotext is written ("Postprocessing: Upscale")."""
    jax_engine, port_engine = engines
    jp, pp = params(img2img, postprocessing=POSTPROCESSING)
    ref = (jax_engine.img2img if img2img else jax_engine.txt2img)(jp)
    out = (port_engine.img2img if img2img else port_engine.txt2img)(pp)
    imgs = assert_same(ref, out)
    assert imgs[0].shape == (96, 96, 3)
    assert "Postprocessing: Upscale" in out.infotexts[0]


def test_script_outputs_are_numpy_images(engines):
    """A script hands the API uint8 HWC arrays (the PNG encoder's input),
    the prompt matrix's legend-drawn grid among them (its pixels are held
    to JAX's in ``tests/test_torch_grid_annotations.py``)."""
    out = engines[1].run_script("Loopback", params(True)[1], [1, 0.5, "Linear"])
    assert all(isinstance(im, np.ndarray) and im.dtype == np.uint8 and im.shape == (64, 64, 3)
               for im in out.images)
    out = engines[1].run_script("Prompt matrix", params(prompt="a cat | red")[1], [False])
    assert all(isinstance(im, np.ndarray) and im.dtype == np.uint8 for im in out.images)
    assert [im.shape for im in out.images[1:]] == [(64, 64, 3)] * 2
    assert out.images[0].shape[0] > 64 and out.images[0].shape[1] == 128
