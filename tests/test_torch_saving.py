"""Saving in the port against the JAX package: file names, files, copies.

``utils/filename.FilenameGenerator`` against JAX's on every token;
``utils/saving.save_image`` against JAX's ``save_image`` (directories,
numbering, the replace action, forced names, suffixes, the name cut, the
callbacks, ``export_for_4chan``, ``save_txt``, JPEG) on the same pixels:
the same names and, PNG or JPEG, the same pixels and text (JPEG: the same
bytes).  Then ``process_txt2img`` / ``process_img2img`` on the tiny SD1.5
pair of test_torch_img2img with an outdir: the samples, the grid and the
before-highres-fix, before-color-correction, mask and init-image copies
under JAX's names, their pixels within 1 level of JAX's and their text
equal.  ``samples_format`` jpg: the port writes the format (the JAX
package's sample save passes none and writes PNG); its file is Pillow's
encoding of the port's image.
"""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)
import datetime as real_datetime
import io
import os

import numpy as np
import pytest
from PIL import Image

from sdwebui_tpu.loader import load as jax_load
from sdwebui_tpu.pipeline import img2img as jax_i2i
from sdwebui_tpu.pipeline import processing as jax_proc
from sdwebui_tpu.pipeline.params import GenerationParams as JaxParams
from sdwebui_tpu.scripts import framework as jax_framework
from sdwebui_tpu.utils import exif as jax_exif
from sdwebui_tpu.utils import filename as jax_filename
from sdwebui_tpu.utils import images as jax_images
from sdwebui_tpu.utils.options import opts as jax_opts
from sdwebui_tpu_torch.pipeline import img2img as port_i2i
from sdwebui_tpu_torch.pipeline import processing as port_proc
from sdwebui_tpu_torch.pipeline.params import GenerationParams
from sdwebui_tpu_torch.scripts import framework
from sdwebui_tpu_torch.utils import filename, saving
from sdwebui_tpu_torch.utils.jpeg import decode_jpeg
from sdwebui_tpu_torch.utils.options import opts
from sdwebui_tpu_torch.utils.png import decode_png
from test_torch_img2img import _init_image, _rect_mask, f32_policies, models  # noqa: F401


class _FixedDatetime(real_datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2024, 5, 6, 7, 8, 9, tzinfo=tz)


class _FixedModule:
    datetime = _FixedDatetime


@pytest.fixture
def fixed_clock(monkeypatch):
    """Both packages' [date] / [datetime] tokens read one fixed instant."""
    monkeypatch.setattr(jax_filename, "datetime", _FixedModule)
    monkeypatch.setattr(filename, "datetime", _FixedModule)


@pytest.fixture
def both(tmp_path):
    """Options set in both packages at once: ``both(**opts)`` (undone after)."""
    stack = []

    def set_(**kw):
        for o in (opts, jax_opts):
            cm = o.override(kw)
            cm.__enter__()
            stack.append(cm)
    yield set_
    for cm in reversed(stack):
        cm.__exit__(None, None, None)


def _flush():
    jax_images.flush_saves()
    saving.flush_saves()


def _params(mod, **kw):
    base = dict(prompt="a (red) cat, on a hill: [x]", negative_prompt="dog", seed=1234,
                steps=20, cfg_scale=7.5, width=64, height=48, batch_size=2, n_iter=1,
                sampler_name="DPM++ 2M", scheduler="Karras", styles=["plain", "None"],
                denoising_strength=0.6)
    base.update(kw)
    p = mod(**base)
    p.all_seeds, p.all_prompts = [1234, 1235], [base["prompt"]] * 2
    p.batch_index, p.iteration, p.user = 1, 0, "someone"
    p.sd_model_name, p.sd_model_hash = "tiny-model [abcdef0123]", "abcdef0123"
    p.job_timestamp = "20240506070809"
    p.sd_vae_file = "/models/VAE/.vae.pt"
    return p


TOKEN_PATTERNS = sorted(f"[{t}]" for t in jax_filename._TOKENS) + [
    "[prompt_hash<4>]", "[negative_prompt_hash<12>]", "[full_prompt_hash<>]",
    "[image_hash<6>]", "[datetime<%Y-%m-%d %H><UTC>]", "[datetime<%Q>]",
    "[hasprompt<cat|kitten><dog|none><bird>]", "pre-[seed_last]-post", "[nonsense] x",
    "[seed]-[prompt_spaces]", "[steps]x[cfg]_[width]x[height]_[batch_number]",
]


@pytest.mark.parametrize("batch_size", [1, 2])
@pytest.mark.parametrize("pattern", TOKEN_PATTERNS)
def test_filename_tokens_equal_jax(pattern, batch_size, fixed_clock, monkeypatch):
    monkeypatch.setattr(jax_load, "loaded_vae_file", "/models/VAE/.vae.pt")
    img = np.random.default_rng(3).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    jp, pp = _params(JaxParams, batch_size=batch_size), _params(GenerationParams,
                                                               batch_size=batch_size)
    ours = filename.FilenameGenerator(pp, 1234, pp.prompt, saving.PixelView(img))
    theirs = jax_filename.FilenameGenerator(jp, 1234, jp.prompt, Image.fromarray(img))
    assert ours.apply(pattern) == theirs.apply(pattern)
    ours.zip = theirs.zip = True
    assert ours.apply(pattern) == theirs.apply(pattern)


def test_next_sequence_number_equals_jax(tmp_path):
    for name in ("00003-1-a.png", "00010-x.jpg", "grid-0004.png", "grid-x.png", "abc.png",
                 "00002"):
        (tmp_path / name).write_bytes(b"")
    for basename in ("", "grid", "abc"):
        assert filename.get_next_sequence_number(str(tmp_path), basename) == \
            jax_filename.get_next_sequence_number(str(tmp_path), basename)


def _save_both(tmp_path, img, reps=1, **kw):
    """save_image in both packages into tmp/jax and tmp/port (as PIL and as
    numpy pixels); returns (port names, JAX names) relative to each root."""
    out = {}
    for which, fn, image in (("jax", jax_images.save_image, Image.fromarray(img)),
                             ("port", saving.save_image, img)):
        root = tmp_path / which
        names = []
        for _ in range(reps):
            full = fn(image, str(root), **kw)
            names.append(os.path.relpath(full, root))
        out[which] = names
    _flush()
    return out["port"], out["jax"]


def _assert_files_equal(tmp_path, names):
    for name in names:
        ours, theirs = tmp_path / "port" / name, tmp_path / "jax" / name
        if name.endswith(".png"):
            img, text = decode_png(ours.read_bytes())
            with Image.open(theirs) as ref:
                np.testing.assert_array_equal(img[:, :, 0] if ref.mode == "L" else img,
                                              np.asarray(ref))
                assert text == {k: v for k, v in ref.info.items() if isinstance(v, str)}
        else:
            assert ours.read_bytes() == theirs.read_bytes(), name


SAVE_CASES = {
    "default": (dict(), dict(seed=5, prompt="a cat", info="a cat\nSteps: 3")),
    "no_dirs": (dict(save_to_dirs=False), dict(seed=5, prompt="a cat", info="x")),
    "dir_pattern": (dict(directories_filename_pattern="[prompt_words]/[seed]",
                         directories_max_prompt_words=2),
                    dict(seed=5, prompt="one, two three", info="x")),
    "pattern": (dict(save_to_dirs=False, samples_filename_pattern="[seed]_[prompt_hash<6>]"),
                dict(seed=7, prompt="hash me", info="t")),
    "no_number_replace": (dict(save_to_dirs=False, save_images_add_number=False),
                          dict(seed=7, prompt="same", info="t")),
    "no_number_suffix": (dict(save_to_dirs=False, save_images_add_number=False,
                              save_images_replace_action="Add number suffix"),
                         dict(seed=7, prompt="same", info="t")),
    "grid": (dict(grid_save_to_dirs=False), dict(basename="grid", seed=9, prompt="g",
                                                info="g", short_filename=True, grid=True)),
    "forced_suffix": (dict(), dict(forced_filename="abc", suffix="-x", info=None)),
    "before_copy": (dict(save_to_dirs=False), dict(seed=3, prompt="p", info="i",
                                                  suffix="-before-highres-fix")),
    "long_prompt": (dict(save_to_dirs=False), dict(seed=3, prompt="word " * 120, info="i")),
    "extras": (dict(), dict(info="Postprocess upscale by: 2.0", short_filename=True,
                            no_prompt=True, pnginfo_section_name="extras")),
    "existing_info": (dict(save_to_dirs=False), dict(seed=1, prompt="p", info="i",
                                                     existing_info={"other": "o"})),
    "jpg": (dict(save_to_dirs=False, jpeg_quality=90),
            dict(seed=1, prompt="p", info="猫 prompt\nSteps: 2", extension="jpg")),
    "jpg_no_pnginfo": (dict(save_to_dirs=False, enable_pnginfo=False),
                       dict(seed=1, prompt="p", info="i", extension="jpg")),
    "txt_sidecar": (dict(save_to_dirs=False, save_txt=True), dict(seed=1, prompt="p",
                                                                  info="line\nSteps: 1")),
    "4chan_threshold": (dict(save_to_dirs=False, img_downscale_threshold=1e-6),
                        dict(seed=1, prompt="p", info="i")),
    "4chan_oversize": (dict(save_to_dirs=False, target_side_length=40),
                       dict(seed=1, prompt="p", info="i")),
    "sync": (dict(save_to_dirs=False, sdtpu_async_save=False, sdtpu_png_compress_level=6),
             dict(seed=1, prompt="p", info="i")),
    "jp2": (dict(save_to_dirs=False), dict(seed=1, prompt="p", info="i", extension="jp2")),
}


@pytest.mark.parametrize("case", list(SAVE_CASES))
def test_save_image_equals_jax(case, tmp_path, both, fixed_clock):
    settings, kw = SAVE_CASES[case]
    both(**settings)
    img = np.random.default_rng(4).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    ours, theirs = _save_both(tmp_path, img, reps=3, **kw)
    assert ours == theirs
    files = sorted(os.path.relpath(os.path.join(r, f), tmp_path / "port")
                   for r, _, fs in os.walk(tmp_path / "port") for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(r, f), tmp_path / "jax")
                           for r, _, fs in os.walk(tmp_path / "jax") for f in fs)
    _assert_files_equal(tmp_path, files)
    if case.startswith("4chan"):
        assert any(f.endswith(".jpg") for f in files)
    if case == "txt_sidecar":
        assert sum(f.endswith(".txt") for f in files) == 3


def test_grey_and_rgba_images_save_as_jax(tmp_path, both):
    both(save_to_dirs=False)
    rng = np.random.default_rng(5)
    grey = rng.integers(0, 256, (40, 24), dtype=np.uint8)
    rgba = rng.integers(0, 256, (40, 24, 4), dtype=np.uint8)
    names = []
    for img, ext in ((grey, "png"), (grey, "jpg"), (rgba, "png"), (rgba, "jpg")):
        ours, theirs = _save_both(tmp_path, img, seed=1, prompt="p", info="i", extension=ext)
        assert ours == theirs
        names += ours
    _assert_files_equal(tmp_path, names)


def test_callbacks_rename_and_see_the_save(tmp_path, both):
    """before_image_saved may rename the file; image_saved sees the params."""
    both(save_to_dirs=False)
    seen = {"jax": [], "port": []}

    def rename(which):
        def fn(params):
            params.filename = os.path.join(os.path.dirname(params.filename), "renamed.png")
            params.pnginfo["added"] = "yes"
        return fn

    hooks = [(jax_framework, "before_image_saved", rename("jax")),
             (framework, "before_image_saved", rename("port")),
             (jax_framework, "image_saved", lambda prm: seen["jax"].append(prm.filename)),
             (framework, "image_saved", lambda prm: seen["port"].append(prm.filename))]
    for mod, channel, fn in hooks:
        mod.on(channel, fn)
    try:
        img = np.random.default_rng(6).integers(0, 256, (16, 16, 3), dtype=np.uint8)
        ours, theirs = _save_both(tmp_path, img, seed=1, prompt="p", info="i")
    finally:
        for mod, channel, fn in hooks:
            mod._callbacks[channel].remove(fn)
    assert ours == theirs == ["renamed.png"]
    assert [os.path.basename(f) for f in seen["port"]] == ["renamed.png"]
    _assert_files_equal(tmp_path, ours)
    assert decode_png((tmp_path / "port" / "renamed.png").read_bytes())[1]["added"] == "yes"


@pytest.mark.parametrize("fmt", ["avif", "heic", "jxl"])
def test_unported_formats_raise_naming_them(fmt, tmp_path):
    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(NotImplementedError, match=fmt):
        saving.save_image(img, str(tmp_path), seed=1, prompt="p", extension=fmt)
    assert not any(files for _, _, files in os.walk(tmp_path))


# --------------------------------------------------------------------------
# the pipelines
# --------------------------------------------------------------------------

def _tree(root) -> dict:
    return {os.path.relpath(os.path.join(r, f), root): os.path.join(r, f)
            for r, _, fs in os.walk(root) for f in fs}


def _assert_outputs_match(tmp_path, expect: int, exts=(".png",)):
    """Every file of the JAX run under the port's root too, PNG pixels within
    1 level with equal text chunks."""
    _flush()
    ours, theirs = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(ours) == sorted(theirs) and len(ours) == expect, (sorted(ours),
                                                                     sorted(theirs))
    for name in ours:
        assert name.endswith(exts)
        img, text = decode_png(open(ours[name], "rb").read())
        with Image.open(theirs[name]) as ref:
            if ref.mode == "L":
                img = img[:, :, 0]
            assert np.abs(img.astype(int) - np.asarray(ref, int)).max() <= 1, name
            assert text == {k: v for k, v in ref.info.items() if isinstance(v, str)}, name
    return ours


def _dirs(tmp_path, which):
    return str(tmp_path / which / "samples"), str(tmp_path / which / "grids")


def test_txt2img_batch_with_grid_saves_as_jax(models, f32_policies, tmp_path,  # noqa: F811
                                              both, fixed_clock):
    both(sdtpu_vae_bf16=False)
    kw = dict(prompt="a red cat", seed=31, steps=2, width=64, height=64, batch_size=2)
    outs = {}
    for which, mod, proc, model in (("jax", JaxParams, jax_proc, models[0]),
                                    ("port", GenerationParams, port_proc, models[1])):
        samples, grids = _dirs(tmp_path, which)
        p = mod(**kw)
        p.outpath_grids = grids
        outs[which] = proc.process_txt2img(model, p, outdir=samples)
    ours = _assert_outputs_match(tmp_path, 3)
    assert outs["port"].infotexts == outs["jax"].infotexts
    grid = [f for f in ours if f.startswith("grids")]
    assert len(grid) == 1 and os.path.basename(grid[0]) == "grid-0000.png"
    np.testing.assert_array_equal(decode_png(open(ours[grid[0]], "rb").read())[0],
                                  outs["port"].images[0])


def test_hires_before_copy_saves_as_jax(models, f32_policies, tmp_path,  # noqa: F811
                                        both, fixed_clock):
    both(sdtpu_vae_bf16=False, save_images_before_highres_fix=True, save_to_dirs=False)
    kw = dict(prompt="a cat", seed=5, steps=2, width=64, height=64, enable_hr=True,
              hr_scale=1.5, hr_upscaler="Latent", denoising_strength=0.6)
    for which, mod, proc, model in (("jax", JaxParams, jax_proc, models[0]),
                                    ("port", GenerationParams, port_proc, models[1])):
        proc.process_txt2img(model, mod(**kw), outdir=_dirs(tmp_path, which)[0])
    ours = _assert_outputs_match(tmp_path, 2)
    before = [f for f in ours if f.endswith("-before-highres-fix.png")]
    assert len(before) == 1
    assert decode_png(open(ours[before[0]], "rb").read())[0].shape == (64, 64, 3)


@pytest.mark.parametrize("case", ["color_correction", "masks", "init_image"])
def test_img2img_copies_save_as_jax(models, f32_policies, tmp_path,  # noqa: F811
                                    both, fixed_clock, case):
    settings = dict(sdtpu_vae_bf16=False, save_to_dirs=False)
    kw = dict(prompt="a cat", seed=8, steps=3, width=64, height=64, denoising_strength=0.6)
    init = _init_image(seed=12)
    expect = 1
    if case == "color_correction":
        settings.update(img2img_color_correction=True, save_images_before_color_correction=True)
        expect = 2
    elif case == "masks":
        settings.update(save_mask=True, save_mask_composite=True)
        kw.update(mask_blur=0, inpainting_fill=1, inpaint_full_res=False)
        expect = 3
    else:
        expect = 2
    both(**settings)
    outs = {}
    for which, mod, i2i, model, image in (("jax", JaxParams, jax_i2i, models[0],
                                           Image.fromarray(init)),
                                          ("port", GenerationParams, port_i2i, models[1], init)):
        extra = {}
        if case == "masks":
            extra["mask"] = Image.fromarray(_rect_mask()) if which == "jax" else _rect_mask()
        if case == "init_image":
            extra["override_settings"] = {"save_init_img": True,
                                          "outdir_init_images": str(tmp_path / which / "init")}
        outs[which] = i2i.process_img2img(model, mod(init_images=[image], **kw, **extra),
                                          outdir=_dirs(tmp_path, which)[0])
    ours = _assert_outputs_match(tmp_path, expect)
    assert outs["port"].infotexts == outs["jax"].infotexts
    suffixes = {"color_correction": ["-before-color-correction.png"],
                "masks": ["-mask.png", "-mask-composite.png"], "init_image": []}[case]
    for suffix in suffixes:
        assert any(f.endswith(suffix) for f in ours), (suffix, sorted(ours))
    if case == "init_image":
        (name,) = [f for f in ours if f.startswith("init")]
        assert f"Init image hash: {os.path.basename(name)[:-4]}" in outs["port"].infotexts[0]


def test_samples_format_jpg_writes_jpegs(models, f32_policies, tmp_path,  # noqa: F811
                                         both, fixed_clock):
    """samples_format jpg: the port's sample and grid (grid_format jpg) are
    Pillow's JPEG encoding of the port's images at jpeg_quality, the
    infotext in their UserComment, under JAX's names with .jpg."""
    both(sdtpu_vae_bf16=False, samples_format="jpg", grid_format="jpg", jpeg_quality=90,
         save_to_dirs=False, grid_save_to_dirs=False)
    kw = dict(prompt="a cat", seed=4, steps=2, width=64, height=64, batch_size=2)
    names = {}
    for which, mod, proc, model in (("jax", JaxParams, jax_proc, models[0]),
                                    ("port", GenerationParams, port_proc, models[1])):
        samples, grids = _dirs(tmp_path, which)
        p = mod(**kw)
        p.outpath_grids = grids
        res = proc.process_txt2img(model, p, outdir=samples)
        names[which] = res
    _flush()
    ours, theirs = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    samples_jax = sorted(f for f in theirs if f.startswith("samples"))
    assert all(f.endswith(".png") for f in samples_jax)      # JAX ignores samples_format
    assert sorted(ours) == sorted(f[:-4] + ".jpg" for f in theirs)
    res = names["port"]
    for name, path in ours.items():
        idx = 0 if name.startswith("grids") else 1 + int(os.path.basename(name)[:5])
        data = open(path, "rb").read()
        buf = io.BytesIO()
        jax_images.save_image_with_geninfo(Image.fromarray(res.images[idx]),
                                           res.infotexts[idx], buf, ".jpg")
        assert data == buf.getvalue(), name
        with Image.open(path) as im:
            assert jax_exif.read_user_comment(im) == res.infotexts[idx]
        assert decode_jpeg(data)[0].shape == res.images[idx].shape
