"""The port's upscale path against Pillow and the JAX package: Pillow's
resize (LANCZOS, BICUBIC, NEAREST; RGB and L), blend, crop and paste,
``split_grid`` / ``combine_grid`` and ``resize_image`` to 0 levels; RRDBNet
(modern and old keys, pixel-unshuffled x2 and x1) and SRVGGNetCompact
against JAX's ``esrgan.apply`` / ``apply_srvgg`` (f32, max|Δ|/max|ref| <=
1e-5) and the tiled ``upscale_image`` (1 level); the three-pass loop and
the cache; ``run_stages``; img2img's resize modes 0-2 against JAX's
``process_img2img``; the Extras, upscaler and img2img routes on the tiny
server."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)
import base64
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sdwebui_tpu.models import esrgan as jax_esrgan
from sdwebui_tpu.pipeline import img2img as jax_i2i
from sdwebui_tpu.pipeline import sd_model as jax_sd
from sdwebui_tpu.pipeline.params import GenerationParams as JaxParams
from sdwebui_tpu.postprocessing import stages as jax_stages
from sdwebui_tpu.postprocessing import upscalers as jax_upscalers
from sdwebui_tpu.utils import devices as jax_devices
from sdwebui_tpu.utils import images as jax_images
from sdwebui_tpu.utils.options import opts as jax_opts
from sdwebui_tpu_torch.models import esrgan as port_esrgan
from sdwebui_tpu_torch.pipeline import img2img as port_i2i
from sdwebui_tpu_torch.pipeline import sd_model as port_sd
from sdwebui_tpu_torch.pipeline.params import GenerationParams
from sdwebui_tpu_torch.postprocessing import stages as port_stages
from sdwebui_tpu_torch.postprocessing import upscalers as port_upscalers
from sdwebui_tpu_torch.utils import devices as port_devices
from sdwebui_tpu_torch.utils import images as port_images
from sdwebui_tpu_torch.utils.options import opts as port_opts
from sdwebui_tpu_torch.utils.png import decode_png, encode_png
from test_torch_hires import random_state_dict
from test_torch_models import _perturbed

NET_REL_TOL = 1e-5
FILTERS = {"lanczos": Image.LANCZOS, "bicubic": Image.BICUBIC, "nearest": Image.NEAREST}
SIZES = [((64, 64), (128, 128)), ((64, 64), (96, 96)), ((37, 53), (13, 10)),
         ((100, 31), (300, 77)), ((8, 8), (20, 31)), ((512, 512), (64, 64)), ((81, 77), (81, 40))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models' ops are too small to split over threads; with
    several test workers on the machine's cores, extra threads only wait
    on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _img(h, w, seed=0, channels=3):
    shape = (h, w, channels) if channels > 1 else (h, w)
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# --------------------------------------------------------------------------
# Pillow's operations
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["RGB", "L"])
@pytest.mark.parametrize("resample", list(FILTERS))
def test_resize_matches_pillow_exactly(resample, mode):
    """Up, down, odd sizes and one axis only."""
    for i, (src, dst) in enumerate(SIZES):
        a = _img(src[1], src[0], i, 3 if mode == "RGB" else 1)
        ref = np.asarray(Image.fromarray(a, mode).resize(dst, FILTERS[resample]))
        out = port_images.resize(a, dst, resample)
        assert out.dtype == np.uint8 and out.shape == ref.shape
        np.testing.assert_array_equal(out, ref, err_msg=f"{src} -> {dst}")


@pytest.mark.parametrize("alpha", [0.0, 0.25, 0.5, 0.77, 1.0])
def test_blend_matches_pillow_exactly(alpha):
    a, b = _img(33, 17, 1), _img(33, 17, 2)
    ref = np.asarray(Image.blend(Image.fromarray(a), Image.fromarray(b), alpha))
    np.testing.assert_array_equal(port_images.blend(a, b, alpha), ref)


def test_crop_and_paste_match_pillow_exactly():
    a = _img(40, 30, 3)
    for box in ((0, 0, 30, 40), (5, 7, 25, 33), (-6, -4, 20, 50), (20, 30, 48, 64)):
        np.testing.assert_array_equal(port_images.crop(a, box),
                                      np.asarray(Image.fromarray(a).crop(box)))
    mask = _img(20, 16, 4, channels=1)
    for xy in ((0, 0), (5, 9), (-7, -3), (25, 30)):
        for m in (None, mask):
            ref = Image.fromarray(a.copy())
            ref.paste(Image.fromarray(_img(20, 16, 5)), xy,
                      None if m is None else Image.fromarray(m, "L"))
            out = port_images.paste(a.copy(), _img(20, 16, 5), xy, m)
            np.testing.assert_array_equal(out, np.asarray(ref))


@pytest.mark.parametrize("tile,overlap", [(192, 8), (128, 32), (64, 16), (512, 64)])
def test_split_and_combine_grid_match_jax_exactly(tile, overlap):
    """Tiles and offsets equal; every tile replaced, the feathered
    re-assembly equal to JAX's (Pillow's paste with L masks)."""
    img = _img(300, 420, 6)
    ref, out = jax_images.split_grid(Image.fromarray(img), tile, tile, overlap), \
        port_images.split_grid(img, tile, tile, overlap)
    assert (out.tile_w, out.tile_h, out.image_w, out.image_h, out.overlap) == \
        (ref.tile_w, ref.tile_h, ref.image_w, ref.image_h, ref.overlap)
    rng = np.random.default_rng(7)
    for (y, h, row), (y2, h2, row2) in zip(ref.tiles, out.tiles, strict=True):
        assert (y, h) == (y2, h2)
        for cell, cell2 in zip(row, row2, strict=True):
            assert cell[:2] == cell2[:2]
            np.testing.assert_array_equal(np.asarray(cell[2]), cell2[2])
            new = rng.integers(0, 256, cell2[2].shape, dtype=np.uint8)
            cell[2], cell2[2] = Image.fromarray(new), new
    np.testing.assert_array_equal(port_images.combine_grid(out),
                                  np.asarray(jax_images.combine_grid(ref)))


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_resize_image_matches_jax_exactly(mode):
    """Mode 3 ("just resize (latent upscale)") resizes as mode 0, as JAX's
    does (ROADMAP C)."""
    for i, (w, h) in enumerate(((64, 64), (80, 48), (48, 80), (300, 420), (20, 21))):
        src = _img(57, 71, i)
        ref = np.asarray(jax_images.resize_image(mode, Image.fromarray(src), w, h))
        np.testing.assert_array_equal(port_images.resize_image(mode, src, w, h), ref)


# --------------------------------------------------------------------------
# the ESRGAN family
# --------------------------------------------------------------------------

def _numpy(sd: dict) -> dict:
    return {k: v.numpy() for k, v in sd.items()}


def _rel(out, ref) -> float:
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _old_layout(sd: dict) -> dict:
    """Modern RRDBNet keys → the old ``model.N`` serialization (23 blocks)."""
    fixed = {v: k for k, v in port_esrgan._OLD_FIXED.items()}
    out = {}
    for k, v in sd.items():
        parts = k.split(".")
        if parts[0] == "body":
            out[f"model.1.sub.{parts[1]}.RDB{parts[2][-1]}.conv{parts[3][-1]}.0.{parts[4]}"] = v
        else:
            out[f"{fixed[parts[0]]}.{parts[1]}"] = v
    return out


RRDB_CASES = {
    "x4": dict(in_ch=3, n_blocks=2, size=(13, 11)),
    "x4_old_keys": dict(in_ch=3, n_blocks=23, size=(9, 10), old=True),
    "x4_old_keys_model_model": dict(in_ch=3, n_blocks=23, size=(8, 8), old=True,
                                    prefix="model."),
    "x2_unshuffled": dict(in_ch=12, n_blocks=1, size=(15, 17)),
    "x1_unshuffled": dict(in_ch=48, n_blocks=1, size=(14, 18)),
}


@pytest.mark.parametrize("case", list(RRDB_CASES))
def test_rrdbnet_matches_jax(case):
    c = RRDB_CASES[case]
    net = port_esrgan.RRDBNet(in_ch=c["in_ch"], nf=8, gc=4, n_blocks=c["n_blocks"])
    sd = random_state_dict(net, 11)
    if c.get("old"):
        sd = _old_layout(sd)
    if c.get("prefix"):
        sd = {c["prefix"] + k: v for k, v in sd.items()}
    params, scale = jax_esrgan.load_esrgan("unused", sd=_numpy(sd))
    port = port_esrgan.rrdbnet_from_state_dict(sd, device="cpu")
    assert port.scale == scale == {3: 4, 12: 2, 48: 1}[c["in_ch"]]
    x = np.random.default_rng(12).random((2,) + c["size"] + (3,), np.float32)
    ref = np.asarray(jax_esrgan.apply(params, jnp.asarray(x), scale)).transpose(0, 3, 1, 2)
    with torch.inference_mode():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert out.shape == ref.shape == (2, 3, c["size"][0] * scale, c["size"][1] * scale)
    assert 0.01 < ref.std() and _rel(out, ref) <= NET_REL_TOL


@pytest.mark.parametrize("scale", [4, 2])
def test_srvgg_matches_jax(scale):
    net = port_esrgan.SRVGGNetCompact(nf=8, num_conv=4, scale=scale)
    sd = {"params." + k: v for k, v in random_state_dict(net, 13).items()}
    params, jscale = jax_esrgan.load_srvgg("unused", sd=_numpy(sd))
    port = port_esrgan.srvgg_from_state_dict({k[len("params."):]: v for k, v in sd.items()},
                                           device="cpu")
    assert port.scale == jscale == scale
    x = np.random.default_rng(14).random((2, 12, 9, 3), np.float32)
    ref = np.asarray(jax_esrgan.apply_srvgg(params, jnp.asarray(x), scale)).transpose(0, 3, 1, 2)
    with torch.inference_mode():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert out.shape == ref.shape and _rel(out, ref) <= NET_REL_TOL


@pytest.mark.parametrize("arch", ["rrdbnet", "srvgg"])
@pytest.mark.parametrize("tile", [0, 32])
def test_tiled_upscale_image_matches_jax(arch, tile):
    """One tile, and nine 32² tiles in one batched call: within 1 level."""
    img = _img(70, 62, 15)
    if arch == "rrdbnet":
        sd = random_state_dict(port_esrgan.RRDBNet(nf=8, gc=4, n_blocks=1), 16)
        params, scale = jax_esrgan.load_esrgan("unused", sd=_numpy(sd))
        ref = jax_esrgan.upscale_image(params, Image.fromarray(img), scale, tile=tile,
                                       overlap=8)
        net = port_esrgan.rrdbnet_from_state_dict(sd, device="cpu")
    else:
        sd = random_state_dict(port_esrgan.SRVGGNetCompact(nf=8, num_conv=2), 17)
        params, scale = jax_esrgan.load_srvgg("unused", sd=_numpy(sd))
        ref = jax_esrgan.upscale_image_srvgg(params, Image.fromarray(img), scale, tile=tile,
                                             overlap=8)
        net = port_esrgan.srvgg_from_state_dict(sd, device="cpu")
    out = port_esrgan.upscale_image(net, img, tile=tile, overlap=8)
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (280, 248, 3) and out.std() > 5
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


def test_register_dir_sniffs_each_file(tmp_path):
    """Both architectures from one directory, .safetensors and .pth, read
    at first use; the same images as JAX's registry gives."""
    from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors

    rrdb = random_state_dict(port_esrgan.RRDBNet(nf=8, gc=4, n_blocks=1), 18)
    srvgg = random_state_dict(port_esrgan.SRVGGNetCompact(nf=8, num_conv=2), 19)
    write_safetensors(str(tmp_path / "R-ESRGAN test.safetensors"), rrdb)
    torch.save({"params": srvgg}, str(tmp_path / "realesr-test.pth"))
    (tmp_path / "notes.txt").write_text("not a model")
    names = port_esrgan.register_esrgan_dir((str(tmp_path), str(tmp_path / "missing")),
                                           device="cpu")
    jax_names = jax_esrgan.register_esrgan_dir(dirs=(str(tmp_path),))
    try:
        assert names == jax_names == ["R-ESRGAN test", "realesr-test"]
        img = _img(40, 36, 20)
        for name in names:
            ref = np.asarray(jax_upscalers.upscale(name, Image.fromarray(img), 2.0))
            out = port_upscalers.upscale(name, img, 2.0)
            assert out.shape == ref.shape == (80, 72, 3)
            assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    finally:
        for name in names:
            port_upscalers.unregister_upscaler(name)
            jax_upscalers._REGISTRY.pop(name, None)
        jax_upscalers._UPSCALE_CACHE.clear()
        assert not port_upscalers._CACHE


def test_esrgan_loaders_default_to_the_card(tmp_path, monkeypatch):
    """Without a device the nets and the registered files go to "cuda",
    which raises where there is no card: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sd = random_state_dict(port_esrgan.SRVGGNetCompact(nf=8, num_conv=2), 22)
    with pytest.raises(RuntimeError, match="cuda"):
        port_esrgan.srvgg_from_state_dict(sd)
    with pytest.raises(RuntimeError, match="cuda"):
        port_esrgan.register_esrgan_dir((str(tmp_path),))


def test_unregister_drops_the_entry_and_its_cache():
    img = _img(10, 12, 23)
    for name in ("x2-a", "x2-b"):
        port_upscalers.register_upscaler(name, _resize_x2, default_scale=2)
    try:
        for name in ("x2-a", "x2-b"):
            port_upscalers.upscale(name, img, 2.0)
        assert sorted(k[0] for k in port_upscalers._CACHE) == ["x2-a", "x2-b"]
        port_upscalers.unregister_upscaler("x2-a")
        assert [k[0] for k in port_upscalers._CACHE] == ["x2-b"]
        assert "x2-a" not in port_upscalers.upscaler_names()
        with pytest.raises(port_upscalers.UpscalerNotFound, match="x2-a"):
            port_upscalers.upscale("x2-a", img, 2.0)
    finally:
        for name in ("x2-a", "x2-b"):
            port_upscalers.unregister_upscaler(name)
    assert not port_upscalers._CACHE


def _resize_x2(im, s):
    return port_images.resize(im, (im.shape[1] * 2, im.shape[0] * 2), "nearest")


def test_three_pass_loop_and_cache_match_jax():
    calls = {"port": 0, "jax": 0}

    def port_fn(im, s):
        calls["port"] += 1
        return port_images.resize(im, (im.shape[1] * 2, im.shape[0] * 2), "nearest")

    def jax_fn(im, s):
        calls["jax"] += 1
        return im.resize((im.width * 2, im.height * 2), Image.NEAREST)

    port_upscalers.register_upscaler("x2-test", port_fn, default_scale=2)
    jax_upscalers.register_upscaler("x2-test", jax_fn, default_scale=2)
    img = _img(10, 12, 21)
    try:
        for scale, passes in ((5.0, 3), (2.5, 2), (20.0, 3), (0.5, 0)):
            before = dict(calls)
            ref = np.asarray(jax_upscalers.upscale("x2-test", Image.fromarray(img), scale))
            out = port_upscalers.upscale("x2-test", img, scale)
            np.testing.assert_array_equal(out, ref)
            assert calls["port"] - before["port"] == calls["jax"] - before["jax"] == passes
            before = dict(calls)
            np.testing.assert_array_equal(port_upscalers.upscale("x2-test", img, scale), ref)
            assert calls["port"] == before["port"]            # a cache hit
        with port_opts.override({"upscaling_max_images_in_cache": 0}):
            port_upscalers.upscale("x2-test", img, 2.5)
        assert calls["port"] == before["port"] + 2            # no cache
        with port_opts.override({"upscaling_max_images_in_cache": 2}):
            for seed in range(4):
                port_upscalers.upscale("x2-test", _img(10, 12, 30 + seed), 2.0)
            assert len(port_upscalers._CACHE) == 2
        np.testing.assert_array_equal(
            port_upscalers.upscale_by_name("Lanczos", img, 50, 31),
            np.asarray(jax_upscalers.upscale_by_name("Lanczos", Image.fromarray(img), 50, 31)))
        with pytest.raises(port_upscalers.UpscalerNotFound, match="nope"):
            port_upscalers.upscale("nope", img, 2.0)
    finally:
        port_upscalers._REGISTRY.pop("x2-test", None)
        jax_upscalers._REGISTRY.pop("x2-test", None)
        port_upscalers._CACHE.clear()
        jax_upscalers._UPSCALE_CACHE.clear()


def test_upscaler_names_filter_realesrgan():
    for name in ("R-ESRGAN 4x+", "R-ESRGAN 2x+"):
        port_upscalers.register_upscaler(name, lambda im, s: im)
        jax_upscalers.register_upscaler(name, lambda im, s: im)
    try:
        for enabled in (None, ["R-ESRGAN 2x+"], []):
            with port_opts.override({} if enabled is None else
                                    {"realesrgan_enabled_models": enabled}), \
                    jax_opts.override({} if enabled is None else
                                      {"realesrgan_enabled_models": enabled}):
                names = port_upscalers.upscaler_names()
                assert names == [n for n in jax_upscalers.upscaler_names()
                                 if n in port_upscalers._REGISTRY]
                assert names[:3] == ["None", "Lanczos", "Nearest"]
        assert "R-ESRGAN 2x+" not in names
    finally:
        for name in ("R-ESRGAN 4x+", "R-ESRGAN 2x+"):
            port_upscalers._REGISTRY.pop(name, None)
            jax_upscalers._REGISTRY.pop(name, None)


# --------------------------------------------------------------------------
# the extras stage chain
# --------------------------------------------------------------------------

STAGE_CASES = {
    "scale_by_lanczos": dict(upscaling_resize=2.0, upscaler_1="Lanczos"),
    "scale_by_1.5_nearest": dict(upscaling_resize=1.5, upscaler_1="Nearest"),
    "scale_to_crop": dict(resize_mode=1, upscaling_resize_w=100, upscaling_resize_h=70,
                          upscaler_1="Lanczos"),
    "scale_to_no_crop": dict(resize_mode=1, upscaling_resize_w=100, upscaling_resize_h=70,
                             upscaling_crop=False, upscaler_1="Lanczos"),
    "max_side_length": dict(upscaling_resize=4.0, upscaler_1="Lanczos", max_side_length=150),
    "upscaler_2_blend": dict(upscaling_resize=2.0, upscaler_1="Lanczos", upscaler_2="Nearest",
                             extras_upscaler_2_visibility=0.5),
    "upscaler_none": dict(upscaling_resize=1.0, upscaler_1="None"),
}


@pytest.mark.parametrize("case", list(STAGE_CASES))
def test_run_stages_matches_jax(case):
    img = _img(45, 61, 22)
    ref = jax_stages.run_stages(Image.fromarray(img), jax_stages.StageArgs.from_obj(
        STAGE_CASES[case]))
    out = port_stages.run_stages(img, port_stages.StageArgs.from_obj(STAGE_CASES[case]))
    np.testing.assert_array_equal(out, np.asarray(ref))


def test_stage_order_options_and_face_restoration():
    img = _img(20, 24, 23)
    args = port_stages.StageArgs(upscaler_1="Lanczos", gfpgan_visibility=0.5)
    # the face stages run since the faces port; no weights file is here
    with pytest.raises(FileNotFoundError, match="GFPGAN"):
        port_stages.run_stages(img, args, device="cpu")
    with port_opts.override({"postprocessing_disable_in_extras": ["GFPGAN"]}):
        assert port_stages.run_stages(img, args).shape == (40, 48, 3)
    assert port_stages.run_stages(img, args, enabled={"Upscale"}).shape == (40, 48, 3)
    args = port_stages.StageArgs(upscaler_1="Lanczos", codeformer_visibility=0.3)
    with port_opts.override({"postprocessing_disable_in_extras": ["Upscale"]}), \
            pytest.raises(FileNotFoundError, match="CodeFormer"):
        port_stages.run_stages(img, args, device="cpu")
    assert [f.name for f in dataclasses.fields(port_stages.StageArgs)] == \
        [f.name for f in dataclasses.fields(jax_stages.StageArgs)]


# --------------------------------------------------------------------------
# img2img resize modes
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jm = jax_sd.create_tiny_sd(5)
    rng = np.random.default_rng(52)
    jm = dataclasses.replace(jm, unet_params=_perturbed(jm.unet_params, rng),
                             vae_params=_perturbed(jm.vae_params, rng))
    jm.conditioner.params = _perturbed(jm.conditioner.params, rng)
    return jm, port_sd.from_jax(jm, device="cpu")


@pytest.fixture
def f32_policies():
    jax_prev, port_prev = jax_devices.get_policy(), port_devices.get_policy()
    jax_devices.set_policy(jax_devices.DtypePolicy(jnp.float32, jnp.float32,
                                                   jnp.float32, jnp.float32))
    port_devices.set_policy(port_devices.FP32_POLICY)
    yield
    jax_devices.set_policy(jax_prev)
    port_devices.set_policy(port_prev)


def _mask(w, h):
    m = np.zeros((h, w), np.uint8)
    m[h // 4: 3 * h // 4, w // 5: 4 * w // 5] = 255
    return m


I2I_RESIZE_CASES = {
    "stretch": dict(resize_mode=0, init_images=[_img(48, 80, 24)]),
    "crop": dict(resize_mode=1, init_images=[_img(48, 80, 24)]),
    "pad": dict(resize_mode=2, init_images=[_img(80, 48, 25)]),
    "inpaint_crop_mask_96": dict(resize_mode=1, init_images=[_img(96, 96, 26)],
                                 mask=_mask(96, 96), mask_blur=4, inpainting_fill=1),
    "upscaler_for_img2img": dict(resize_mode=0, init_images=[_img(32, 40, 27)],
                                 override_settings={"sdtpu_vae_bf16": False,
                                                    "upscaler_for_img2img": "Nearest"}),
}


@pytest.mark.parametrize("case", list(I2I_RESIZE_CASES))
def test_img2img_resize_modes_match_jax(models, f32_policies, case):
    jm, pm = models
    kw = dict(prompt="a cat", negative_prompt="blurry", seed=17, steps=4, width=64, height=64,
              batch_size=1, cfg_scale=7.5, denoising_strength=0.75,
              override_settings={"sdtpu_vae_bf16": False})
    kw.update(I2I_RESIZE_CASES[case])
    ref = jax_i2i.process_img2img(jm, JaxParams(**kw))
    out = port_i2i.process_img2img(pm, GenerationParams(**kw))
    a, b = out.images[out.index_of_first_image], np.asarray(ref.images[ref.index_of_first_image])
    assert a.shape == b.shape
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert out.infotexts == ref.infotexts


# --------------------------------------------------------------------------
# routes
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def server_url():
    from sdwebui_tpu_torch.server.api import make_server
    from sdwebui_tpu_torch.server.app import Engine

    server = make_server(Engine(device="cpu", tiny=True, seed=5), "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}/sdapi/v1"
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def _call(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _b64(img) -> str:
    return base64.b64encode(encode_png(img)).decode("ascii")


def test_extras_single_image_route_matches_jax_stages(server_url):
    img = _img(40, 50, 28)
    for body in (dict(upscaling_resize=2, upscaler_1="Lanczos", upscaler_2="Nearest",
                      extras_upscaler_2_visibility=0.5),
                 dict(resize_mode=1, upscaling_resize_w=90, upscaling_resize_h=60,
                      upscaler_1="Lanczos", upscaling_crop=True)):
        status, res = _call(server_url + "/extra-single-image", {"image": _b64(img), **body})
        assert status == 200, res
        assert res["html_info"] == "<p>Upscaled with Lanczos</p>"
        out = decode_png(base64.b64decode(res["image"]))[0]
        ref = jax_stages.run_stages(Image.fromarray(img), jax_stages.StageArgs.from_obj(body))
        np.testing.assert_array_equal(out, np.asarray(ref))


def test_extras_batch_route(server_url):
    imgs = [_img(16, 20, 29), _img(24, 12, 30)]
    status, res = _call(server_url + "/extra-batch-images", {
        "imageList": [{"data": _b64(im), "name": f"{i}.png"} for i, im in enumerate(imgs)],
        "upscaling_resize": 3, "upscaler_1": "Nearest"})
    assert status == 200, res
    assert res["html_info"] == "<p>2 images upscaled</p>"
    shapes = [decode_png(base64.b64decode(b))[0].shape for b in res["images"]]
    assert shapes == [(48, 60, 3), (72, 36, 3)]


@pytest.mark.parametrize("body,status,word", [
    ({}, 404, "Image not found"),
    ({"upscaler_1": "R-ESRGAN 9x"}, 422, "R-ESRGAN 9x"),
    ({"upscaler_1": "Lanczos", "upscaler_2": "SwinIR 4x"}, 422, "SwinIR 4x"),
    ({"gfpgan_visibility": 0.5}, 422, "GFPGAN"),
    ({"codeformer_visibility": 0.5}, 422, "CodeFormer"),
    ({"save_output": "yes"}, 422, "save_output"),
    ({"resize_mode": 3}, 422, "resize_mode 3"),
    ({"upscaling_resize": "2"}, 422, "upscaling_resize"),
    ({"bogus": 1}, 422, "bogus"),
])
def test_extras_route_errors(server_url, body, status, word):
    full = {"image": _b64(_img(8, 8, 31)), **body} if body else {}
    code, res = _call(server_url + "/extra-single-image", full)
    assert code == status and word in res["detail"], res


def test_upscalers_route_and_option(server_url):
    status, res = _call(server_url + "/upscalers")
    assert status == 200
    names = [u["name"] for u in res]
    assert names[:3] == ["None", "Lanczos", "Nearest"]
    assert set(res[0]) == {"name", "model_name", "model_path", "model_url", "scale"}
    default = port_opts.get("realesrgan_enabled_models")
    try:
        assert _call(server_url + "/options", {"realesrgan_enabled_models": ["x"]}) == (200, {})
        assert port_opts.get("realesrgan_enabled_models") == ["x"]
        assert _call(server_url + "/options", {"realesrgan_enabled_models": 3})[0] == 422
    finally:
        port_opts.set("realesrgan_enabled_models", default)


def test_img2img_route_resizes_init_images(server_url):
    init = _img(48, 80, 32)
    status, res = _call(server_url + "/img2img", {
        "init_images": [_b64(init)], "resize_mode": 1, "steps": 2, "width": 64, "height": 64,
        "mask": _b64(np.repeat(_mask(80, 48)[:, :, None], 3, axis=2)),
        "inpaint_full_res": False, "inpainting_fill": 1,
        "override_settings": {"upscaler_for_img2img": "Lanczos"}})
    assert status == 200, res
    assert decode_png(base64.b64decode(res["images"][0]))[0].shape == (64, 64, 3)
    status, res = _call(server_url + "/img2img", {
        "init_images": [_b64(init)], "steps": 1, "width": 64, "height": 64,
        "override_settings": {"upscaler_for_img2img": "R-ESRGAN 9x"}})
    assert status == 422 and "R-ESRGAN 9x" in res["detail"], res
