"""The rest of img2img and inpainting in the port against Pillow and the JAX
package (CPU, f32).

The Pillow operations of ``inpainting_fill`` 0 and of the inpaint-full-res
crop (premultiply, unpremultiply, alpha_composite, GaussianBlur of RGBa,
``masking.fill``, the crop region, the crop paste, the RGBa mask
composite) equal Pillow and JAX in every pixel over a grid of masks
(rectangles at the borders, blobs, an empty and a full mask); colour
correction within 1 uint8 level of JAX's; ``soft_latent_blend`` and the
soft-inpainting denoiser within 1e-5 (relative, f32); then
``process_img2img`` on the tiny SD1.5 model for every new request field
and option, within 1 uint8 level with identical infotext; and the
``/sdapi/v1/img2img`` route with the reference API's default inpaint
fields, the prompt-style routes and ``styles`` on both routes.
"""

import base64
import dataclasses
import json
import os
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageFilter

from sdwebui_tpu.pipeline import img2img as jax_i2i
from sdwebui_tpu.pipeline import processing as jax_proc
from sdwebui_tpu.sampling.cfg import CondSchedule as JaxSched
from sdwebui_tpu.sampling.cfg import make_cfg_denoiser as jax_cfg
from sdwebui_tpu.sampling.cfg import soft_latent_blend as jax_soft_blend
from sdwebui_tpu.utils import color as jax_color
from sdwebui_tpu.utils import masking as jax_masking
from sdwebui_tpu_torch.pipeline import img2img as port_i2i
from sdwebui_tpu_torch.pipeline import processing as port_proc
from sdwebui_tpu_torch.sampling.cfg import CondSchedule, make_cfg_denoiser, soft_latent_blend
from sdwebui_tpu_torch.utils import color as port_color
from sdwebui_tpu_torch.utils import images as port_images
from sdwebui_tpu_torch.utils import masking as port_masking
from sdwebui_tpu_torch.utils.png import decode_png, encode_png
from test_torch_img2img import (_init_image, _pair, _rect_mask, f32_policies,  # noqa: F401
                                models)
from test_torch_models import _assert_rel


def _mask_grid():
    """(name, image size (w, h), L mask) over the shapes the crop and fill
    must handle."""
    rng = np.random.default_rng(31)
    out = []
    for w, h in ((64, 64), (96, 72)):
        def rect(x0, y0, x1, y1):
            m = np.zeros((h, w), np.uint8)
            m[y0:y1, x0:x1] = 255
            return m
        blob = np.where(port_masking.gaussian_blur(
            (rng.random((h, w)) > 0.93).astype(np.uint8) * 255, 3) > 20, 255, 0).astype(np.uint8)
        out += [(f"{w}x{h}_rect_top_left", (w, h), rect(0, 0, w // 3, h // 4)),
                (f"{w}x{h}_rect_right_edge", (w, h), rect(w - 9, h // 3, w, h // 2)),
                (f"{w}x{h}_rect_bottom", (w, h), rect(w // 4, h - 5, w // 2, h)),
                (f"{w}x{h}_blobs", (w, h), blob),
                (f"{w}x{h}_blurred_blobs", (w, h), port_masking.blur_mask(blob, 4)),
                (f"{w}x{h}_empty", (w, h), np.zeros((h, w), np.uint8)),
                (f"{w}x{h}_full", (w, h), np.full((h, w), 255, np.uint8))]
    return out


MASKS = _mask_grid()
MASK_IDS = [m[0] for m in MASKS]


def _rgb(size, seed):
    w, h = size
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


# --------------------------------------------------------------------------
# the Pillow operations of fill and the crop
# --------------------------------------------------------------------------

def test_premultiply_unpremultiply_and_alpha_composite_match_pillow():
    rng = np.random.default_rng(32)
    a = rng.integers(0, 256, (29, 41, 4), dtype=np.uint8)
    b = rng.integers(0, 256, (29, 41, 4), dtype=np.uint8)
    a[::3, :, 3] = 0
    a[1::5, :, 3] = 255
    b[:, ::4, 3] = 0
    np.testing.assert_array_equal(port_masking.premultiply(a),
                                  np.asarray(Image.fromarray(a, "RGBA").convert("RGBa")))
    np.testing.assert_array_equal(port_masking.unpremultiply(a),
                                  np.asarray(Image.fromarray(a, "RGBa").convert("RGBA")))
    for dst, src in ((a, b), (b, a), (np.zeros_like(a), b)):
        ref = Image.fromarray(dst, "RGBA")
        ref.alpha_composite(Image.fromarray(src, "RGBA"))
        np.testing.assert_array_equal(port_masking.alpha_composite(dst, src), np.asarray(ref))


@pytest.mark.parametrize("radius", [0, 1, 2, 4, 16, 64, 256])
def test_gaussian_blur_of_rgba_matches_pillow(radius):
    """Every channel blurred on its own, as Pillow's RGBa filter does, also
    where the radius passes the image's size."""
    a = np.random.default_rng(33).integers(0, 256, (37, 50, 4), dtype=np.uint8)
    ref = np.asarray(Image.fromarray(a, "RGBa").filter(ImageFilter.GaussianBlur(radius)))
    np.testing.assert_array_equal(port_masking.gaussian_blur(a, radius), ref)


@pytest.mark.parametrize("name,size,mask", MASKS, ids=MASK_IDS)
def test_fill_matches_pillow_and_jax(name, size, mask):
    """inpainting_fill 0's colour fill, and its composite under the
    binarized mask as img2img makes it: equal in every pixel."""
    img = _rgb(size, 34)
    ref = jax_masking.fill(Image.fromarray(img), Image.fromarray(mask))
    out = port_masking.fill(img, mask)
    np.testing.assert_array_equal(out, np.asarray(ref))
    ref_comp = Image.composite(ref, Image.fromarray(img),
                               jax_masking.binarize_mask(Image.fromarray(mask)))
    out_comp = port_images.composite(out, img, port_masking.binarize_mask(mask))
    np.testing.assert_array_equal(out_comp, np.asarray(ref_comp))


@pytest.mark.parametrize("pad", [0, 5, 32])
@pytest.mark.parametrize("name,size,mask", MASKS, ids=MASK_IDS)
def test_crop_region_matches_jax(name, size, mask, pad):
    for target in ((64, 64), (64, 48), (40, 64)):
        ref = jax_masking.get_crop_region_v2(mask > 127, pad)
        out = port_masking.get_crop_region_v2(mask > 127, pad)
        assert out == ref
        assert port_masking.expand_crop_region(out, *target, *size) == \
            jax_masking.expand_crop_region(ref, *target, *size)


@pytest.mark.parametrize("name,size,mask", MASKS, ids=MASK_IDS)
def test_crop_paste_and_mask_composite_match_jax(name, size, mask):
    """apply_overlay with the inpaint-full-res crop region (the generated
    image resized into the box, composited under the box's overlay mask,
    pasted into the original) and without one; the RGBa composite of
    return_mask_composite."""
    original = _rgb(size, 35)
    gen = _rgb((64, 64), 36)
    overlay = port_masking.blur_mask(mask, 4)
    box = port_masking.expand_crop_region(
        port_masking.get_crop_region_v2(overlay > 127, 8), 64, 64, *size)
    for crop in (box, None):
        info = {"mask": overlay, "overlay_mask": overlay, "crop_region": crop,
                "originals": [original]}
        jax_info = dict(info, mask=Image.fromarray(overlay),
                        overlay_mask=Image.fromarray(overlay),
                        originals=[Image.fromarray(original)])
        ref = jax_i2i.apply_overlay(None, Image.fromarray(gen), jax_info, 0)
        np.testing.assert_array_equal(port_i2i.apply_overlay(gen, info, 0), np.asarray(ref))
    m64 = port_images.resize(overlay, (64, 64))
    ref = Image.composite(Image.fromarray(gen).convert("RGBA").convert("RGBa"),
                          Image.new("RGBa", (64, 64)), Image.fromarray(m64)).convert("RGBA")
    np.testing.assert_array_equal(port_images.mask_composite(gen, m64), np.asarray(ref))


def test_color_correction_matches_jax():
    """LAB histogram matching against the init image: within 1 uint8 level
    of JAX's (the same numpy arithmetic, so equal in practice)."""
    rng = np.random.default_rng(37)
    init = np.kron(rng.integers(0, 256, (12, 10, 3)), np.ones((6, 6, 1))).astype(np.uint8)
    for img in (_rgb((64, 64), 38), _init_image(seed=39), np.full((64, 64, 3), 7, np.uint8)):
        target = jax_color.setup_color_correction(Image.fromarray(init))
        ref = np.asarray(jax_color.apply_color_correction(target, Image.fromarray(img)))
        out = port_color.apply_color_correction(port_color.setup_color_correction(init), img)
        assert out.shape == ref.shape and out.dtype == np.uint8
        assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


# --------------------------------------------------------------------------
# soft inpainting
# --------------------------------------------------------------------------

@pytest.mark.parametrize("detail", [1.0, 4.0, 8.0])
def test_soft_latent_blend_matches_jax(detail):
    rng = np.random.default_rng(40)
    a = rng.standard_normal((2, 4, 8, 8), dtype=np.float32)
    b = rng.standard_normal((2, 4, 8, 8), dtype=np.float32)
    t = rng.random((1, 1, 8, 8)).astype(np.float32)
    nhwc = lambda x: jnp.asarray(x.transpose(0, 2, 3, 1))  # noqa: E731
    ref = np.asarray(jax_soft_blend(nhwc(a), nhwc(b), nhwc(t), detail)).transpose(0, 3, 1, 2)
    out = soft_latent_blend(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(t),
                            detail)
    _assert_rel(out.numpy(), ref, 1e-5)


@pytest.mark.parametrize("sigma,soft", [(14.6, (1.0, 0.5, 4.0)), (0.9, (2.0, 0.25, 2.0)),
                                        (3.0, (0.5, 1.0, 8.0))])
def test_soft_inpainting_denoiser_matches_jax(sigma, soft):
    """The σ-scheduled mask nmask^(σ^power · scale) blended before a toy
    denoiser and no blend after it (cfg.py:138-145,195-197): 1e-5."""
    rng = np.random.default_rng(41)
    b, c, h, w, s, d = 2, 4, 8, 8, 5, 6
    x = rng.standard_normal((b, c, h, w), dtype=np.float32)
    init = rng.standard_normal((b, c, h, w), dtype=np.float32)
    nmask = rng.random((1, 1, h, w)).astype(np.float32)
    bank = rng.standard_normal((1, 1, s, d), dtype=np.float32)
    ubank = rng.standard_normal((1, s, d), dtype=np.float32)
    proj = rng.standard_normal((d, c), dtype=np.float32)
    sched = dict(cond_idx=np.zeros((1, 1), np.int32), cond_weights=np.ones(1, np.float32),
                 uncond_idx=np.zeros(1, np.int32), cond_scale=5.0)

    def jax_denoise(x, sigma, ctx, y=None, c_concat=None):
        return x * 0.5 + jnp.einsum("nsd,dc->nc", ctx, jnp.asarray(proj))[:, None, None, :]

    def port_denoise(x, sigma, ctx):
        return x * 0.5 + torch.einsum("nsd,dc->nc", ctx, torch.from_numpy(proj))[:, :, None, None]

    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731
    js = JaxSched(cond_bank=jnp.asarray(bank), uncond_bank=jnp.asarray(ubank),
                  **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                     for k, v in sched.items()})
    ref = jax_cfg(jax_denoise, js, mask=1.0 - nhwc(nmask), nmask=nhwc(nmask),
                  init_latent=nhwc(init), soft_inpainting=soft)(
                      nhwc(x), jnp.float32(sigma), 0)
    ps = CondSchedule(cond_bank=torch.from_numpy(bank), uncond_bank=torch.from_numpy(ubank),
                      **sched)
    nm = torch.from_numpy(nmask)
    out = make_cfg_denoiser(port_denoise, ps, mask=1.0 - nm, nmask=nm,
                            init_latent=torch.from_numpy(init),
                            soft_inpainting=soft)(torch.from_numpy(x), sigma, 0)
    _assert_rel(out.numpy(), np.asarray(ref).transpose(0, 3, 1, 2), 1e-5)


# --------------------------------------------------------------------------
# process_img2img against the JAX package
# --------------------------------------------------------------------------

def _blob_mask(size=128):
    m = np.zeros((size, size), np.uint8)
    m[size // 4: size // 2, size // 3: size * 3 // 4] = 255
    m[size * 5 // 8: size * 3 // 4, size // 8: size // 4] = 255
    return m


def _smooth_image(size=64):
    """Colour ramps: colour correction maps each pixel's rank in the image to
    the init image's quantile at that rank, so a 1-level change of the
    decode moves its output by 1-level steps only where the init image's
    histogram has no gaps (a blocky init image of few colours turns such a
    change into a jump to the next colour, in JAX as in the port)."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1)
    return (np.stack([x, y, (x + y) / 2], axis=-1) * 200 + 20).astype(np.uint8)


def _noise_override(seed=42):
    return np.random.default_rng(seed).standard_normal((1, 4, 8, 8)).astype(np.float32)


_MASKED = dict(init_images=[_init_image()], mask=_rect_mask(), mask_blur=4)
I2I_CASES = {
    "full_res_pad0": dict(init_images=[_init_image(size=128)], mask=_blob_mask(), mask_blur=4,
                          inpainting_fill=1, inpaint_full_res=True,
                          inpaint_full_res_padding=0),
    "full_res_pad32_fill0": dict(init_images=[_init_image(size=128)], mask=_blob_mask(),
                                 mask_blur=4, inpainting_fill=0, inpaint_full_res=True,
                                 inpaint_full_res_padding=32),
    "fill0": dict(_MASKED, inpainting_fill=0, inpaint_full_res=False),
    "defaults": dict(_MASKED),     # inpainting_fill 0, inpaint_full_res True
    "soft_inpainting": dict(_MASKED, inpainting_fill=1, inpaint_full_res=False,
                            soft_inpainting=True, mask_blend_power=1.5,
                            mask_blend_scale=0.4, inpaint_detail_preservation=3.0),
    "color_correction": dict(init_images=[_smooth_image()],
                             override_settings={"sdtpu_vae_bf16": False,
                                                "img2img_color_correction": True}),
    "color_correction_inpaint": dict(_MASKED, inpainting_fill=1, inpaint_full_res=False,
                                     override_settings={"sdtpu_vae_bf16": False,
                                                        "img2img_color_correction": True}),
    "resize_mode3": dict(init_images=[_init_image(size=128)], resize_mode=3),
    "resize_mode3_mask": dict(init_images=[_init_image(size=128)], mask=_blob_mask(),
                              mask_blur=4, inpainting_fill=1, inpaint_full_res=False,
                              resize_mode=3),
    "return_masks": dict(_MASKED, inpainting_fill=1, inpaint_full_res=False,
                         override_settings={"sdtpu_vae_bf16": False, "return_mask": True,
                                            "return_mask_composite": True}),
    "init_noise_override": dict(init_images=[_init_image()], init_noise_override=True),
    "tiling": dict(init_images=[_init_image()], tiling=True),
    "tiling_inpaint": dict(_MASKED, inpainting_fill=1, inpaint_full_res=False, tiling=True),
}


def _run_pair(models, kw):
    jm, pm = models
    kw = dict(kw)
    noise = None
    if kw.pop("init_noise_override", False):
        noise = _noise_override()
    jp, pp = _pair(**kw)
    if noise is not None:
        jp.init_noise_override = noise.transpose(0, 2, 3, 1)
        pp.init_noise_override = noise
    return jax_i2i.process_img2img(jm, jp), port_i2i.process_img2img(pm, pp), pp


def _assert_same_result(ref, out):
    ref_imgs = [np.asarray(im) for im in ref.images]
    assert len(out.images) == len(ref_imgs)
    for a, b in zip(out.images, ref_imgs):
        assert a.shape == b.shape and a.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert out.index_of_first_image == ref.index_of_first_image
    assert out.infotexts == ref.infotexts


@pytest.mark.parametrize("case", list(I2I_CASES))
def test_img2img_cases_match_jax(models, f32_policies, case):  # noqa: F811
    """Every image (the grid, the outputs and the returned masks) within 1
    uint8 level and identical infotext strings."""
    ref, out, pp = _run_pair(models, I2I_CASES[case])
    _assert_same_result(ref, out)
    final = out.images[out.index_of_first_image]
    size = np.asarray(pp.init_images[0]).shape[:2]
    if pp.inpaint_full_res and pp.mask is not None:
        assert final.shape[:2] == size       # pasted back into the original
        keep = port_masking.blur_mask(pp.mask, pp.mask_blur) == 0
        np.testing.assert_array_equal(final[keep], _init_image(size=size[0])[keep])
    if case == "return_masks":
        assert len(out.images) == 4 and out.images[-1].shape == (64, 64, 4)
    if case.startswith("tiling"):
        assert "Tiling: True" in out.infotexts[-1]


def test_save_init_img_matches_jax(models, f32_policies, tmp_path):  # noqa: F811
    """The flattened init image under its md5, the hash in the infotext."""
    settings = {"sdtpu_vae_bf16": False, "save_init_img": True}
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jp = _pair(init_images=[_init_image(channels=4)],
               override_settings=dict(settings, outdir_init_images=str(jax_dir)))[0]
    pp = _pair(init_images=[_init_image(channels=4)],
               override_settings=dict(settings, outdir_init_images=str(port_dir)))[1]
    ref = jax_i2i.process_img2img(models[0], jp)
    out = port_i2i.process_img2img(models[1], pp)
    _assert_same_result(ref, out)
    (name,) = os.listdir(port_dir)
    assert os.listdir(jax_dir) == [name] and f"Init image hash: {name[:-4]}" in out.infotexts[0]
    saved = decode_png((port_dir / name).read_bytes())[0]
    np.testing.assert_array_equal(saved, np.asarray(Image.open(jax_dir / name).convert("RGB")))


def test_live_preview_fast_interrupt_matches_jax(models, monkeypatch):
    """An interrupted job decodes its finals with the preview method: the
    cheap matrix when no Approx NN file is there, as in JAX."""
    from sdwebui_tpu.runtime.state import state as jax_state

    jm, pm = models
    latents = np.random.default_rng(43).standard_normal((1, 4, 8, 8)).astype(np.float32)
    settings = {"live_preview_fast_interrupt": True, "show_progress_type": "Approx cheap"}
    monkeypatch.setattr(jax_state, "interrupted", True)
    from sdwebui_tpu.utils.options import opts as jax_opts
    from sdwebui_tpu_torch.utils.options import opts as port_opts

    with jax_opts.override(settings), port_opts.override(settings):
        ref = np.asarray(jax_proc.decode_first_stage_u8(jm, jnp.asarray(
            latents.transpose(0, 2, 3, 1))))
        out = port_proc.decode_first_stage_u8(pm, torch.from_numpy(latents), interrupted=True)
        full = port_proc.decode_first_stage_u8(pm, torch.from_numpy(latents))
    assert out.shape == ref.shape == (1, 8, 8, 3)
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    assert full.shape == (1, 64, 64, 3)


def test_img2img_refiner_and_edit_soft_inpainting_raise(models):
    """What JAX's img2img does not run: a refiner, and soft inpainting
    under instruct-pix2pix's 3-way CFG (its edit denoiser drops it)."""
    pm = models[1]
    _, pp = _pair(init_images=[_init_image()], steps=1, refiner_checkpoint="refiner",
                  refiner_switch_at=0.8)
    with pytest.raises(NotImplementedError, match="refiner_checkpoint"):
        port_i2i.process_img2img(pm, pp)
    eight = dataclasses.replace(pm, unet_cfg=dataclasses.replace(pm.unet_cfg, in_channels=8))
    _, pp = _pair(**dict(_MASKED, steps=2, inpainting_fill=1, inpaint_full_res=False,
                         soft_inpainting=True, image_cfg_scale=1.5))
    with pytest.raises(NotImplementedError, match="soft inpainting"):
        port_i2i.process_img2img(eight, pp)


# --------------------------------------------------------------------------
# the routes
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def server(tmp_path_factory):
    from sdwebui_tpu_torch.server.api import make_server
    from sdwebui_tpu_torch.server.app import Engine

    styles = tmp_path_factory.mktemp("styles") / "styles.csv"
    styles.write_text("name,prompt,negative_prompt\n"
                      "painterly,\"{prompt}, oil painting, brush strokes\",photo\n"
                      "plain,\"high detail\",\n", encoding="utf-8")
    engine = Engine(device="cpu", tiny=True, seed=3, styles_path=str(styles))
    srv = make_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", engine, styles
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)


def _call(url, method="GET", body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _b64png(img) -> str:
    return base64.b64encode(encode_png(img)).decode("ascii")


def test_img2img_route_default_inpaint(server):
    """A mask with the reference API's defaults (inpainting_fill 0,
    inpaint_full_res True) and padding 32: an inpainted PNG of the init
    image's size, the init image outside the blurred mask; with
    return_mask(_composite) the mask and the RGBA composite follow."""
    url, _, _ = server
    init = _init_image(seed=21, size=96)
    mask = _blob_mask(96)
    body = {"prompt": "a cat", "seed": 4, "steps": 3, "width": 64, "height": 64,
            "init_images": [_b64png(init)], "mask": _b64png(mask),
            "inpaint_full_res_padding": 32, "denoising_strength": 0.8}
    status, res = _call(url + "/sdapi/v1/img2img", "POST", body)
    assert status == 200, res
    (b64,) = res["images"]
    img, text = decode_png(base64.b64decode(b64))
    assert img.shape == (96, 96, 3) and "Denoising strength: 0.8" in text["parameters"]
    keep = port_masking.blur_mask(mask, 4) == 0
    np.testing.assert_array_equal(img[keep], init[keep])
    assert not np.array_equal(img[mask > 0], init[mask > 0])
    status, res = _call(url + "/sdapi/v1/img2img", "POST", dict(body, override_settings={
        "return_mask": True, "return_mask_composite": True}))
    assert status == 200, res
    shapes = [decode_png(base64.b64decode(b))[0].shape for b in res["images"]]
    assert shapes == [(96, 96, 3), (64, 64, 3), (64, 64, 4)]


def test_prompt_style_routes(server):
    url, engine, path = server
    status, styles = _call(url + "/sdapi/v1/prompt-styles")
    assert status == 200 and [s["name"] for s in styles] == ["painterly", "plain"]
    assert styles[0] == {"name": "painterly", "prompt": "{prompt}, oil painting, brush strokes",
                         "negative_prompt": "photo"}
    status, res = _call(url + "/sdapi/v1/prompt-styles", "POST",
                        {"name": "noir", "prompt": "black and white", "negative_prompt": ""})
    assert status == 200 and res == {"name": "noir", "count": 3}
    assert "noir,black and white," in path.read_text(encoding="utf-8-sig")
    status, res = _call(url + "/sdapi/v1/prompt-styles", "DELETE", {"name": "noir"})
    assert status == 200 and res == {"name": "noir", "count": 2}
    assert _call(url + "/sdapi/v1/prompt-styles", "DELETE", {"name": "noir"})[0] == 404
    assert _call(url + "/sdapi/v1/prompt-styles", "POST", {"name": " "})[0] == 400
    assert [s["name"] for s in _call(url + "/sdapi/v1/prompt-styles")[1]] == \
        ["painterly", "plain"]


@pytest.mark.parametrize("route", ["txt2img", "img2img"])
def test_styles_on_both_routes_match_jax(server, route):
    """The style database merges as JAX's Engine.apply_styles does, and the
    infotext carries the merged prompts."""
    from sdwebui_tpu.text.styles import StyleDatabase as JaxStyles

    url, _, path = server
    body = {"prompt": "a cat", "negative_prompt": "blurry", "seed": 5, "steps": 2,
            "width": 64, "height": 64, "styles": ["painterly", "plain", "missing"]}
    if route == "img2img":
        body["init_images"] = [_b64png(_init_image(seed=22))]
    status, res = _call(f"{url}/sdapi/v1/{route}", "POST", body)
    assert status == 200, res
    prompt, negative = JaxStyles(str(path)).apply("a cat", "blurry", body["styles"])
    text = decode_png(base64.b64decode(res["images"][0]))[1]["parameters"]
    assert text.startswith(f"{prompt}\nNegative prompt: {negative}\n")
    assert prompt == "a cat, oil painting, brush strokes, high detail"
    assert json.loads(res["info"])["prompt"] == prompt
