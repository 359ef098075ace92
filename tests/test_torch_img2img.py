"""The img2img + inpaint slice of the port vs the JAX package (CPU, f32).

Pillow's operations on this path (luma, binarize, GaussianBlur, the bicubic
mask resize, composite, RGBA flattening) are restated in numpy in the port,
so each is held against Pillow here; the PNG reader is held against PNGs
that Pillow writes.  Then the VAE encoder, the latent mask blend and the
whole ``process_img2img`` against the JAX package on identical weights
(the tiny model of ``from_jax``, perturbed as in test_torch_models), and
the ``/sdapi/v1/img2img`` route.  Tolerances are stated per test.
"""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
import base64
import dataclasses
import io
import json
import struct
import threading
import urllib.error
import urllib.request
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageFilter

from sdwebui_tpu.pipeline import img2img as jax_i2i
from sdwebui_tpu.pipeline import sd_model as jax_sd
from sdwebui_tpu.pipeline.params import GenerationParams as JaxParams
from sdwebui_tpu.utils import devices as jax_devices
from sdwebui_tpu.utils import images as jax_images
from sdwebui_tpu.utils import masking as jax_masking
from sdwebui_tpu_torch.pipeline import img2img as port_i2i
from sdwebui_tpu_torch.pipeline import sd_model as port_sd
from sdwebui_tpu_torch.pipeline.params import GenerationParams
from sdwebui_tpu_torch.utils import devices as port_devices
from sdwebui_tpu_torch.utils import images as port_images
from sdwebui_tpu_torch.utils import masking as port_masking
from sdwebui_tpu_torch.utils.png import decode_png, encode_png
from test_torch_models import _assert_rel, _perturbed


def _rect_mask(size=64, lo=16, hi=48):
    m = np.zeros((size, size), np.uint8)
    m[lo:hi, lo:hi] = 255
    return m


def _masks():
    rng = np.random.default_rng(3)
    blob = (rng.random((96, 80)) > 0.6).astype(np.uint8) * 255
    return [_rect_mask(), _rect_mask(512, 128, 384), blob,
            rng.integers(0, 256, (37, 53), dtype=np.uint8)]


# --------------------------------------------------------------------------
# the Pillow operations
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode,channels", [("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4)])
def test_to_l_and_to_rgb_match_pillow(mode, channels):
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, (19, 23, channels), dtype=np.uint8)
    im = Image.fromarray(a[:, :, 0] if channels == 1 else a, mode)
    np.testing.assert_array_equal(port_images.to_l(a), np.asarray(im.convert("L")))
    np.testing.assert_array_equal(port_images.to_rgb(a), np.asarray(im.convert("RGB")))


@pytest.mark.parametrize("invert", [False, True])
def test_binarize_mask_matches_jax(invert):
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (21, 17, 3), dtype=np.uint8)
    for m in (rgb, _masks()[3]):
        ref = np.asarray(jax_masking.binarize_mask(Image.fromarray(m), invert=invert))
        np.testing.assert_array_equal(port_masking.binarize_mask(m, invert=invert), ref)


@pytest.mark.parametrize("radius", [1, 2, 4, 8, 16])
def test_gaussian_blur_matches_pillow(radius):
    """Pillow's extended box blur in its 8-bit arithmetic: within 1 level
    (the port reproduces it exactly on these masks)."""
    for m in _masks():
        ref = np.asarray(Image.fromarray(m).filter(ImageFilter.GaussianBlur(radius)))
        out = port_masking.blur_mask(m, radius)
        assert out.shape == ref.shape and out.dtype == np.uint8
        assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    np.testing.assert_array_equal(port_masking.blur_mask(_masks()[0], 0), _masks()[0])


@pytest.mark.parametrize("src,dst", [((512, 512), (64, 64)), ((64, 64), (8, 8)),
                                     ((80, 96), (13, 10)), ((37, 53), (64, 20)),
                                     ((8, 8), (20, 31))])
def test_resize_bicubic_and_latent_mask_match_pillow_exactly(src, dst):
    """The mask → latent-grid resize must match exactly: with the np.around
    that follows, one flipped latent cell moves a whole 8x8 patch."""
    rng = np.random.default_rng(5)
    blurred = port_masking.blur_mask(
        (rng.random(src[::-1]) > 0.5).astype(np.uint8) * 255, 4)
    for m in (blurred, rng.integers(0, 256, src[::-1], dtype=np.uint8)):
        ref = np.asarray(Image.fromarray(m).resize(dst))
        out = port_images.resize(m, dst)
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(np.around(out.astype(np.float32) / 255.0),
                                      np.around(ref.astype(np.float32) / 255.0))


def test_composite_and_flatten_match_pillow():
    rng = np.random.default_rng(6)
    a = rng.integers(0, 256, (31, 29, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (31, 29, 3), dtype=np.uint8)
    m = port_masking.blur_mask(rng.integers(0, 256, (31, 29), dtype=np.uint8), 2)
    ref = np.asarray(Image.composite(Image.fromarray(a), Image.fromarray(b), Image.fromarray(m)))
    out = port_images.composite(a, b, m)
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    rgba = rng.integers(0, 256, (31, 29, 4), dtype=np.uint8)
    for color in ("#ffffff", "#102030", "#0f8"):
        ref = np.asarray(jax_images.flatten(Image.fromarray(rgba), color))
        np.testing.assert_array_equal(port_images.flatten(rgba, color), ref)
    np.testing.assert_array_equal(port_images.flatten(a, "#000"), a)
    ref = np.asarray(jax_images.flatten(Image.fromarray(rgba), "white"))
    np.testing.assert_array_equal(port_images.flatten(rgba, "white"), ref)
    with pytest.raises(ValueError):
        jax_images.flatten(Image.fromarray(rgba), "#12345")
    with pytest.raises(ValueError, match="color"):
        port_images.flatten(rgba, "#12345")


# --------------------------------------------------------------------------
# PNG reader
# --------------------------------------------------------------------------

def _pil_png(arr, mode, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format="PNG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("mode,channels", [("L", 1), ("RGB", 3), ("LA", 2), ("RGBA", 4),
                                           ("P", 3)])
def test_decode_png_matches_pillow(mode, channels):
    """Colour types 0/2/4/6 and 3 (palette → RGB, as convert("RGB")), as
    Pillow writes them with its adaptive filters, smooth and noisy."""
    rng = np.random.default_rng(7)
    shape = (45, 61, channels)
    smooth = np.cumsum(rng.integers(0, 4, shape), axis=1).astype(np.uint8)
    noisy = rng.integers(0, 256, shape, dtype=np.uint8)
    for arr in (smooth, noisy):
        if mode == "P":
            im = Image.fromarray(arr, "RGB").convert("P", palette=Image.ADAPTIVE, colors=64)
            buf = io.BytesIO()
            im.save(buf, format="PNG")
            data, want = buf.getvalue(), np.asarray(im.convert("RGB"))
        else:
            src = arr[:, :, 0] if channels == 1 else arr
            data, want = _pil_png(src, mode), arr
        out, _ = decode_png(data)
        np.testing.assert_array_equal(out, want.reshape(out.shape))


def _filter_rows(img: np.ndarray, types) -> bytes:
    """The PNG filters written out pixel by pixel: the reference the
    vectorised reader is held to."""
    h, w, bpp = img.shape
    rows = img.reshape(h, w * bpp).astype(int)
    out = bytearray()
    for r in range(h):
        ft = types[r % len(types)]
        out.append(ft)
        for i in range(w * bpp):
            a = rows[r, i - bpp] if i >= bpp else 0
            b = rows[r - 1, i] if r > 0 else 0
            c = rows[r - 1, i - bpp] if r > 0 and i >= bpp else 0
            if ft == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            else:
                pred = (0, a, b, (a + b) // 2)[ft]
            out.append((rows[r, i] - pred) % 256)
    return bytes(out)


def _png(img, ctype, types, interlace=0, depth=8):
    h, w, _ = img.shape

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
            + chunk(b"IDAT", zlib.compress(_filter_rows(img, types)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("types", [(0, 1, 2, 3, 4), (4,), (3,), (1, 2)])
def test_decode_png_every_filter_type(types):
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (17, 13, 4), dtype=np.uint8)
    out, _ = decode_png(_png(img, 6, types))
    np.testing.assert_array_equal(out, img)
    grey = rng.integers(0, 256, (9, 21, 1), dtype=np.uint8)
    np.testing.assert_array_equal(decode_png(_png(grey, 0, types))[0], grey)


def test_decode_png_refuses_what_it_cannot_read():
    """A PNG no reader opens (an unknown interlace method, 16-bit palette
    indices) and bytes that are no PNG raise; the interlaced and 16-bit
    PNGs Pillow opens are read (tests/test_torch_png_variants.py)."""
    img = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(ValueError, match="interlace"):
        decode_png(_png(img, 2, (0,), interlace=2))
    with pytest.raises(ValueError, match="depth 16"):
        decode_png(_png(img, 3, (0,), depth=16))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"\xff\xd8\xff\xe0")
    np.testing.assert_array_equal(decode_png(encode_png(img))[0], img)


# --------------------------------------------------------------------------
# the JAX package on identical weights
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jm = jax_sd.create_tiny_sd(9)
    rng = np.random.default_rng(90)
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


def _init_image(seed=11, size=64, channels=3):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (size // 8, size // 8, channels)).astype(np.uint8)
    return np.kron(base, np.ones((8, 8, 1), np.uint8))   # blocky: structure for the VAE


def test_vae_encode_matches_jax(models):
    """encode_moments + encode_mode, f32: 1e-4 of the largest magnitude."""
    from sdwebui_tpu.models import vae as jax_vae

    jm, pm = models
    rng = np.random.default_rng(12)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    moments = np.asarray(jax_vae.encode_moments(jm.vae_params, jm.vae_cfg, jnp.asarray(x)))
    mode = np.asarray(jax_vae.encode_mode(jnp.asarray(moments), jm.vae_cfg))
    noise = rng.standard_normal(mode.shape).astype(np.float32)
    sample = np.asarray(jax_vae.sample_latent(jnp.asarray(moments), jnp.asarray(noise),
                                              jm.vae_cfg))
    with torch.inference_mode():
        m = pm.vae.encode_moments(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
        z = pm.vae.encode_mode(m)
        s = pm.vae.sample_latent(m, torch.from_numpy(noise.transpose(0, 3, 1, 2).copy()))
    _assert_rel(m.permute(0, 2, 3, 1).numpy(), moments, 1e-4)
    _assert_rel(z.permute(0, 2, 3, 1).numpy(), mode, 1e-4)
    _assert_rel(s.permute(0, 2, 3, 1).numpy(), sample, 1e-4)


@pytest.mark.parametrize("before", [False, True])
def test_cfg_mask_blend_matches_jax(before):
    """The latent blend around a toy denoiser (cfg.py:145-146,195-197):
    1e-6 of the largest magnitude."""
    from sdwebui_tpu.sampling.cfg import CondSchedule as JaxSched
    from sdwebui_tpu.sampling.cfg import make_cfg_denoiser as jax_cfg
    from sdwebui_tpu_torch.sampling.cfg import CondSchedule, make_cfg_denoiser

    rng = np.random.default_rng(13)
    b, c, h, w, s, d = 2, 4, 8, 8, 5, 6
    x = rng.standard_normal((b, c, h, w), dtype=np.float32)
    init = rng.standard_normal((b, c, h, w), dtype=np.float32)
    nmask = np.around(rng.random((1, 1, h, w))).astype(np.float32)
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
                  init_latent=nhwc(init), mask_before_denoising=before)(nhwc(x), 1.0, 0)
    ps = CondSchedule(cond_bank=torch.from_numpy(bank), uncond_bank=torch.from_numpy(ubank),
                      **sched)
    nm = torch.from_numpy(nmask)
    out = make_cfg_denoiser(port_denoise, ps, mask=1.0 - nm, nmask=nm,
                            init_latent=torch.from_numpy(init),
                            mask_before_denoising=before)(torch.from_numpy(x), 1.0, 0)
    _assert_rel(out.numpy(), np.asarray(ref).transpose(0, 3, 1, 2), 1e-6)


def test_setup_img2img_steps_matches_jax():
    for args in ((20, 0.75), (20, 1.0), (10, 0.5, True), (7, 0.3), (50, 0.01)):
        assert port_i2i.setup_img2img_steps(*args) == jax_i2i.setup_img2img_steps(*args)


def _pair(**kw):
    base = dict(prompt="a (red:1.2) cat [in the snow:on a hill:0.5]", negative_prompt="blurry",
                seed=17, steps=5, width=64, height=64, batch_size=1, cfg_scale=7.5,
                denoising_strength=0.75, override_settings={"sdtpu_vae_bf16": False})
    base.update(kw)
    return JaxParams(**base), GenerationParams(**base)


I2I_CASES = {
    "img2img": dict(init_images=[_init_image()]),
    "img2img_rgba_batch2": dict(init_images=[_init_image(channels=4)], batch_size=2,
                                override_settings={"sdtpu_vae_bf16": False,
                                                   "img2img_background_color": "#204060"}),
    "inpaint_blur0_fill1": dict(init_images=[_init_image()], mask=_rect_mask(), mask_blur=0,
                                inpainting_fill=1),
    "inpaint_blur4_fill1": dict(init_images=[_init_image()], mask=_rect_mask(), mask_blur=4,
                                inpainting_fill=1),
    "inpaint_fill2": dict(init_images=[_init_image()], mask=_rect_mask(), mask_blur=4,
                          inpainting_fill=2),
    "inpaint_fill3": dict(init_images=[_init_image()], mask=_rect_mask(), mask_blur=4,
                          inpainting_fill=3),
    "inpaint_invert": dict(init_images=[_init_image()], mask=_rect_mask(), mask_blur=4,
                           inpainting_fill=1, inpainting_mask_invert=1,
                           sampler_name="DPM++ 2M", scheduler="Karras"),
}


@pytest.mark.parametrize("case", list(I2I_CASES))
def test_img2img_matches_jax(models, f32_policies, case):
    """Final pixels within 1 uint8 level and identical infotext strings."""
    jm, pm = models
    jp, pp = _pair(**I2I_CASES[case])
    ref = jax_i2i.process_img2img(jm, jp)
    out = port_i2i.process_img2img(pm, pp)
    ref_imgs = [np.asarray(im) for im in ref.images[ref.index_of_first_image:]]
    out_imgs = out.images[out.index_of_first_image:]
    assert len(out_imgs) == len(ref_imgs) == pp.batch_size
    for a, b in zip(out_imgs, ref_imgs):
        assert a.shape == b.shape == (64, 64, 3) and a.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert out.infotexts[out.index_of_first_image:] == ref.infotexts[ref.index_of_first_image:]
    assert "Denoising strength: " in out.infotexts[-1]
    if "mask" in I2I_CASES[case] and not pp.inpainting_mask_invert:
        # outside the blurred mask the init image comes back as it was
        keep = port_masking.blur_mask(_rect_mask(), pp.mask_blur) == 0
        np.testing.assert_array_equal(out_imgs[0][keep], _init_image()[keep])


@pytest.mark.parametrize("kw,name", [
    (dict(refiner_checkpoint="refiner", refiner_switch_at=0.8), "refiner_checkpoint"),
])
def test_unported_img2img_requests_raise(models, kw, name):
    _, pp = _pair(**{"init_images": [_init_image()], "steps": 1, **kw})
    with pytest.raises(NotImplementedError, match=name):
        port_i2i.process_img2img(models[1], pp)


def test_img2img_rejects_sdxl_and_other_unet_inputs(models):
    """SDXL img2img runs now (tests/test_torch_sdxl_img2img.py); an
    inpainting model's other mask weights and unknown layouts still raise."""
    _, pp = _pair(init_images=[_init_image()], steps=1)
    pm = models[1]
    nine = dataclasses.replace(pm, unet_cfg=dataclasses.replace(pm.unet_cfg, in_channels=9))
    _, weighted = _pair(init_images=[_init_image()], steps=1,
                        override_settings={"inpainting_mask_weight": 0.5})
    with pytest.raises(NotImplementedError, match="inpainting_mask_weight"):
        port_i2i.process_img2img(nine, weighted)
    six = dataclasses.replace(pm, unet_cfg=dataclasses.replace(pm.unet_cfg, in_channels=6))
    with pytest.raises(ValueError, match="6-channel"):
        port_i2i.process_img2img(six, pp)


# --------------------------------------------------------------------------
# /sdapi/v1/img2img
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def server_url():
    from sdwebui_tpu_torch.server.api import make_server
    from sdwebui_tpu_torch.server.app import Engine

    server = make_server(Engine(device="cpu", tiny=True, seed=3), "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}/sdapi/v1/img2img"
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _b64(data: bytes) -> str:
    return base64.b64encode(data).decode("ascii")


def test_img2img_route_inpaints_a_pillow_png(server_url):
    """A client's PIL-encoded RGB init image and L mask: the PNG answer keeps
    the init image outside the mask and names the denoising strength."""
    init = _init_image(seed=21)
    body = {"prompt": "a cat", "seed": 4, "steps": 3, "width": 64, "height": 64,
            "init_images": ["data:image/png;base64," + _b64(_pil_png(init, "RGB",
                                                                     optimize=True))],
            "mask": _b64(_pil_png(_rect_mask(), "L")), "mask_blur": 0,
            "inpainting_fill": 1, "inpaint_full_res": False, "denoising_strength": 0.8}
    status, res = _post(server_url, body)
    assert status == 200, res
    img, text = decode_png(base64.b64decode(res["images"][0]))
    assert img.shape == (64, 64, 3)
    assert "Denoising strength: 0.8" in text["parameters"] and "Seed: 4" in text["parameters"]
    keep = _rect_mask() == 0
    np.testing.assert_array_equal(img[keep], init[keep])
    assert not np.array_equal(img[~keep], init[~keep])
    assert "init_images" not in res["parameters"] and "mask" not in res["parameters"]
    status, res = _post(server_url, {**body, "include_init_images": True})
    assert status == 200 and res["parameters"]["init_images"] == body["init_images"]


@pytest.mark.parametrize("body,status,word", [
    ({}, 404, "Init image"),
    ({"init_images": [_b64(b"\xff\xd8\xff\xe0\x00\x10JFIF")]}, 400, "JPEG"),
    ({"init_images": ["%%%"]}, 400, "base64"),
    ({"init_images": [_b64(_pil_png(_init_image(), "RGB"))], "mask_blur_x": 8}, 422,
     "mask_blur_x"),
    ({"init_images": [_b64(_pil_png(_init_image(), "RGB"))], "mask_blend_power": "x"}, 422,
     "mask_blend_power"),
    ({"init_images": [_b64(_pil_png(_init_image(), "RGB"))], "refiner_checkpoint": "r",
      "refiner_switch_at": 0.8}, 422, "refiner_checkpoint"),
])
def test_img2img_route_errors(server_url, body, status, word):
    code, res = _post(server_url, {"steps": 1, "width": 64, "height": 64, **body})
    assert code == status and word in res["detail"], res
