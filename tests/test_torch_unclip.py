"""SD2.1-unclip in the port against the JAX package (CPU, f32).

The open_clip ViT (its converter's config, the forward to 1e-4, the
CLIP preprocessing), ``unclip_adm`` (zeros for txt2img, the noised
embedding of an init image) to 1e-5, and tiny unclip txt2img and img2img
requests within 1 uint8 level of JAX's with the same infotext.  The model
is the JAX test suite's tiny unclip checkpoint (``tests/test_unclip.py``:
an SD2 UNet with a 64-wide adm, the open_clip text tower, a tiny ViT and
the noise augmentor's statistics), read by both packages' loaders from
one ``.safetensors``, and carried across with ``from_jax``.
"""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdwebui_tpu.loader import load as jax_load
from sdwebui_tpu.models import clip_vision as jax_cv
from sdwebui_tpu.pipeline import img2img as jax_i2i
from sdwebui_tpu.pipeline import processing as jax_proc
from sdwebui_tpu.pipeline import sd_model as jax_sd
from sdwebui_tpu.pipeline.params import GenerationParams as JaxParams
from sdwebui_tpu.utils import devices as jax_devices
from sdwebui_tpu_torch.loader import load, safetensors_io
from sdwebui_tpu_torch.models import clip_vision
from sdwebui_tpu_torch.pipeline import img2img as port_i2i
from sdwebui_tpu_torch.pipeline import processing as port_proc
from sdwebui_tpu_torch.pipeline import sd_model as port_sd
from sdwebui_tpu_torch.pipeline.params import GenerationParams
from sdwebui_tpu_torch.utils import devices as port_devices
from test_torch_img2img import _init_image
from test_torch_models import _assert_rel, _perturbed
from test_unclip import VIS_PROJ, _openclip_visual_sd, _tiny_unclip_state_dict


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def f32_policies():
    jax_prev, port_prev = jax_devices.get_policy(), port_devices.get_policy()
    jax_devices.set_policy(jax_devices.DtypePolicy(jnp.float32, jnp.float32,
                                                   jnp.float32, jnp.float32))
    port_devices.set_policy(port_devices.FP32_POLICY)
    yield
    jax_devices.set_policy(jax_prev)
    port_devices.set_policy(port_prev)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The JAX suite's tiny unclip checkpoint with its biases and norm gains
    jittered (see test_torch_models._perturbed: exactly zero-mean
    layer-normed outputs make emphasis divide rounding noise)."""
    path = str(tmp_path_factory.mktemp("unclip") / "tiny-unclip.safetensors")
    rng = np.random.default_rng(77)
    sd = {}
    for k, v in _tiny_unclip_state_dict().items():
        v = np.asarray(v, np.float32)
        if v.ndim == 1:
            v = v + rng.normal(0, 0.1, v.shape).astype(np.float32)
        sd[k] = torch.from_numpy(np.ascontiguousarray(v))
    safetensors_io.write_safetensors(path, sd)
    return path


@pytest.fixture(scope="module")
def models(checkpoint):
    """(JAX model, the port's from its file, the port's from_jax of JAX's)."""
    prev = jax_devices.get_policy(), port_devices.get_policy()
    jax_devices.set_policy(jax_devices.DtypePolicy(jnp.float32, jnp.float32,
                                                   jnp.float32, jnp.float32))
    port_devices.set_policy(port_devices.FP32_POLICY)
    try:
        jm = jax_load.load_model(checkpoint)
        pm = load.load_model(checkpoint, device="cpu")
    finally:
        jax_devices.set_policy(prev[0])
        port_devices.set_policy(prev[1])
    return jm, pm, port_sd.from_jax(jm)


def test_convert_openclip_vision_config_equals_jax():
    oc, _ = _openclip_visual_sd(np.random.default_rng(0))
    flat, cfg = clip_vision.convert_openclip_vision(
        {k: torch.from_numpy(v) for k, v in oc.items()})
    _, jcfg = jax_cv.convert_openclip_vision(oc)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    back = clip_vision.openclip_vision_state_dict(
        clip_vision.clip_vision_from_jax(jax_cv.convert_openclip_vision(oc)[0], jcfg))
    assert set(back) == set(oc)
    for k, v in oc.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("normalize", [True, False])
def test_vit_forward_matches_jax(normalize):
    rng = np.random.default_rng(3)
    oc, _ = _openclip_visual_sd(rng)
    tree, cfg = jax_cv.convert_openclip_vision(oc)
    tree = _perturbed(tree, rng)
    port = clip_vision.clip_vision_from_jax(tree, cfg)
    pixels = rng.standard_normal((2, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    ref = np.asarray(jax_cv.apply(tree, cfg, jnp.asarray(pixels), normalize=normalize))
    with torch.no_grad():
        out = port(torch.from_numpy(pixels.transpose(0, 3, 1, 2).copy()), normalize).numpy()
    _assert_rel(out, ref, 1e-4)


@pytest.mark.parametrize("size", [(48, 48), (70, 33), (30, 90)])
def test_preprocess_matches_jax(size):
    from PIL import Image

    img = np.random.default_rng(size[0]).integers(0, 256, (size[1], size[0], 3), np.uint8)
    np.testing.assert_allclose(clip_vision.preprocess(img, 32),
                               jax_cv.preprocess(Image.fromarray(img), 32).transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-6)


def test_from_jax_consumes_every_key(models):
    from sdwebui_tpu.utils.pytree import flatten

    jm, pm, pj = models
    assert pj.is_unclip and pm.is_unclip and pm.kind == "sd2"
    assert set(pj.image_embedder.state_dict()) == set(flatten(jm.image_embedder_params))
    assert pm.image_embedder.cfg == pj.image_embedder.cfg
    for k, v in pm.image_embedder.state_dict().items():
        torch.testing.assert_close(v, pj.image_embedder.state_dict()[k], rtol=0, atol=0)
    for k in ("mean", "std"):
        np.testing.assert_array_equal(pm.noise_aug_stats[k].numpy(),
                                      np.asarray(jm.noise_aug_stats[k]))


@pytest.mark.parametrize("seed,level", [(3, 0), (8, 0), (3, 200)])
def test_unclip_adm_matches_jax(models, seed, level):
    from PIL import Image

    jm, pm, _ = models
    img = _init_image(seed=seed + 50, size=48)
    ref = np.asarray(jax_sd.unclip_adm(jm, images=[Image.fromarray(img)], noise_level=level,
                                       seed=seed))
    out = port_sd.unclip_adm(pm, images=[img], noise_level=level, seed=seed).numpy()
    assert out.shape == (2 * VIS_PROJ,)
    _assert_rel(out, ref, 1e-5)
    assert not port_sd.unclip_adm(pm).any() and port_sd.unclip_adm(pm).shape == out.shape


def _pair(**kw):
    base = dict(prompt="a (red:1.2) cat", negative_prompt="blurry", seed=19, steps=4,
                width=64, height=64, cfg_scale=6.0, sampler_name="DPM++ 2M",
                scheduler="Karras", override_settings={"sdtpu_vae_bf16": False})
    base.update(kw)
    return JaxParams(**base), GenerationParams(**base)


def _assert_same(ref, out):
    ref_imgs = [np.asarray(im) for im in ref.images]
    assert len(out.images) == len(ref_imgs) >= 1
    for a, b in zip(out.images, ref_imgs):
        assert a.shape == b.shape and a.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert out.infotexts == ref.infotexts


@pytest.mark.parametrize("which", ["file", "from_jax"])
def test_unclip_txt2img_matches_jax(models, f32_policies, which):
    jm, pm, pj = models
    jp, pp = _pair()
    _assert_same(jax_proc.process_txt2img(jm, jp),
                 port_proc.process_txt2img(pm if which == "file" else pj, pp))


@pytest.mark.parametrize("seed", [61, 62])
def test_unclip_img2img_matches_jax(models, f32_policies, seed):
    """The init image reaches the UNet through the adm vector too: two
    init images give two images, each JAX's."""
    jm, pm, _ = models
    jp, pp = _pair(init_images=[_init_image(seed=seed)], denoising_strength=0.7)
    _assert_same(jax_i2i.process_img2img(jm, jp), port_i2i.process_img2img(pm, pp))


def test_unclip_hires_refused(models):
    with pytest.raises(NotImplementedError, match="unclip"):
        port_proc.process_txt2img(models[1], _pair(enable_hr=True, hr_scale=2)[1])
