"""TAESD, the VAE-approx net, the cheap preview matrix and tiling in the port
against the JAX package (CPU, f32).

The nets run on JAX's trees through ``taesd_from_jax`` /
``vae_approx_from_jax`` (relative 1e-4 of the reference's largest
magnitude); the published file layouts (``.safetensors`` with bare
indices, ``.pth`` with ``decoder.`` / ``encoder.`` keys) load in both
packages to the same weights; discovery under a models root finds them
and logs a missing file.  Then the pipelines with
``sd_vae_encode_method`` / ``sd_vae_decode_method`` "TAESD" (JAX's
``_TAESD_CACHE`` filled by monkeypatching, the port's files in
``tmp_path``) and with ``tiling``, against JAX's within 1 uint8 level and
with identical infotext; the tiled UNet and VAE decode at 1e-4.
"""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)
import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdwebui_tpu.models import unet as jax_unet
from sdwebui_tpu.models import vae as jax_vae
from sdwebui_tpu.models import vae_approx as jax_va
from sdwebui_tpu.pipeline import img2img as jax_i2i
from sdwebui_tpu.pipeline import processing as jax_proc
from sdwebui_tpu.pipeline.params import GenerationParams as JaxParams
from sdwebui_tpu.utils.pytree import unflatten
from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
from sdwebui_tpu_torch.models import vae_approx as port_va
from sdwebui_tpu_torch.pipeline import img2img as port_i2i
from sdwebui_tpu_torch.pipeline import processing as port_proc
from sdwebui_tpu_torch.pipeline.params import GenerationParams
from test_torch_img2img import (_init_image, _pair, _rect_mask, f32_policies,  # noqa: F401
                                models)
from test_torch_models import _assert_rel


def _jax_tree(sd: dict) -> dict:
    """A torch state dict in the JAX package's layout (conv HWIO)."""
    from sdwebui_tpu.loader.convert import convert_leaf

    return unflatten({k: convert_leaf(k, v.detach().numpy()) for k, v in sd.items()})


def _seeded_taesd(which: str, latent_channels: int = 4, seed: int = 0):
    """A TAESD net at the published widths with random biases too."""
    net = port_va.random_taesd(which, latent_channels, seed=seed)
    g = torch.Generator().manual_seed(seed + 50)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return net


def _seeded_vae_approx(seed: int = 0, first_in: int = 4):
    layers = ((first_in, 8, 7),) + port_va.VAE_APPROX_LAYERS[1:]
    net = port_va.VAEApprox(layers, device="cpu")
    from sdwebui_tpu_torch.models.layers import reset_random

    reset_random(net, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 50)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return net


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("latent_channels", [4, 16])
def test_taesd_decode_matches_jax(latent_channels):
    tree = _jax_tree(_seeded_taesd("decoder", latent_channels, 1).state_dict())
    net = port_va.taesd_from_jax(tree)
    x = np.random.default_rng(60).standard_normal((2, 8, 10, latent_channels)).astype(np.float32)
    ref = np.asarray(jax_va.taesd_decode(tree, jnp.asarray(x)))
    with torch.inference_mode():
        out = port_va.taesd_decode(net, _nchw(x)).permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape == (2, 64, 80, 3)
    _assert_rel(out, ref, 1e-4)


@pytest.mark.parametrize("latent_channels", [4, 16])
def test_taesd_encode_matches_jax(latent_channels):
    tree = _jax_tree(_seeded_taesd("encoder", latent_channels, 2).state_dict())
    net = port_va.taesd_from_jax(tree)
    x = np.random.default_rng(61).random((2, 64, 48, 3)).astype(np.float32)
    ref = np.asarray(jax_va.taesd_encode(tree, jnp.asarray(x)))
    with torch.inference_mode():
        out = port_va.taesd_encode(net, _nchw(x)).permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape == (2, 8, 6, latent_channels)
    _assert_rel(out, ref, 1e-4)


@pytest.mark.parametrize("first_in", [4, 16])
def test_vae_approx_matches_jax(first_in):
    tree = _jax_tree(_seeded_vae_approx(3, first_in).state_dict())
    net = port_va.vae_approx_from_jax(tree)
    x = np.random.default_rng(62).standard_normal((2, 8, 8, first_in)).astype(np.float32)
    ref = np.asarray(jax_va.vae_approx_decode(tree, jnp.asarray(x)))
    with torch.inference_mode():
        out = net(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape == (2, 16, 16, 3)
    _assert_rel(out, ref, 1e-4)


@pytest.mark.parametrize("kind,channels", [("sd1", 4), ("sdxl", 4), ("sd3", 16)])
def test_cheap_approximation_matches_jax(kind, channels):
    x = np.random.default_rng(63).standard_normal((2, 8, 8, channels)).astype(np.float32)
    ref = np.asarray(jax_va.cheap_approximation(jnp.asarray(x), kind))
    out = port_va.cheap_approximation(_nchw(x), kind).permute(0, 2, 3, 1).numpy()
    _assert_rel(out, ref, 1e-6)


def test_published_layouts_load_in_both_packages(tmp_path):
    """A bare-index .safetensors decoder and a .pth encoder whose keys carry
    ``encoder.``: the port's nets hold the file's tensors, and JAX's
    loader reads the same weights (transposed to its layout)."""
    dec = _seeded_taesd("decoder", 4, 4).state_dict()
    enc = _seeded_taesd("encoder", 4, 5).state_dict()
    write_safetensors(str(tmp_path / "taesd_decoder.safetensors"), dec)
    torch.save({"encoder." + k: v for k, v in enc.items()}, tmp_path / "taesd_encoder.pth")
    approx = _seeded_vae_approx(6).state_dict()
    torch.save(approx, tmp_path / "model.pt")
    for path, ref in ((tmp_path / "taesd_decoder.safetensors", dec),
                      (tmp_path / "taesd_encoder.pth", enc)):
        net = port_va.load_taesd(str(path))
        for k, v in net.state_dict().items():
            torch.testing.assert_close(v, ref[k], rtol=0, atol=0)
        jax_tree = jax_va.load_taesd(str(path))
        for k, v in port_va._tree_state_dict(jax_tree).items():
            torch.testing.assert_close(v, ref[k], rtol=0, atol=0)
    net = port_va.load_vae_approx(str(tmp_path / "model.pt"))
    for k, v in net.state_dict().items():
        torch.testing.assert_close(v, approx[k], rtol=0, atol=0)


def test_discovery_under_a_models_root(tmp_path, caplog):
    """get_taesd / get_vae_approx find the files where JAX looks for them
    (VAE-taesd/taesd{,xl}_{encoder,decoder}, VAE-approx/model.pt), cache
    them, and give None with one logged warning when a file is absent."""
    (tmp_path / "VAE-taesd").mkdir()
    (tmp_path / "VAE-approx").mkdir()
    write_safetensors(str(tmp_path / "VAE-taesd" / "taesdxl_decoder.safetensors"),
                      _seeded_taesd("decoder", 4, 7).state_dict())
    torch.save(_seeded_vae_approx(8).state_dict(), tmp_path / "VAE-approx" / "model.pt")
    prev = port_va.models_root()
    port_va.set_models_root(str(tmp_path))
    try:
        assert port_va.get_taesd("sdxl", "decoder") is port_va.get_taesd("sdxl", "decoder")
        assert port_va.get_vae_approx("sd1") is not None
        with caplog.at_level(logging.WARNING, logger="sdwebui_tpu_torch"):
            assert port_va.get_taesd("sd1", "encoder") is None
            assert port_va.get_taesd("sd1", "encoder") is None
        assert sum("taesd_encoder" in r.getMessage() for r in caplog.records) == 1
        latent = torch.from_numpy(np.random.default_rng(64).standard_normal(
            (1, 4, 8, 8)).astype(np.float32))
        with torch.inference_mode():
            assert port_va.approx_decode("sdxl", "TAESD", latent).shape == (1, 3, 64, 64)
            assert port_va.approx_decode("sd1", "Approx NN", latent).shape == (1, 3, 16, 16)
            assert port_va.approx_decode("sd1", "TAESD", latent).shape == (1, 3, 8, 8)
    finally:
        port_va.set_models_root(prev)


# --------------------------------------------------------------------------
# the pipelines with TAESD
# --------------------------------------------------------------------------

@pytest.fixture
def taesd_files(tmp_path, monkeypatch):
    """sd1 TAESD files for both packages: the port's under tmp_path, JAX's
    trees in its cache under the key its pipeline looks up."""
    root = tmp_path / "models"
    (root / "VAE-taesd").mkdir(parents=True)
    for i, which in enumerate(("encoder", "decoder")):
        sd = _seeded_taesd(which, 4, 10 + i).state_dict()
        write_safetensors(str(root / "VAE-taesd" / f"taesd_{which}.safetensors"), sd)
        monkeypatch.setitem(jax_va._TAESD_CACHE, ("sd1", which, "models"), _jax_tree(sd))
    prev = port_va.models_root()
    port_va.set_models_root(str(root))
    yield
    port_va.set_models_root(prev)


TAESD_SETTINGS = {"sdtpu_vae_bf16": False, "sd_vae_encode_method": "TAESD",
                  "sd_vae_decode_method": "TAESD"}


@pytest.mark.parametrize("case", ["img2img", "inpaint"])
def test_img2img_with_taesd_matches_jax(models, f32_policies, taesd_files, case):  # noqa: F811
    kw = dict(init_images=[_init_image()], override_settings=TAESD_SETTINGS)
    if case == "inpaint":
        kw.update(mask=_rect_mask(), mask_blur=4, inpainting_fill=1, inpaint_full_res=False)
    jp, pp = _pair(**kw)
    ref = jax_i2i.process_img2img(models[0], jp)
    out = port_i2i.process_img2img(models[1], pp)
    a, b = out.images[0], np.asarray(ref.images[0])
    assert a.shape == b.shape == (64, 64, 3)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert out.infotexts == ref.infotexts


def test_txt2img_with_taesd_decode_matches_jax(models, f32_policies, taesd_files):  # noqa: F811
    base = dict(prompt="a cat", seed=5, steps=3, width=64, height=64,
                override_settings=TAESD_SETTINGS)
    ref = jax_proc.process_txt2img(models[0], JaxParams(**base))
    out = port_proc.process_txt2img(models[1], GenerationParams(**base))
    full = port_proc.process_txt2img(models[1], GenerationParams(
        **dict(base, override_settings={"sdtpu_vae_bf16": False})))
    assert np.abs(out.images[0].astype(int) - np.asarray(ref.images[0], int)).max() <= 1
    assert out.infotexts == ref.infotexts
    assert not np.array_equal(out.images[0], full.images[0])


# --------------------------------------------------------------------------
# tiling
# --------------------------------------------------------------------------

def test_tiled_unet_and_vae_decode_match_jax(models):
    """Circular padding on every 3×3 conv of the UNet (stride-2 downsample
    included) and of the VAE decoder: 1e-4."""
    jm, pm = models
    rng = np.random.default_rng(65)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([500.0, 20.0], np.float32)
    ctx = rng.standard_normal((2, 77, pm.unet_cfg.context_dim)).astype(np.float32)
    cfg = dataclasses.replace(jm.unet_cfg, tiling=True)
    ref = np.asarray(jax_unet.apply(jm.unet_params, cfg, jnp.asarray(x), jnp.asarray(t),
                                    jnp.asarray(ctx)))
    plain = np.asarray(jax_unet.apply(jm.unet_params, jm.unet_cfg, jnp.asarray(x),
                                      jnp.asarray(t), jnp.asarray(ctx)))
    with torch.inference_mode():
        out = pm.unet(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx),
                      tiling=True).permute(0, 2, 3, 1).numpy()
        img = pm.vae.decode(_nchw(x), tiling=True).permute(0, 2, 3, 1).numpy()
    _assert_rel(out, ref, 1e-4)
    assert np.abs(ref - plain).max() > 1e-3 * np.abs(ref).max()
    vcfg = dataclasses.replace(jm.vae_cfg, tiling=True)
    _assert_rel(img, np.asarray(jax_vae.decode(jm.vae_params, vcfg, jnp.asarray(x))), 1e-4)


@pytest.mark.parametrize("sampler", ["Euler a", "DPM++ 2M"])
def test_tiling_txt2img_matches_jax(models, f32_policies, sampler):  # noqa: F811
    base = dict(prompt="a (red:1.2) brick wall", seed=9, steps=4, width=64, height=64,
                sampler_name=sampler, tiling=True, override_settings={"sdtpu_vae_bf16": False})
    ref = jax_proc.process_txt2img(models[0], JaxParams(**base))
    out = port_proc.process_txt2img(models[1], GenerationParams(**base))
    untiled = port_proc.process_txt2img(models[1], GenerationParams(**dict(base, tiling=False)))
    assert np.abs(out.images[0].astype(int) - np.asarray(ref.images[0], int)).max() <= 1
    assert out.infotexts == ref.infotexts and "Tiling: True" in out.infotexts[0]
    assert not np.array_equal(out.images[0], untiled.images[0])
