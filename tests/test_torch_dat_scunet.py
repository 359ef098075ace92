"""DAT and SCUNet in the port against the JAX package: the forward at the
JAX tests' tiny configs (DAT's 1conv/pixelshuffle x2 and 3conv/
pixelshuffledirect x3 variants, SCUNet at one and at two blocks a stage;
f32, max|Δ| <= 1e-4), the tiled ``upscale_image`` (DAT's own tile
options) and ``denoise_image`` on ragged images, the release layouts (DAT's
split size read from its position-bias buffers, SCUNet's flat relative
table), the ``dat_enabled_models`` filter, and both directories through
the registry (SCUNet at 1x, Lanczos after it)."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sdwebui_tpu.models import dat as jax_dat
from sdwebui_tpu.models import scunet as jax_scunet
from sdwebui_tpu.postprocessing import upscalers as jax_upscalers
from sdwebui_tpu.utils.options import opts as jax_opts
from sdwebui_tpu_torch.models import dat, scunet
from sdwebui_tpu_torch.postprocessing import upscalers as port_upscalers
from sdwebui_tpu_torch.utils.options import opts as port_opts
from test_torch_swin_upscalers import (assert_close, assert_images_equal, forward, image,
                                       jittered_state_dict, tiles_input, write_file)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# DAT
# --------------------------------------------------------------------------

DAT_CASES = {   # tests/test_dat.py:21-28
    "1conv_pixelshuffle_x2": dat.DATConfig(
        embed_dim=64, depths=(2, 2), num_heads=(4, 4), split_size=(2, 4),
        expansion_factor=2.0, scale=2, resi_connection="1conv", upsampler="pixelshuffle"),
    "3conv_pixelshuffledirect_x3": dat.DATConfig(
        embed_dim=64, depths=(3,), num_heads=(4,), split_size=(2, 4), expansion_factor=2.0,
        scale=3, resi_connection="3conv", upsampler="pixelshuffledirect"),
}


def dat_pair(case: str, seed: int = 0):
    """(JAX tree, JAX cfg, the port net from the tree, the release state
    dict with its buffers); BatchNorm running variances kept positive."""
    cfg = DAT_CASES[case]
    net = dat.create_random_dat(seed, "cpu", cfg)
    sd = jittered_state_dict(net, seed)
    sd.update({k: np.abs(v) + 0.5 for k, v in sd.items() if k.endswith("running_var")})
    with_buffers = dict(sd, **{k: v.numpy() for k, v in dat.state_dict_with_buffers(net).items()
                               if k not in sd})
    tree, jcfg = jax_dat.convert_dat(with_buffers)
    assert jcfg.split_size == cfg.split_size
    return tree, jcfg, dat.dat_from_jax(tree, cfg.split_size), with_buffers


@pytest.mark.parametrize("case", list(DAT_CASES))
def test_dat_matches_jax(case):
    tree, jcfg, net, _ = dat_pair(case)
    assert net.cfg == dataclasses.replace(DAT_CASES[case], num_feat=jcfg.num_feat)
    x = tiles_input(1)
    assert_close(forward(net, x), jax_dat.apply(tree, jcfg, jnp.asarray(x)))


def test_dat_shifted_blocks_and_constants():
    """The shifted-window pattern and the host constants equal JAX's."""
    assert [dat.is_shifted(r, b) for r in range(2) for b in range(8)] == \
        [jax_dat._is_shifted(r, b) for r in range(2) for b in range(8)]
    for wh, ww in ((2, 4), (8, 32), (32, 8)):
        np.testing.assert_array_equal(dat.rect_rpi(wh, ww), jax_dat.rect_rpi(wh, ww))
        np.testing.assert_array_equal(dat.rect_rpe_biases(wh, ww),
                                      jax_dat.rect_rpe_biases(wh, ww))
    np.testing.assert_array_equal(dat.rect_shift_mask(64, 64, 8, 32, 4, 16),
                                  jax_dat.rect_shift_mask(64, 64, 8, 32, 4, 16))


def test_dat_reads_the_release_layout():
    """params_ema, the position-bias buffers (the split size read back from
    them, (s0, s1) told from (s1, s0)), num_batches_tracked."""
    _, _, ref_net, sd = dat_pair("1conv_pixelshuffle_x2", 2)
    sd = {"params_ema." + k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    sd["params_ema.layers.0.blocks.0.attn.dwconv.1.num_batches_tracked"] = torch.tensor(3)
    net = dat.dat_from_state_dict(sd, "cpu")
    assert net.cfg.split_size == (2, 4)
    x = tiles_input(3)
    np.testing.assert_array_equal(forward(net, x), forward(ref_net, x))
    no_buffers = {k: v for k, v in sd.items() if "rpe_biases" not in k}
    assert dat.dat_from_state_dict(no_buffers, "cpu").cfg.split_size == (8, 32)


def test_dat_upscale_image_reads_its_tile_options():
    """DAT_tile / DAT_tile_overlap (not ESRGAN_tile), a ragged image."""
    tree, jcfg, net, _ = dat_pair("1conv_pixelshuffle_x2", 4)
    img = image(18, 27, 5)
    with port_opts.override({"DAT_tile": 12, "DAT_tile_overlap": 4, "ESRGAN_tile": 0}), \
            jax_opts.override({"DAT_tile": 12, "DAT_tile_overlap": 4, "ESRGAN_tile": 0}):
        out = dat.upscale_image(net, img)
        ref = jax_dat.upscale_image(tree, jcfg, Image.fromarray(img))
    assert out.shape == (36, 54, 3)
    assert_images_equal(out, ref)


def test_dat_enabled_models_filters_the_listing():
    for name in ("DAT x4", "DAT x2", "DAT-light x4"):
        port_upscalers.register_upscaler(name, lambda im, s: im)
        jax_upscalers.register_upscaler(name, lambda im, s: im)
    try:
        for enabled in (None, ["DAT x2"], []):
            over = {} if enabled is None else {"dat_enabled_models": enabled}
            with port_opts.override(over), jax_opts.override(over):
                names = port_upscalers.upscaler_names()
                assert names == [n for n in jax_upscalers.upscaler_names()
                                 if n in port_upscalers._REGISTRY]
                assert ("DAT x4" in names) == (enabled is None)
        assert names[:3] == ["None", "Lanczos", "Nearest"]
        port_upscalers.get_upscaler("DAT x4")      # left out of the listing, still served
    finally:
        for name in ("DAT x4", "DAT x2", "DAT-light x4"):
            port_upscalers.unregister_upscaler(name)
            jax_upscalers._REGISTRY.pop(name, None)


# --------------------------------------------------------------------------
# SCUNet
# --------------------------------------------------------------------------

SCUNET_CASES = {   # tests/test_scunet.py:17
    "one_block_a_stage": scunet.SCUNetConfig(dim=16, config=(1,) * 7, head_dim=4, window_size=4),
    "two_and_one": scunet.SCUNetConfig(dim=16, config=(2, 1, 2, 1, 2, 1, 2), head_dim=4,
                                       window_size=4),
}


def scunet_pair(case: str, seed: int = 0):
    sd = jittered_state_dict(scunet.create_random_scunet(seed, "cpu", SCUNET_CASES[case]), seed)
    tree, jcfg = jax_scunet.convert_scunet(sd)
    return tree, jcfg, scunet.scunet_from_jax(tree), sd


@pytest.mark.parametrize("case", list(SCUNET_CASES))
def test_scunet_matches_jax(case):
    tree, jcfg, net, _ = scunet_pair(case)
    assert net.cfg == SCUNET_CASES[case]
    x = tiles_input(6, 64, 128)
    assert_close(forward(net, x), jax_scunet.apply(tree, jcfg, jnp.asarray(x)))


def test_scunet_reads_a_flat_relative_table():
    """A ((2w−1)², heads) table reshaped to (heads, 2w−1, 2w−1)."""
    _, _, ref_net, sd = scunet_pair("one_block_a_stage", 7)
    flat = {}
    for k, v in sd.items():
        if k.endswith("relative_position_params"):
            v = np.ascontiguousarray(v.transpose(1, 2, 0).reshape(-1, v.shape[0]))
        flat[k] = torch.from_numpy(v)
    net = scunet.scunet_from_state_dict(flat, "cpu")
    x = tiles_input(8, 64, 64)
    np.testing.assert_array_equal(forward(net, x), forward(ref_net, x))


def test_scunet_denoise_image_matches_jax():
    """A ragged 70x90 image in tiles of 64 with overlap 8 (64-multiple
    reflect pad), and whole."""
    tree, jcfg, net, _ = scunet_pair("one_block_a_stage", 9)
    img = image(70, 90, 10)
    for tile in (64, 256):
        out = scunet.denoise_image(net, img, tile=tile, overlap=8)
        ref = jax_scunet.denoise_image(tree, jcfg, Image.fromarray(img), tile=tile, overlap=8)
        assert out.shape == img.shape
        assert_images_equal(out, ref)


def test_dat_and_scunet_directories_through_the_registry(tmp_path):
    """register_model_dirs finds models/ScuNET and --dat-models-path; SCUNet
    runs at 1x and Lanczos resizes after it, as in JAX."""
    os.makedirs(tmp_path / "ScuNET")
    os.makedirs(tmp_path / "dat_elsewhere")
    write_file(tmp_path / "ScuNET" / "ScuNET tiny.safetensors",
               scunet_pair("one_block_a_stage", 11)[3])
    write_file(tmp_path / "dat_elsewhere" / "DAT tiny.safetensors",
               dat_pair("1conv_pixelshuffle_x2", 12)[3])
    names, _ = port_upscalers.register_model_dirs(
        models_root=str(tmp_path), dat_dir=str(tmp_path / "dat_elsewhere"), device="cpu")
    jax_names = jax_scunet.register_scunet_dir((str(tmp_path / "ScuNET"),)) + \
        jax_dat.register_dat_dir((str(tmp_path / "dat_elsewhere"),))
    try:
        assert names == jax_names == ["ScuNET tiny", "DAT tiny"]
        assert port_upscalers.get_upscaler("ScuNET tiny").default_scale == 1
        img = image(40, 36, 13)
        for name, size in (("ScuNET tiny", (80, 72, 3)), ("DAT tiny", (80, 72, 3))):
            out = port_upscalers.upscale(name, img, 2.0)
            ref = jax_upscalers.upscale(name, Image.fromarray(img), 2.0)
            assert out.shape == size
            assert_images_equal(out, ref)
    finally:
        for name in names:
            port_upscalers.unregister_upscaler(name)
            jax_upscalers._REGISTRY.pop(name, None)
        jax_upscalers._UPSCALE_CACHE.clear()
