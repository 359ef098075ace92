"""SwinIR, Swin2SR and HAT in the port against the JAX package: each net's
forward at the JAX tests' tiny configs for every upsampler and residual
connection (f32, max|Δ| <= 1e-4), the tiled ``upscale_image`` on a ragged
image, the single-tile clip (the port clips where JAX's SwinIR wraps),
Swin2SR's Hugging Face layout, HAT's release
layout, discovery (Swin2SR files sniffed in the SwinIR directory), and the
routes: ``/upscalers`` over a seeded zoo directory, an Extras request and a
hires fix with a zoo upscaler, each held to the JAX stages.

Weights: a port net made at the tiny config from a seed, its state dict
jittered (biases, norm gains), written through the JAX package's own
converter; the port net under test is rebuilt from that JAX tree with
``*_from_jax``, so both packages run the same numbers."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)
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
from PIL import Image

from sdwebui_tpu.models import hat as jax_hat
from sdwebui_tpu.models import swin2sr as jax_swin2sr
from sdwebui_tpu.models import swinir as jax_swinir
from sdwebui_tpu.pipeline import processing as jax_proc
from sdwebui_tpu.pipeline.params import GenerationParams as JaxParams
from sdwebui_tpu.postprocessing import stages as jax_stages
from sdwebui_tpu.postprocessing import upscalers as jax_upscalers
from sdwebui_tpu.utils.options import opts as jax_opts
from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
from sdwebui_tpu_torch.models import hat, swin2sr, swinir
from sdwebui_tpu_torch.pipeline import processing as port_proc
from sdwebui_tpu_torch.pipeline.params import GenerationParams
from sdwebui_tpu_torch.postprocessing import upscalers as port_upscalers
from sdwebui_tpu_torch.utils.options import opts as port_opts
from sdwebui_tpu_torch.utils.png import decode_png, encode_png
from test_torch_hires import _hr, _assert_same, f32_policies, models  # noqa: F401

F32_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jittered_state_dict(net: torch.nn.Module, seed: int) -> dict:
    """`net`'s state dict as numpy f32 with every bias and 1-D gain moved
    by N(0, 0.05²) (the layers' init leaves biases at zero and norms at 1)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in net.state_dict().items():
        a = v.float().numpy().copy()
        if a.ndim == 1 or k.endswith(".bias"):
            a = a + rng.normal(0, 0.05, a.shape).astype(np.float32)
        sd[k] = a
    return sd


def image(h: int, w: int, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).random((h, w, 3)) * 255).astype(np.uint8)


def tiles_input(seed: int, h: int = 8, w: int = 12) -> np.ndarray:
    return np.random.default_rng(seed).random((2, h, w, 3)).astype(np.float32)


def forward(net, x: np.ndarray) -> np.ndarray:
    with torch.inference_mode():
        return net(torch.from_numpy(x)).numpy()


def assert_close(got, ref, tol=F32_TOL):
    assert got.shape == ref.shape
    err = np.abs(got - np.asarray(ref)).max()
    assert err <= tol, err
    assert np.asarray(ref).std() > 1e-3          # not a flat (or wholly clipped) output


def assert_images_equal(out: np.ndarray, ref):
    """0 uint8 levels, but for values whose f32 result sits within the
    two packages' rounding of a .5 boundary (|Δ| <= 1 where one does)."""
    ref = np.asarray(ref)
    assert out.shape == ref.shape and out.dtype == np.uint8
    delta = np.abs(out.astype(int) - ref.astype(int))
    assert delta.max() <= 1
    assert (delta > 0).mean() <= 1e-3, (delta > 0).sum()


# --------------------------------------------------------------------------
# SwinIR
# --------------------------------------------------------------------------

SWINIR_TINY = swinir.SwinIRConfig(embed_dim=12, depths=(2, 2), num_heads=(2, 2), window_size=4,
                                  mlp_ratio=2.0, num_feat=8)
SWINIR_CASES = {
    "nearest+conv_x4": dict(upsampler="nearest+conv", scale=4),
    "nearest+conv_x2": dict(upsampler="nearest+conv", scale=2),
    "pixelshuffle_x2": dict(upsampler="pixelshuffle", scale=2),
    "pixelshuffle_x3": dict(upsampler="pixelshuffle", scale=3),
    "pixelshuffledirect_x2": dict(upsampler="pixelshuffledirect", scale=2),
    "none": dict(upsampler="none", scale=1),
    "3conv_nearest+conv_x4": dict(upsampler="nearest+conv", scale=4, resi_connection="3conv",
                                  embed_dim=16),
    "no_patch_norm": dict(upsampler="pixelshuffledirect", scale=2, patch_norm=False),
}


def swinir_pair(case: str, seed: int = 0):
    """(JAX tree, JAX cfg, the port net from the tree, the state dict)."""
    cfg = dataclasses.replace(SWINIR_TINY, **SWINIR_CASES[case])
    sd = jittered_state_dict(swinir.create_random_swinir(seed, "cpu", cfg), seed)
    tree, jcfg = jax_swinir.convert_swinir(sd)
    return tree, jcfg, swinir.swinir_from_jax(tree), sd


@pytest.mark.parametrize("case", list(SWINIR_CASES))
def test_swinir_matches_jax(case):
    tree, jcfg, net, _ = swinir_pair(case)
    assert (net.cfg.upsampler, net.cfg.scale) == (jcfg.upsampler, jcfg.scale)
    x = tiles_input(1)
    assert_close(forward(net, x), jax_swinir.apply(tree, jcfg, jnp.asarray(x)))


def test_swinir_reads_the_release_layout():
    """conv_before_upsample.0 and the params_ema wrapper, with the
    recomputed buffers in the file: the config from the shapes."""
    _, jcfg, ref_net, sd = swinir_pair("3conv_nearest+conv_x4")
    sd = {"params_ema." + k: torch.from_numpy(v) for k, v in sd.items()}
    sd["params_ema.layers.0.residual_group.blocks.1.attn_mask"] = torch.zeros(4, 16, 16)
    sd["params_ema.layers.0.residual_group.blocks.0.attn.relative_position_index"] = \
        torch.zeros(16, 16, dtype=torch.int64)
    net = swinir.swinir_from_state_dict(sd, "cpu")
    assert net.cfg == ref_net.cfg and net.cfg.resi_connection == "3conv"
    assert "conv_before_upsample.0.weight" in net.state_dict()
    x = tiles_input(2)
    np.testing.assert_array_equal(forward(net, x), forward(ref_net, x))
    bad = dict(sd, **{"params_ema.absolute_pos_embed": torch.zeros(1, 16, 16)})
    with pytest.raises(NotImplementedError, match="ape"):
        swinir.swinir_from_state_dict(bad, "cpu")


@pytest.mark.parametrize("tile", [16, 0])
def test_swinir_upscale_image_matches_jax(tile):
    """A ragged 20x26 image in tiles of 16 with overlap 4, and whole."""
    tree, jcfg, net, _ = swinir_pair("nearest+conv_x4", 3)
    img = image(20, 26, 4)
    out = swinir.upscale_image(net, img, tile=tile, overlap=4)
    ref = jax_swinir.upscale_image(tree, jcfg, Image.fromarray(img), tile=tile, overlap=4)
    assert out.shape == (80, 104, 3)
    assert_images_equal(out, ref)


class _Stretch(torch.nn.Module):
    """A stand-in x1 net whose output leaves [0, 1]: 1.5·x − 0.25."""

    scale, pad_multiple = 1, 4

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(()), requires_grad=False)

    def forward(self, x):
        return 1.5 * x - 0.25


def test_single_tile_clip_departure(monkeypatch):
    """JAX's single-tile path casts without a clip (swinir.py:406-409), so
    an output outside [0, 1] wraps; its tiled path and the port clip.
    Where the output is in range, the two agree exactly."""
    img = image(12, 16, 5)
    jcfg = jax_swinir.SwinIRConfig(window_size=4, scale=1)
    monkeypatch.setattr(jax_swinir, "_apply_batch", lambda p, c, x: 1.5 * x - 0.25)
    ref = np.asarray(jax_swinir.upscale_image(None, jcfg, Image.fromarray(img), tile=0))
    out = swinir.upscale_image(_Stretch(), img, tile=0)
    want = np.clip(1.5 * img.astype(np.float32) / 255.0 - 0.25, 0, 1) * 255 + 0.5
    np.testing.assert_array_equal(out, want.astype(np.uint8))
    high = 1.5 * img.astype(np.float32) / 255.0 - 0.25 > 1.0
    assert high.any() and (ref[high] < 128).all() and (out[high] == 255).all()
    inside = ~high & (1.5 * img.astype(np.float32) / 255.0 - 0.25 >= 0)
    np.testing.assert_array_equal(out[inside], ref[inside])


@pytest.mark.parametrize("bias", [True, False])
def test_conv3x3_gemm_matches_conv2d(bias):
    """The wide 3x3 convs' CUDA route (nine tap GEMMs on NHWC), run here on
    CPU tensors, against F.conv2d."""
    from sdwebui_tpu_torch.models.layers import Conv2d

    conv = Conv2d(130, 70, 3, bias=bias, device="cpu", dtype=torch.float32)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * 0.05)
        if bias:
            conv.bias.copy_(torch.randn(conv.bias.shape, generator=g))
    x = torch.randn((2, 9, 11, 130), generator=g)
    ref = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias, 1, 1)
    got = swinir.conv3x3_gemm(conv, x)
    assert got.shape == (2, 9, 11, 70) and got.is_contiguous()
    assert (got - ref.permute(0, 2, 3, 1)).abs().max() <= 1e-5


# --------------------------------------------------------------------------
# Swin2SR
# --------------------------------------------------------------------------

SWIN2SR_TINY = swin2sr.Swin2SRConfig(embed_dim=16, depths=(2, 2), num_heads=(2, 2), window_size=4,
                                     num_feat=16, cpb_hidden=32)
SWIN2SR_CASES = {
    "pixelshuffle_x2": dict(upsampler="pixelshuffle", scale=2),
    "pixelshuffle_x4": dict(upsampler="pixelshuffle", scale=4),
    "pixelshuffledirect_x2": dict(upsampler="pixelshuffledirect", scale=2),
    "nearest+conv_x4": dict(upsampler="nearest+conv", scale=4),
    "no_patch_norm_x2": dict(upsampler="pixelshuffledirect", scale=2, patch_norm=False),
}


def swin2sr_pair(case: str, seed: int = 0):
    cfg = dataclasses.replace(SWIN2SR_TINY, **SWIN2SR_CASES[case])
    sd = jittered_state_dict(swin2sr.create_random_swin2sr(seed, "cpu", cfg), seed)
    tree, jcfg = jax_swin2sr.convert_swin2sr(sd)
    jcfg = dataclasses.replace(jcfg, window_size=4)
    return tree, jcfg, swin2sr.swin2sr_from_jax(tree, window_size=4), sd


@pytest.mark.parametrize("case", list(SWIN2SR_CASES))
def test_swin2sr_matches_jax(case):
    tree, jcfg, net, _ = swin2sr_pair(case)
    assert (net.cfg.upsampler, net.cfg.scale) == (jcfg.upsampler, jcfg.scale)
    x = tiles_input(6)
    assert_close(forward(net, x), jax_swin2sr.apply(tree, jcfg, jnp.asarray(x)))


_TO_HF = [   # the original repository's names → Hugging Face's (swin2sr.py:190-200)
    ("conv_first.", "swin2sr.first_convolution."),
    ("patch_embed.projection.", "swin2sr.embeddings.patch_embeddings.projection."),
    ("patch_embed.norm.", "swin2sr.embeddings.patch_embeddings.layernorm."),
    ("norm.", "swin2sr.layernorm."), ("conv_after_body.", "swin2sr.conv_after_body."),
    ("conv_before_upsample.", "upsample.conv_before_upsample."),
    ("conv_last.", "upsample.final_convolution."),
]
_BLOCK_TO_HF = [("attn.cpb_mlp.", "attention.self.continuous_position_bias_mlp."),
                ("attn.logit_scale", "attention.self.logit_scale"),
                ("attn.proj.", "attention.output.dense."), ("norm1.", "layernorm_before."),
                ("norm2.", "layernorm_after."), ("mlp.fc1.", "intermediate.dense."),
                ("mlp.fc2.", "output.dense.")]


def hugging_face_layout(sd: dict) -> dict:
    """A Swin2SR state dict re-keyed as transformers' Swin2SRForImageSuperResolution
    keeps it: split query/key/value (no key bias), stages, upsample names."""
    import re

    out = {}
    for k, v in sd.items():
        m = re.match(r"layers\.(\d+)\.residual_group\.blocks\.(\d+)\.(.+)", k)
        if m:
            pre, rest = f"swin2sr.encoder.stages.{m[1]}.layers.{m[2]}.", m[3]
            if rest == "attn.qkv.weight":
                for name, part in zip(("query", "key", "value"), np.split(v, 3)):
                    out[pre + f"attention.self.{name}.weight"] = part
                continue
            if rest in ("attn.q_bias", "attn.v_bias"):
                out[pre + f"attention.self.{'query' if 'q_' in rest else 'value'}.bias"] = v
                continue
            for a, b in _BLOCK_TO_HF:
                if rest.startswith(a):
                    rest = b + rest[len(a):]
                    break
            out[pre + rest] = v
            continue
        m = re.match(r"layers\.(\d+)\.(.+)", k)
        if m:
            out[f"swin2sr.encoder.stages.{m[1]}.{m[2]}"] = v
            continue
        m = re.match(r"upsample\.(\d+)\.(.+)", k)
        if m:
            out[f"upsample.upsample.convolution_{int(m[1]) // 2}.{m[2]}"] = v
            continue
        for a, b in _TO_HF:
            if k.startswith(a):
                k = b + k[len(a):]
                break
        out[k] = v
    return out


def test_swin2sr_hugging_face_layout():
    """Hugging Face's layout (split q/k/v, the 1x1 patch projections after
    conv_first and after each stage's conv): the port from it against JAX's
    convert_swin2sr of the same dict, and back to the original keys."""
    cfg = dataclasses.replace(SWIN2SR_TINY, upsampler="pixelshuffle", scale=2,
                              patch_projection=True, stage_projection=True)
    sd = jittered_state_dict(swin2sr.create_random_swin2sr(9, "cpu", cfg), 9)
    hf = hugging_face_layout(sd)
    assert not any(k.startswith(("layers.", "conv_first")) for k in hf)
    back = swin2sr.hf_to_original({k: torch.from_numpy(v) for k, v in hf.items()})
    assert {k.replace("conv_before_upsample.0.", "conv_before_upsample."): v
            for k, v in back.items()}.keys() == \
        {k.replace("conv_before_upsample.0.", "conv_before_upsample."): v
         for k, v in sd.items()}.keys()
    net = swin2sr.swin2sr_from_state_dict({k: torch.from_numpy(v) for k, v in hf.items()},
                                          "cpu", window_size=4)
    assert net.cfg == cfg
    tree, jcfg = jax_swin2sr.convert_swin2sr(hf)
    x = tiles_input(7, 16, 16)
    assert_close(forward(net, x), jax_swin2sr.apply(tree, dataclasses.replace(jcfg, window_size=4),
                                                     jnp.asarray(x)))


def test_swin2sr_upscale_image_matches_jax():
    tree, jcfg, net, _ = swin2sr_pair("pixelshuffle_x2", 8)
    img = image(22, 30, 9)
    out = swin2sr.upscale_image(net, img, tile=16, overlap=4)
    ref = jax_swin2sr.upscale_image(tree, jcfg, Image.fromarray(img), tile=16, overlap=4)
    assert out.shape == (44, 60, 3)
    assert_images_equal(out, ref)


# --------------------------------------------------------------------------
# HAT
# --------------------------------------------------------------------------

HAT_TINY = hat.HATConfig(embed_dim=24, depths=(2, 2), num_heads=(3, 3), window_size=4,
                         overlap_ratio=0.5, compress_ratio=3, squeeze_factor=4, mlp_ratio=2.0,
                         scale=2, num_feat=24)


def hat_pair(seed: int = 0, **kw):
    """HAT's tree flattens conv_before_upsample (the JAX apply reads it
    flat); the release layout is read in test_hat_reads_the_release_layout."""
    cfg = dataclasses.replace(HAT_TINY, **kw)
    sd = jittered_state_dict(hat.create_random_hat(seed, "cpu", cfg), seed)
    flat = {k.replace("conv_before_upsample.0.", "conv_before_upsample."): v
            for k, v in sd.items()}
    tree, jcfg = jax_hat.convert_hat(flat)
    return tree, jcfg, hat.hat_from_jax(tree), sd


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_hat_matches_jax(scale):
    tree, jcfg, net, _ = hat_pair(scale=scale)
    assert net.cfg.scale == jcfg.scale == scale
    x = tiles_input(10)
    assert_close(forward(net, x), jax_hat.apply(tree, jcfg, jnp.asarray(x)))


def test_hat_reads_the_release_layout():
    """The release's keys: params_ema, conv_before_upsample.0, the
    patch-embed norm (carried unused, as in JAX) and the rpi buffers."""
    _, _, ref_net, sd = hat_pair(11, patch_norm=True)
    sd = {"params_ema." + k: torch.from_numpy(v) for k, v in sd.items()}
    sd["params_ema.relative_position_index_SA"] = torch.zeros(16, 16, dtype=torch.int64)
    sd["params_ema.relative_position_index_OCA"] = torch.zeros(16, 36, dtype=torch.int64)
    net = hat.hat_from_state_dict(sd, "cpu")
    assert net.cfg.patch_norm and net.cfg.num_feat == 24
    x = tiles_input(12)
    np.testing.assert_array_equal(forward(net, x), forward(ref_net, x))


def test_hat_upscale_image_matches_jax():
    tree, jcfg, net, _ = hat_pair(13)
    img = image(20, 26, 14)
    out = hat.upscale_image(net, img, tile=16, overlap=4)
    ref = jax_hat.upscale_image(tree, jcfg, Image.fromarray(img), tile=16, overlap=4)
    assert_images_equal(out, ref)


# --------------------------------------------------------------------------
# discovery and the routes
# --------------------------------------------------------------------------

def write_file(path, sd: dict):
    write_safetensors(str(path), {k: torch.from_numpy(np.ascontiguousarray(v))
                                  for k, v in sd.items()})


@pytest.fixture(scope="module")
def zoo_dir(tmp_path_factory):
    """A models root with a SwinIR file and a Swin2SR file in SwinIR/ and a
    HAT file in HAT/, registered in both packages (JAX's from its own
    directories, the port's through register_model_dirs)."""
    root = tmp_path_factory.mktemp("models")
    for sub in ("SwinIR", "HAT"):
        os.makedirs(root / sub)
    write_file(root / "SwinIR" / "SwinIR tiny.safetensors", swinir_pair("nearest+conv_x4", 15)[3])
    s2 = swin2sr_pair("pixelshuffle_x2", 16)[3]
    write_file(root / "SwinIR" / "Swin2SR tiny.safetensors", s2)
    h = hat_pair(17)[3]
    write_file(root / "HAT" / "HAT tiny.safetensors",
               {k.replace("conv_before_upsample.0.", "conv_before_upsample."): v
                for k, v in h.items()})
    jax_names = jax_swinir.register_swinir_dir((str(root / "SwinIR"),)) + \
        jax_hat.register_hat_dir((str(root / "HAT"),))
    names, _ = port_upscalers.register_model_dirs(models_root=str(root), device="cpu")
    assert names == jax_names == ["Swin2SR tiny", "SwinIR tiny", "HAT tiny"]
    yield root, names
    for name in names:
        port_upscalers.unregister_upscaler(name)
        jax_upscalers._REGISTRY.pop(name, None)
    jax_upscalers._UPSCALE_CACHE.clear()


def test_registry_serves_the_zoo_like_jax(zoo_dir, monkeypatch):
    """Each file through both registries' upscale (the Swin2SR file sniffed
    in the SwinIR directory: its window 8 is what both read)."""
    _, names = zoo_dir
    img = image(24, 20, 18)
    for name in names:
        out = port_upscalers.upscale(name, img, 2.0)
        ref = jax_upscalers.upscale(name, Image.fromarray(img), 2.0)
        assert out.shape == (48, 40, 3)
        assert_images_equal(out, ref)
    from sdwebui_tpu_torch.models import swinir as port_swinir

    net, up = port_swinir.load_swinir_dir_net(
        port_upscalers.get_upscaler("Swin2SR tiny").path, "cpu")
    assert isinstance(net, swin2sr.Swin2SR) and up is swin2sr.upscale_image


def test_zoo_loaders_default_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        swinir.register_swinir_dir((str(tmp_path),))
    with pytest.raises(RuntimeError, match="cuda"):
        hat.create_random_hat(0, cfg=HAT_TINY)


@pytest.fixture(scope="module")
def server_url(zoo_dir):
    from sdwebui_tpu_torch.server.api import make_server
    from sdwebui_tpu_torch.server.app import Engine

    server = make_server(Engine(device="cpu", tiny=True, seed=4), "127.0.0.1", 0)
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


def test_zoo_routes_match_jax_stages(server_url, zoo_dir):
    """/upscalers lists the zoo's files; /extra-single-image with the
    SwinIR file and Lanczos as upscaler_2 equals JAX's run_stages; an
    unknown zoo name is still a 422."""
    _, names = zoo_dir
    status, res = _call(server_url + "/upscalers")
    assert status == 200 and set(names) <= {u["name"] for u in res}
    img = image(20, 24, 19)
    body = dict(upscaling_resize=2, upscaler_1="SwinIR tiny", upscaler_2="Lanczos",
                extras_upscaler_2_visibility=0.5)
    with port_opts.override({"upscaling_max_images_in_cache": 0}), \
            jax_opts.override({"upscaling_max_images_in_cache": 0}):
        status, res = _call(server_url + "/extra-single-image",
                            {"image": base64.b64encode(encode_png(img)).decode(), **body})
        assert status == 200, res
        out = decode_png(base64.b64decode(res["image"]))[0]
        ref = jax_stages.run_stages(Image.fromarray(img), jax_stages.StageArgs.from_obj(body))
    assert out.shape == (40, 48, 3)
    assert_images_equal(out, ref)
    code, res = _call(server_url + "/extra-single-image", {
        "image": base64.b64encode(encode_png(img)).decode(), "upscaler_1": "SwinIR 9x"})
    assert code == 422 and "SwinIR 9x" in res["detail"]


def test_hires_with_a_zoo_upscaler_matches_jax(models, f32_policies, zoo_dir):  # noqa: F811
    """Tiny SD1.5 hires fix with the SwinIR file as hr_upscaler: within 1
    level of JAX's process_txt2img, identical infotext."""
    jm, pm = models
    kw = _hr(hr_upscaler="SwinIR tiny", hr_scale=2.0, steps=3)
    ref = jax_proc.process_txt2img(jm, JaxParams(**kw))
    out = port_proc.process_txt2img(pm, GenerationParams(**kw))
    _assert_same(out, ref, 1, (128, 128))
    assert "Hires upscaler: SwinIR tiny" in out.infotexts[0]
