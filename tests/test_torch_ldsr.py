"""LDSR in the port against the JAX package: DDIM in alpha space with a
shared eps function (max|Δ| <= 1e-6·max|ref|), the legacy UNet AttentionBlock in f32
(<= 1e-4) and the whole legacy UNet, the VQ first stage (the quantizer's
indices equal, its decode <= 1e-4), ``super_resolution`` at 2 steps (the
bf16 latent within 2e-2 of max|ref|; a codebook index may differ only
where the latent difference explains it; the decode of one latent within
1 uint8 level), and discovery with ``opts.ldsr_steps``.

The tiny model is made by the port from a seed (``create_random_ldsr`` at
a tiny config), its checkpoint state dict converted by the JAX package's
own loaders (``convert_unet``, ``_convert_vq``) and carried back with
``ldsr_from_jax``."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sdwebui_tpu.loader.convert import convert_unet
from sdwebui_tpu.models import ldsr as jax_ldsr
from sdwebui_tpu.models import unet as jax_unet
from sdwebui_tpu.postprocessing import upscalers as jax_upscalers
from sdwebui_tpu_torch.loader import convert as port_convert
from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
from sdwebui_tpu_torch.models import ldsr
from sdwebui_tpu_torch.models.configs import UNetConfig, VAEConfig
from sdwebui_tpu_torch.models.unet import AttentionBlock
from sdwebui_tpu_torch.models.vae import vq_distances, vq_quantize
from sdwebui_tpu_torch.postprocessing import upscalers as port_upscalers
from sdwebui_tpu_torch.utils.options import opts as port_opts

TINY = ldsr.LDSRConfig(
    unet=UNetConfig(in_channels=6, out_channels=3, model_channels=32, num_res_blocks=1,
                    channel_mult=(1, 2), attention_resolutions=(2,), transformer_depth=(0, 1),
                    num_heads=-1, num_head_channels=32),
    vq=VAEConfig(embed_dim=3, z_channels=3, ch=32, ch_mult=(1, 1, 2), num_res_blocks=1,
                 scale_factor=1.0, shift_factor=0.0),
    n_embed=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """(checkpoint state dict as numpy, JAX unet tree, JAX vq tree, JAX
    cfg, the port model from the JAX trees)."""
    model = ldsr.create_random_ldsr(0, "cpu", TINY)
    rng = np.random.default_rng(1)
    sd = {}
    for k, v in ldsr.ldsr_state_dict(model).items():
        a = v.float().numpy().copy()
        if k.endswith(".bias") or (a.ndim == 1 and "norm" in k):
            a = a + rng.normal(0, 0.05, a.shape).astype(np.float32)
        sd[k] = a
    utree, ucfg = convert_unet(sd)
    vtree, vcfg = jax_ldsr._convert_vq(sd)
    jcfg = jax_ldsr.LDSRConfig(unet=ucfg, vq=vcfg, n_embed=TINY.n_embed)
    return sd, utree, vtree, jcfg, ldsr.ldsr_from_jax(utree, vtree)


def test_config_from_the_checkpoint(tiny):
    sd, utree, vtree, jcfg, model = tiny
    assert model.cfg == TINY
    assert dataclasses.asdict(model.cfg.unet) == dataclasses.asdict(jcfg.unet)
    assert model.cfg.unet.heads_for(64) == 2      # 32-channel legacy heads
    assert next(model.unet.parameters()).dtype == torch.bfloat16
    assert next(model.vq.parameters()).dtype == torch.float32
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    same = ldsr.ldsr_from_state_dict(tensors, "cpu")
    for (k, a), b in zip(model.state_dict().items(), same.state_dict().values()):
        assert torch.equal(a, b), k
    # the loader's structure check knows the legacy blocks (convert.py:264-271)
    flat, ucfg = port_convert.convert_unet(tensors)
    assert ucfg == TINY.unet and set(flat) == set(model.unet.state_dict())
    missing = {k: v for k, v in tensors.items() if not k.endswith("middle_block.1.qkv.bias")}
    with pytest.raises(ValueError, match="missing"):
        port_convert.convert_unet(missing)


def test_ldsr_unet_config_of_the_published_model():
    """BSR_SR's UNet holds 6 legacy blocks at ds 8, 640 channels as 20 heads
    of 32 (the launch plan of chip_smoke's LDSR request)."""
    with torch.device("meta"):
        model = ldsr.LDSR(ldsr.BSR_SR, device="meta")
    blocks = [m for m in model.unet.modules() if isinstance(m, AttentionBlock)]
    assert [(b.heads, b.qkv.weight.shape[1]) for b in blocks] == [(20, 640)] * 6
    sd = {k: torch.empty(v.shape, device="meta") for k, v in ldsr.ldsr_state_dict(model).items()}
    assert ldsr.derive_ldsr_config(sd) == ldsr.BSR_SR


def test_ddim_matches_jax_with_a_shared_eps_fn():
    """The scan of ldsr._ddim_sample and the port's loop on one analytic
    eps function: 10 steps, eta 1, the last step down to t = 0."""
    cfg, steps = ldsr.LDSRConfig(), 10
    ts = ldsr.ddim_timesteps(cfg, steps)
    rng = np.random.default_rng(11)
    x0 = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    lr = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    noise = rng.standard_normal((steps, 2, 8, 8, 3)).astype(np.float32)

    def jax_eps(x_in, tb):        # products and sums only: rounded alike in both
        x, lr_ = x_in[..., :3], x_in[..., 3:]
        return 0.9 * x - 0.05 * x * x + 0.3 * lr_ + 0.02 * tb[:, None, None, None] / 1000.0

    def port_eps(x_in, tb):
        x, lr_ = x_in[:, :3], x_in[:, 3:]
        return 0.9 * x - 0.05 * x * x + 0.3 * lr_ + 0.02 * tb[:, None, None, None] / 1000.0

    alphas = jax_ldsr.make_alphas(jax_ldsr.LDSRConfig())
    np.testing.assert_array_equal(ldsr.make_alphas(cfg), alphas)
    ref = np.asarray(jax_ldsr._ddim_sample(
        None, None, jnp.asarray(lr), jnp.asarray(noise), jnp.asarray(x0),
        jnp.asarray(alphas, jnp.float32), jnp.asarray(ts, jnp.int32), steps, 1.0,
        eps_fn=jax_eps))
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))  # noqa: E731
    got = ldsr.ddim_sample(port_eps, nchw(lr), nchw(noise), nchw(x0),
                           torch.as_tensor(alphas, dtype=torch.float32), ts, 1.0)
    err = np.abs(got.permute(0, 2, 3, 1).numpy() - ref).max()
    assert err <= 1e-6 * np.abs(ref).max(), err         # |x| reaches ~20 here


def f32_model(sd: dict) -> ldsr.LDSR:
    """The tiny model with its UNet in f32 (the checkpoint's own values)."""
    net = ldsr.LDSR(TINY, unet_dtype=torch.float32)
    names = {"model.diffusion_model.": "unet.", "first_stage_model.": "vq."}
    net.load_state_dict({names[p] + k[len(p):]: torch.from_numpy(v) for k, v in sd.items()
                         for p in names if k.startswith(p)})
    return net


def test_legacy_attention_block_matches_jax_f32(tiny):
    """One block of the middle (64 channels, 2 heads of 32), f32."""
    sd, utree, _, jcfg, _ = tiny
    block = f32_model(sd).unet.middle_block[1]
    x = np.random.default_rng(2).standard_normal((2, 8, 6, 64)).astype(np.float32)
    p = utree["middle_block"]["1"]
    ref = np.asarray(jax_unet._legacy_attention_block(p, jnp.asarray(x), jcfg.unet))
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - ref).max() <= 1e-4


def test_legacy_unet_matches_jax(tiny):
    """The whole tiny legacy UNet: f32 within 1e-4 of JAX's apply."""
    sd, utree, _, jcfg, _ = tiny
    net = f32_model(sd)
    x = np.random.default_rng(3).standard_normal((1, 16, 24, 6)).astype(np.float32)
    tb = np.array([501.0], np.float32)
    ref = np.asarray(jax_unet.apply(utree, jcfg.unet, jnp.asarray(x), jnp.asarray(tb), None))
    with torch.no_grad():
        got = net.unet(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(tb), None)
    assert np.abs(got.permute(0, 2, 3, 1).numpy() - ref).max() <= 1e-4


def test_vq_quantize_and_decode_match_jax(tiny):
    _, _, vtree, jcfg, model = tiny
    rng = np.random.default_rng(4)
    h = (rng.standard_normal((2, 8, 10, 3)) * 2).astype(np.float32)
    cb = model.vq.quantize.embedding.weight
    ref = np.asarray(jax_ldsr.vq_quantize(jnp.asarray(h), jnp.asarray(cb.numpy())))
    q, idx = vq_quantize(torch.from_numpy(h).permute(0, 3, 1, 2), cb, return_indices=True)
    ref_idx = np.argmin(((h.reshape(-1, 1, 3) - cb.numpy()[None]) ** 2).sum(-1), -1)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    np.testing.assert_array_equal(q.permute(0, 2, 3, 1).numpy(), ref)
    dec = np.asarray(jax_ldsr.vq_decode(vtree, jcfg.vq, jnp.asarray(h)))
    with torch.no_grad():
        got = model.vq.vq_decode(torch.from_numpy(h).permute(0, 3, 1, 2))
    assert np.abs(got.permute(0, 2, 3, 1).numpy() - dec).max() <= 1e-4


def test_super_resolution_matches_jax_at_2_steps(tiny):
    """The 4x pass on a ragged 40x56 image (padded to 64x64), then LANCZOS
    to x3.  bf16 UNet: the final latent within 2e-2 of max|ref|; each
    codebook index equal to JAX's unless JAX's latent lies within twice
    the latents' distance of the two codewords' boundary (a flip the bf16
    difference explains); the decode of JAX's quantized latent within 1
    uint8 level of JAX's image."""
    _, utree, vtree, jcfg, model = tiny
    img = (np.random.default_rng(5).random((40, 56, 3)) * 255).astype(np.uint8)
    bf16 = {k: v for k, v in utree.items()}
    import jax

    bf16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), utree)
    vq32 = jax.tree.map(jnp.asarray, vtree)
    ref = np.asarray(jax_ldsr.super_resolution(bf16, vq32, jcfg, Image.fromarray(img), steps=2,
                                               target_scale=3.0))
    out, z = ldsr.super_resolution(model, img, steps=2, target_scale=3.0, return_latent=True)
    assert out.shape == ref.shape == (120, 168, 3)
    # JAX's final latent, from its sampler on the same draws
    arr = np.pad(img.astype(np.float32) / 255.0, ((0, 24), (0, 8), (0, 0)), "edge")
    x_t, noise = ldsr.draw_noise(0, 64, 64, 3, 2)
    zj = np.asarray(jax_ldsr._ddim_sample(
        bf16, jcfg.unet, jnp.asarray(arr[None] * 2.0 - 1.0), jnp.asarray(noise),
        jnp.asarray(x_t), jnp.asarray(jax_ldsr.make_alphas(jcfg), jnp.float32),
        jnp.asarray(ldsr.ddim_timesteps(TINY, 2), jnp.int32), 2, 1.0))
    zp = z.permute(0, 2, 3, 1).numpy()
    assert np.abs(zp - zj).max() / np.abs(zj).max() <= 2e-2
    cb = model.vq.quantize.embedding.weight
    dj = vq_distances(torch.from_numpy(zj.copy()).permute(0, 3, 1, 2), cb).sqrt()
    ij, ip = dj.argmin(-1), vq_distances(z, cb).argmin(-1)
    flips = (ij != ip).nonzero()[:, 0]
    shift = np.linalg.norm((zp - zj).reshape(-1, 3), axis=-1)
    margin = (dj[flips, ip[flips]] - dj[flips, ij[flips]]).numpy()
    assert (margin <= 2 * shift[flips.numpy()] + 1e-6).all()
    # one latent through both decoders
    zq = np.asarray(jax_ldsr.vq_quantize(jnp.asarray(zj), jnp.asarray(cb.numpy())))
    dec_j = np.asarray(jnp.clip(jax_ldsr.vq_decode(vq32, jcfg.vq, jnp.asarray(zq),
                                                   quantize=False) / 2 + 0.5, 0, 1))
    with torch.no_grad():
        dec_p = torch.clamp(model.vq.decode(torch.from_numpy(zq).permute(0, 3, 1, 2)) / 2 + 0.5,
                            0, 1).permute(0, 2, 3, 1).numpy()
    to_u8 = lambda a: (a[0, :160, :224] * 255 + 0.5).astype(np.uint8)   # noqa: E731
    assert np.abs(to_u8(dec_p).astype(int) - to_u8(dec_j).astype(int)).max() <= 1
    if not len(flips):
        assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


def test_register_ldsr_dir_names_and_steps(tmp_path, tiny, monkeypatch):
    """"LDSR" for model* / last* files, "LDSR (<name>)" else, as JAX names
    them; each request runs opts.ldsr_steps steps at the registry's scale."""
    sd = tiny[0]
    for fn in ("model.safetensors", "extra.safetensors"):
        write_safetensors(str(tmp_path / fn), {k: torch.from_numpy(v) for k, v in sd.items()})
    os.makedirs(tmp_path / "ignored.d")
    names = ldsr.register_ldsr_dir((str(tmp_path),), device="cpu")
    try:
        assert names == jax_ldsr.register_ldsr_dir((str(tmp_path),)) == \
            ["LDSR (extra)", "LDSR"]
        seen = []
        real = ldsr.super_resolution
        monkeypatch.setattr(ldsr, "super_resolution", lambda m, im, steps, target_scale: (
            seen.append((steps, target_scale)) or real(m, im, steps=steps,
                                                       target_scale=target_scale)))
        img = (np.random.default_rng(6).random((16, 20, 3)) * 255).astype(np.uint8)
        with port_opts.override({"ldsr_steps": 1, "upscaling_max_images_in_cache": 0}):
            out = port_upscalers.upscale("LDSR", img, 2.0)
        assert seen == [(1, 4.0)] and out.shape == (32, 40, 3)
    finally:
        for name in names:
            port_upscalers.unregister_upscaler(name)
            jax_upscalers._REGISTRY.pop(name, None)
