"""The port's MiDaS DPT-hybrid against the JAX package's (CPU, f32): the
tiny tower of ``tests/test_midas.py`` (stem 32, stages (1, 1, 1), a 64-wide
2-layer ViT, 32 features) on a state dict made with numpy from a seed,
through both converters; ``apply`` (also with the position-embedding
resize), ``depth_conditioning``, both key prefixes, the JAX tree carried
across by ``dpt_from_jax``, and the published widths built on ``meta``.
Held to 1e-4 of the largest magnitude."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdwebui_tpu.models import midas as jax_midas
from sdwebui_tpu_torch.loader import convert
from sdwebui_tpu_torch.models import midas
from sdwebui_tpu_torch.pipeline import sd_model as port_sd
from test_torch_models import _assert_rel

TINY = port_sd.TINY_DPT


def random_dpt_state_dict(cfg: midas.DPTConfig, seed: int) -> dict:
    """{name: float32 array} of a DPT at `cfg` with raw (unstandardised)
    conv weights: N(0, 1/fan_in) weights, N(0, 0.1²) biases, norm gains
    1 + N(0, 0.1²), cls token and position embedding N(0, 0.02²)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in midas.DPTDepthModel(cfg, device="meta").state_dict().items():
        shape = tuple(t.shape)
        if len(shape) == 1:
            a = (1.0 if name.endswith("weight") else 0.0) + 0.1 * rng.standard_normal(shape)
        elif len(shape) in (2, 4):
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        else:
            a = 0.02 * rng.standard_normal(shape)
        out[name] = a.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def towers():
    sd = random_dpt_state_dict(TINY, 0)
    tree, jcfg = jax_midas.convert_dpt({"depth_model.model." + k: v for k, v in sd.items()})
    jcfg = dataclasses.replace(jcfg, hooks=TINY.hooks, vit_heads=TINY.vit_heads)
    flat, cfg = convert.convert_dpt({"depth_model.model." + k: torch.from_numpy(v)
                                     for k, v in sd.items()})
    tower = midas.DPTDepthModel(dataclasses.replace(cfg, vit_heads=TINY.vit_heads))
    tower.load_state_dict(flat, strict=True)
    return sd, tree, jcfg, tower.standardize_()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("size", [64, 96])
def test_dpt_forward_matches_jax(towers, size):
    """At the tower's own size and at 96² (the position embedding resized
    from a 4x4 to a 6x6 grid)."""
    _, tree, jcfg, tower = towers
    img = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda x: jax_midas.apply(tree, jcfg, x))(jnp.asarray(img)))
    with torch.no_grad():
        out = tower(_nchw(img))
    assert out.shape == (2, 1, size, size)
    _assert_rel(out.permute(0, 2, 3, 1).numpy(), ref, 1e-4)


def test_depth_conditioning_matches_jax(towers):
    """A 48x80 image resized to the tower (antialiased bicubic down, as
    jax.image.resize), its depth resized to an 8x10 latent grid and
    normalised to [-1, 1] per image."""
    _, tree, jcfg, tower = towers
    img = np.random.default_rng(5).uniform(0, 1, (2, 48, 80, 3)).astype(np.float32)
    ref = np.asarray(jax_midas.depth_conditioning(tree, jcfg, jnp.asarray(img), 8, 10))
    with torch.no_grad():
        out = midas.depth_conditioning(tower, _nchw(img), 8, 10)
    assert out.shape == (2, 1, 8, 10)
    _assert_rel(out.permute(0, 2, 3, 1).numpy(), ref, 1e-4)
    assert float(out.amin()) == pytest.approx(-1.0, abs=1e-5)
    assert float(out.amax()) == pytest.approx(1.0, abs=1e-5)


@pytest.mark.parametrize("prefix", ["depth_model.model.", ""])
def test_convert_dpt_on_both_prefixes(towers, prefix):
    """SD2-depth's prefix and the annotator file's bare keys give one
    config (JAX's derivation, plus the widths JAX reads off its tree) and
    the file's tensors; junk under the prefix is dropped with a warning,
    a missing tensor raises naming it."""
    sd = towers[0]
    tensors = {prefix + k: torch.from_numpy(v) for k, v in sd.items()}
    flat, cfg = convert.convert_dpt({**tensors, prefix + "junk.x": torch.zeros(1)},
                                    prefix=prefix)
    _, jcfg = jax_midas.convert_dpt({k: v for k, v in sd.items()}, prefix="")
    for field in ("image_size", "stem_width", "stage_blocks", "vit_width", "vit_layers",
                  "vit_heads", "hooks", "features"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert cfg == dataclasses.replace(TINY, vit_heads=1)
    assert set(flat) == set(sd)
    missing = dict(tensors)
    missing.pop(prefix + "scratch.layer2_rn.weight")
    with pytest.raises(ValueError, match="missing"):
        convert.convert_dpt(missing, prefix=prefix)


def test_dpt_from_jax_carries_the_tree(towers):
    """The JAX tree (HWIO convs, (in, out) linears) inverted to the torch
    layout, standardised once: equal to the tower loaded from the file."""
    _, tree, jcfg, tower = towers
    carried = port_sd.dpt_from_jax(tree, jcfg)
    assert carried.cfg == tower.cfg
    for (name, a), (_, b) in zip(carried.state_dict().items(), tower.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_published_widths_on_meta():
    """DPTConfig() builds the dpt_hybrid tower (123 M parameters) and its
    state dict converts back to the same config."""
    tower = midas.DPTDepthModel(midas.DPTConfig(), device="meta")
    assert sum(p.numel() for p in tower.parameters()) == 122372993
    _, cfg = convert.convert_dpt(tower.state_dict(), prefix="")
    assert cfg == midas.DPTConfig()


def test_standardisation_runs_once_in_f32():
    """StdConv2d's weights are standardised in place of the loaded ones
    (new storage: the caller's tensors stay as they were): zero mean and
    unit variance per output channel."""
    sd = random_dpt_state_dict(TINY, 1)
    flat, cfg = convert.convert_dpt({k: torch.from_numpy(v) for k, v in sd.items()}, prefix="")
    tower = midas.DPTDepthModel(cfg)
    tower.load_state_dict(flat)
    raw = flat["pretrained.model.patch_embed.backbone.stem.conv.weight"].clone()
    tower.standardize_()
    w = tower.pretrained.model.patch_embed.backbone.stem.conv.weight
    torch.testing.assert_close(flat["pretrained.model.patch_embed.backbone.stem.conv.weight"],
                               raw, rtol=0, atol=0)
    torch.testing.assert_close(w.mean(dim=(1, 2, 3)), torch.zeros(w.shape[0]), atol=1e-6,
                               rtol=0)
    torch.testing.assert_close(w.var(dim=(1, 2, 3), unbiased=False), torch.ones(w.shape[0]),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("cin,cout,size", [(32, 16, 32), (16, 8, 13), (4, 1, 9)])
def test_conv_im2col_equals_the_conv(cin, cout, size):
    """The head conv's im2col + GEMM route against F.conv2d (channels-last
    weights, a batch of 2, non-zero bias): 1e-5 of the largest magnitude."""
    from sdwebui_tpu_torch.models.layers import Conv2d

    conv = Conv2d(cin, cout, 3, device="cpu", dtype=torch.float32)
    g = torch.Generator().manual_seed(cin)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g))
        conv.bias.copy_(torch.randn(conv.bias.shape, generator=g))
    x = torch.randn((2, cin, size, size), generator=g)
    with torch.no_grad():
        _assert_rel(midas.conv_im2col(conv, x).numpy(), conv(x).numpy(), 1e-5)
