"""fp8 weight storage and SSD-1B-style pruned SDXL files in the port (CPU,
tiny models): the pruned file through both loaders, an output block deeper
than its level's inputs, fp8 storage and its switch back through the
Engine, the SD3 refusal."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdwebui_tpu.loader import load as jax_load
from sdwebui_tpu.models import unet as jax_unet
from sdwebui_tpu_torch.loader import load as port_load
from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
from sdwebui_tpu_torch.models.unet import UNetModel
from sdwebui_tpu_torch.pipeline import sd_model as port_sd
from test_torch_models import _assert_rel, _nchw, _nhwc
from test_torch_pipeline import f32_policies, models  # noqa: F401


def test_pruned_sdxl_file_through_both_loaders(tmp_path, f32_policies):
    """An SDXL file less SSD-1B-style pruned groups: each loader builds the
    file's depths, the port with no parameter left unfilled; the UNets
    agree within 1e-4."""
    base = port_sd.create_tiny_sdxl(4, "cpu")
    cfg = dataclasses.replace(base.unet_cfg, transformer_depth=(0, 3))
    unet = UNetModel(cfg, device="cpu", dtype=torch.float32)
    gen = torch.Generator().manual_seed(4)
    from sdwebui_tpu_torch.models.layers import reset_random

    with torch.no_grad():
        reset_random(unet, gen)
        for p in unet.parameters():
            if p.dim() == 1:
                p.add_(torch.randn(p.shape, generator=gen) * 0.1)
    model = dataclasses.replace(base, unet=unet, unet_cfg=cfg)
    sd = port_load.pruned_state_dict(port_load.ldm_state_dict(model),
                                     {"input_blocks.4.1": 1, "output_blocks.0.1": 2,
                                      "output_blocks.2.1": 1})
    assert not any(".middle_block.1." in k or ".middle_block.2." in k for k in sd)
    path = str(tmp_path / "ssd.safetensors")
    write_safetensors(path, sd)
    ours = port_load.load_model(path, device="cpu")
    ref = jax_load.load_model(path)
    assert len(ours.unet.middle_block) == 1
    assert [len(ours.unet.input_blocks[i][1].transformer_blocks) for i in (4, 5)] == [1, 3]
    got = {k: v for k, v in ours.unet.state_dict().items()}
    want = {k[len("model.diffusion_model."):]: v for k, v in sd.items()
            if k.startswith("model.diffusion_model.")}
    assert set(got) == set(want)
    for k, v in got.items():
        assert torch.equal(v.float(), want[k].float()), k
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 77, 96)).astype(np.float32)
    y = rng.standard_normal((1, 1600)).astype(np.float32)
    t = np.array([300.0], np.float32)
    jp = jax_load.load_model(path).unet_params
    r = np.asarray(jax_unet.apply(jax_tree_f32(jp), ref.unet_cfg, jnp.asarray(x),
                                  jnp.asarray(t), jnp.asarray(ctx), jnp.asarray(y)))
    with torch.no_grad():
        o = _nhwc(ours.unet.float()(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx),
                                    torch.from_numpy(y)))
    _assert_rel(o, r, 1e-4)


def test_pruned_file_keeps_an_output_block_deeper_than_its_inputs(tmp_path, f32_policies):
    """SSD-1B keeps output_blocks.2 at 10 blocks where it prunes the level's
    input blocks to 4: the port builds and loads every block of the file;
    JAX's config takes the input blocks' depth and drops the deeper output
    block's rest as unexpected (ROADMAP C)."""
    from sdwebui_tpu.utils.pytree import flatten

    base = port_sd.create_tiny_sdxl(5, "cpu")
    cfg = dataclasses.replace(base.unet_cfg, transformer_depth=(0, 3))
    unet = UNetModel(cfg, device="cpu", dtype=torch.float32)
    from sdwebui_tpu_torch.models.layers import reset_random

    with torch.no_grad():
        reset_random(unet, torch.Generator().manual_seed(5))
    sd = port_load.pruned_state_dict(port_load.ldm_state_dict(
        dataclasses.replace(base, unet=unet, unet_cfg=cfg)),
        {"input_blocks.4.1": 1, "input_blocks.5.1": 1, "output_blocks.1.1": 2})
    path = str(tmp_path / "ssd-deep-output.safetensors")
    write_safetensors(path, sd)
    ours = port_load.load_model(path, device="cpu")
    blocks = [len(b[1].transformer_blocks) for b in ours.unet.output_blocks[:3]]
    assert blocks == [3, 2, 3] and ours.unet_cfg.transformer_depth == (0, 3)
    want = {k[len("model.diffusion_model."):] for k in sd if k.startswith("model.diffusion_model.")}
    assert set(ours.unet.state_dict()) == want
    ref = flatten(jax_load.load_model(path).unet_params)
    assert not any(k.startswith("output_blocks.0.1.transformer_blocks.1.") for k in ref)


def jax_tree_f32(tree):
    import jax

    return jax.tree.map(lambda a: a.astype(jnp.float32), tree)


def test_fp8_storage_through_the_engine(models):
    """fp8_storage over the Engine: "Enable" stores the UNet in fp8 and
    serves; a switch back with cache_fp16_weight restores the weights bit
    for bit; "Enable for SDXL" leaves an SD1 model alone."""
    from sdwebui_tpu_torch.pipeline.params import GenerationParams
    from sdwebui_tpu_torch.server.app import Engine

    _, pm = models
    model = port_sd.from_jax(models[0], device="cpu")
    engine = Engine(device="cpu", model=model, hash_cache=None)
    before = {k: v.clone() for k, v in model.unet.state_dict().items()}
    p = dict(prompt="a cat", seed=3, steps=1, width=64, height=64)
    plain = engine.txt2img(GenerationParams(**p)).images[0]
    on = {"fp8_storage": "Enable", "cache_fp16_weight": True}
    img = engine.txt2img(GenerationParams(**p, override_settings=on)).images[0]
    assert port_sd.has_fp8(model) and model.unet_hp
    assert img.shape == plain.shape
    engine.txt2img(GenerationParams(**p, override_settings={"fp8_storage": "Disable"}))
    assert not port_sd.has_fp8(model)
    for k, v in model.unet.state_dict().items():
        assert torch.equal(v, before[k]), k
    engine.txt2img(GenerationParams(**p, override_settings={"fp8_storage": "Enable for SDXL"}))
    assert not port_sd.has_fp8(model)


def test_fp8_storage_with_sd3_raises():
    """JAX quantizes the MMDiT, whose forward has no fp8 upcast: the port
    refuses fp8_storage for SD3 (ROADMAP C)."""
    from sdwebui_tpu_torch.pipeline.params import GenerationParams
    from sdwebui_tpu_torch.server.app import Engine

    engine = Engine(device="cpu", model=port_sd.create_tiny_sd3(0, "cpu"), hash_cache=None)
    with pytest.raises(NotImplementedError, match="fp8_storage"):
        engine.txt2img(GenerationParams(prompt="a cat", steps=1, width=64, height=64,
                                        override_settings={"fp8_storage": "Enable"}))
