"""The whole txt2img slice: the JAX ``process_txt2img`` and the port's on
identical weights (tiny model, 64², seeds 7 and 8, 3 steps, batch 2), both
under the f32 policy with the bf16 VAE decode off."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdwebui_tpu.pipeline import processing as jax_proc
from sdwebui_tpu.pipeline import sd_model as jax_sd
from sdwebui_tpu.pipeline.params import GenerationParams
from sdwebui_tpu.utils import devices as jax_devices
from sdwebui_tpu_torch.pipeline import processing as port_proc
from sdwebui_tpu_torch.pipeline import sd_model as port_sd
from sdwebui_tpu_torch.utils import devices as port_devices
from test_torch_models import _perturbed


@pytest.fixture(scope="module")
def models():
    jm = jax_sd.create_tiny_sd(5)
    rng = np.random.default_rng(50)
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


def _params(**kw):
    base = dict(prompt="a (red:1.2) cat [in the snow:on a hill:0.5] AND a castle :0.7",
                negative_prompt="blurry", seed=7, steps=3, width=64, height=64,
                batch_size=2, cfg_scale=7.5, override_settings={"sdtpu_vae_bf16": False})
    base.update(kw)
    return GenerationParams(**base)


def test_txt2img_matches_jax(models, f32_policies):
    """uint8 max |Δ| <= 1 on every pixel and identical infotext strings."""
    jm, pm = models
    ref = jax_proc.process_txt2img(jm, _params())
    out = port_proc.process_txt2img(pm, _params())
    ref_imgs = [np.asarray(im) for im in ref.images[ref.index_of_first_image:]]
    out_imgs = out.images[out.index_of_first_image:]
    assert len(out_imgs) == len(ref_imgs) == 2
    for a, b in zip(out_imgs, ref_imgs):
        assert a.shape == b.shape == (64, 64, 3) and a.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert out.infotexts[out.index_of_first_image:] == \
        ref.infotexts[ref.index_of_first_image:]
    assert out.all_seeds == ref.all_seeds == [7, 8]
    # the grid mirrors the JAX one: 1 row of 2 here
    assert out.index_of_first_image == ref.index_of_first_image == 1
    assert np.abs(out.images[0].astype(int) - np.asarray(ref.images[0], int)).max() <= 1


def test_same_seed_same_image(models):
    pm = models[1]
    a = port_proc.process_txt2img(pm, _params(batch_size=1, seed=123, override_settings={}))
    b = port_proc.process_txt2img(pm, _params(batch_size=1, seed=123, override_settings={}))
    np.testing.assert_array_equal(a.images[0], b.images[0])
    assert "Seed: 123" in a.infotexts[0] and "Sampler: Euler a" in a.infotexts[0]


@pytest.mark.parametrize("kw,name", [
    (dict(enable_hr=True, override_settings={"save_images_before_highres_fix": True}),
     "enable_hr"),
    (dict(restore_faces=True, override_settings={"save_images_before_face_restoration": True}),
     "restore_faces"),
    (dict(enable_hr=True, hr_prompt="a cat <lora:foo:0.5>"), "lora"),
])
def test_out_of_slice_requests_raise(models, kw, name):
    with pytest.raises(NotImplementedError, match=name):
        port_proc.process_txt2img(models[1], _params(batch_size=1, steps=1, **kw))


@pytest.mark.parametrize("kw,field", [
    (dict(enable_hr=True, hr_scale=1.5, denoising_strength=0.6,
          override_settings={"token_merging_ratio_hr": 0.5}), None),
    (dict(override_settings={"sgm_noise_multiplier": True}), "SGM noise multiplier: True"),
    (dict(override_settings={"token_merging_ratio": 0.5}), "Token merging ratio: 0.5"),
    (dict(sampler_name="Euler a", subseed=3, subseed_strength=0.3,
          override_settings={"randn_source": "GPU", "eta_noise_seed_delta": 7}), None),
    (dict(override_settings={"sd_noise_schedule": "Zero Terminal SNR"}),
     "Noise Schedule: Zero Terminal SNR"),
], ids=["token_merging_ratio_hr", "sgm_noise_multiplier", "token_merging_ratio",
        "randn_source_gpu", "sd_noise_schedule"])
def test_lifted_options_match_jax(models, f32_policies, kw, field):
    """The options the slice used to refuse, against JAX's process_txt2img:
    uint8 within 1 level, identical infotext."""
    jm, pm = models
    kw = dict(kw, batch_size=1, steps=2)
    kw["override_settings"] = {"sdtpu_vae_bf16": False, **kw["override_settings"]}
    ref = jax_proc.process_txt2img(jm, _params(**kw))
    out = port_proc.process_txt2img(pm, _params(**kw))
    assert len(out.images) == len(ref.images) == 1
    a, b = out.images[0], np.asarray(ref.images[0])
    assert a.shape == b.shape and np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert out.infotexts == ref.infotexts
    if field:
        assert field in out.infotexts[0]


def test_bf16_vae_nan_retries_in_fp32(models, monkeypatch):
    """A NaN from the bf16 decode is retried in fp32 (processing.py:523-546)."""
    pm = models[1]
    calls = []
    real = port_proc._decode_u8

    def fake(model, latents, dtype):
        calls.append(dtype)
        u8, bad = real(model, latents, dtype)
        return u8, bad or dtype == torch.bfloat16

    monkeypatch.setattr(port_proc, "_decode_u8", fake)
    z = torch.zeros(1, 4, 8, 8)
    port_proc.decode_first_stage_u8(pm, z)
    assert calls == [torch.bfloat16, torch.float32]
