"""The options of this slice through whole requests, the port's
``process_txt2img`` against JAX's on identical tiny weights (f32 policies,
uint8 within 1 level, identical infotext): hypertile and old emphasis
(ToMe, Zero Terminal SNR, the SGM multiplier and the device noise source:
``test_torch_pipeline``; upcast_attn, a no-op under the f32 policy: the
UNet's tests in ``test_torch_options``); the schedule overrides' tables;
old emphasis's tokens; the persistent cond cache; the attention options of
each kind.  Pruned files and fp8 storage: ``test_torch_fp8_ssd``."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)
import numpy as np
import pytest

from sdwebui_tpu.pipeline import processing as jax_proc
from sdwebui_tpu_torch.pipeline import processing as port_proc
from sdwebui_tpu_torch.pipeline import sd_model as port_sd
from test_torch_pipeline import _params, f32_policies, models  # noqa: F401


def _same(out, ref, n=1):
    ref_imgs = [np.asarray(im) for im in ref.images[ref.index_of_first_image:]]
    out_imgs = out.images[out.index_of_first_image:]
    assert len(out_imgs) == len(ref_imgs) == n
    for a, b in zip(out_imgs, ref_imgs):
        assert a.shape == b.shape and np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert out.infotexts[out.index_of_first_image:] == ref.infotexts[ref.index_of_first_image:]


REQUESTS = {
    # 192²: a 24² latent, split into 2 × 2 tiles by hypertile's smallest
    # tile (16); the 12² level is untiled (h·w < tile²)
    "hypertile": dict(width=192, height=192, override_settings={
        "hypertile_enable_unet": True, "hypertile_max_tile_unet": 64}),
    "old_emphasis": dict(prompt="a ((red)) cat, [blurry] (snow:1.3)",
                         override_settings={"use_old_emphasis_implementation": True}),
}


@pytest.mark.parametrize("name", list(REQUESTS))
def test_txt2img_options_match_jax(models, f32_policies, name):
    jm, pm = models
    kw = dict(REQUESTS[name], batch_size=1, steps=2)
    kw["override_settings"] = {"sdtpu_vae_bf16": False, **kw["override_settings"]}
    ref = jax_proc.process_txt2img(jm, _params(**kw))
    out = port_proc.process_txt2img(pm, _params(**kw))
    _same(out, ref)
    text = out.infotexts[-1]


@pytest.mark.parametrize("overrides", [{"use_downcasted_alpha_bar": True},
                                       {"sd_noise_schedule": "Zero Terminal SNR"},
                                       {"use_downcasted_alpha_bar": True,
                                        "sd_noise_schedule": "Zero Terminal SNR"}],
                         ids=["downcast", "ztsnr", "both"])
def test_schedule_overrides_match_jax(models, overrides):
    """apply_schedule_overrides: the sigma table and the infotext fields of
    JAX's _apply_schedule_overrides (processing.py:1260-1284), exactly."""
    from sdwebui_tpu.utils.options import opts as jax_opts

    jm, pm = models
    jp, pp = _params(), _params()
    with port_proc.opts.override(overrides), jax_opts.override(overrides):
        ours = port_proc.apply_schedule_overrides(pm, pp)
        ref = jax_proc._apply_schedule_overrides(jm, jp)
    np.testing.assert_array_equal(ours.disc.sigmas, np.asarray(ref.disc.sigmas))
    assert pp.extra_generation_params == jp.extra_generation_params
    assert ours is not pm and port_proc.apply_schedule_overrides(pm, _params()) is pm


def test_old_emphasis_tokens_match_jax(models):
    jm, pm = models
    prompts = ["a ((red)) cat, [blurry] (snow:1.3)", "(((x))) " * 40, "plain words", ""]
    from sdwebui_tpu_torch.utils.options import opts

    with opts.override({"use_old_emphasis_implementation": True}):
        from sdwebui_tpu.utils.options import opts as jax_opts

        with jax_opts.override({"use_old_emphasis_implementation": True}):
            for text in prompts:
                (ours,), n = pm.conditioner.tokenize_line(text)
                (ref,), m = jm.conditioner.tokenize_line(text)
                assert n == m and ours.tokens == ref.tokens
                assert ours.multipliers == ref.multipliers


def test_cond_cache_hit_counts_no_second_encode(models, monkeypatch):
    _, pm = models
    port_proc._COND_CACHE.clear()
    calls = []
    real = port_proc._encode_conds
    monkeypatch.setattr(port_proc, "_encode_conds",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    kw = dict(batch_size=1, steps=1, override_settings={"sdtpu_vae_bf16": False})
    a = port_proc.process_txt2img(pm, _params(**kw))
    b = port_proc.process_txt2img(pm, _params(**kw))
    assert len(calls) == 1
    np.testing.assert_array_equal(a.images[0], b.images[0])
    port_proc.process_txt2img(pm, _params(**dict(kw, prompt="another")))
    assert len(calls) == 2
    with port_proc.opts.override({"persistent_cond_cache": False}):
        port_proc.process_txt2img(pm, _params(**kw))
    assert len(calls) == 3
    # an option that changes the tokens is part of the key
    kw["override_settings"] = dict(kw["override_settings"], use_old_emphasis_implementation=True)
    port_proc.process_txt2img(pm, _params(**kw))
    assert len(calls) == 4
    port_proc._COND_CACHE.clear()


def test_attention_options_per_kind():
    """apply_attention_options: the tile and each kind's ratio
    (processing.py:1115-1147)."""
    m = port_sd.create_tiny_sd(0, "cpu")
    o = port_proc.opts
    with o.override({"hypertile_enable_unet": True, "hypertile_max_tile_unet": 512,
                     "token_merging_ratio": 0.4, "token_merging_ratio_hr": 0.6}):
        cfgs = {k: port_proc.apply_attention_options(m, k).unet_cfg
                for k in ("txt2img", "img2img", "hr")}
    assert {c.hypertile_tile for c in cfgs.values()} == {64}
    assert [cfgs[k].tome_ratio for k in ("txt2img", "img2img", "hr")] == [0.4, 0.4, 0.6]
    with o.override({"hypertile_enable_unet": True, "hypertile_max_tile_unet": 8}):
        assert port_proc.apply_attention_options(m).unet_cfg.hypertile_tile == 16
    assert port_proc.apply_attention_options(m) is m
