"""Port sampling vs the JAX package: the numpy schedule copies, σ→t, and
CFG + Euler ancestral on a toy denoiser (inputs and noise from numpy)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdwebui_tpu.sampling import discretization as jax_disc
from sdwebui_tpu.sampling import schedulers as jax_sched
from sdwebui_tpu_torch.sampling import discretization as port_disc
from sdwebui_tpu_torch.sampling import registry as port_registry
from sdwebui_tpu_torch.sampling import schedulers as port_sched
from sdwebui_tpu_torch.sampling.registry import build_sigmas, get_sampler


def test_discretization_equals_jax():
    np.testing.assert_array_equal(port_disc.make_alphas_cumprod(),
                                  jax_disc.make_alphas_cumprod())
    a = port_disc.Discretization(port_disc.make_alphas_cumprod())
    b = jax_disc.Discretization(jax_disc.make_alphas_cumprod())
    np.testing.assert_array_equal(a.sigmas, b.sigmas)
    np.testing.assert_array_equal(a.log_sigmas, b.log_sigmas)
    s = np.asarray([0.03, 0.5, 3.3, 14.0])
    for q in (True, False):
        np.testing.assert_array_equal(a.sigma_to_t(s, q), b.sigma_to_t(s, q))
    t = np.asarray([0.0, 10.5, 999.0])
    np.testing.assert_array_equal(a.t_to_sigma(t), b.t_to_sigma(t))


@pytest.mark.parametrize("name", sorted(port_sched.ALIASES))
@pytest.mark.parametrize("n", [3, 20])
def test_schedule_copies_equal_jax(name, n):
    disc_p = port_disc.Discretization(port_disc.make_alphas_cumprod())
    disc_j = jax_disc.Discretization(jax_disc.make_alphas_cumprod())
    np.testing.assert_array_equal(port_sched.get_schedule(name, n, disc_p),
                                  jax_sched.get_schedule(name, n, disc_j))


def test_build_sigmas_matches_jax_registry():
    from sdwebui_tpu.sampling.registry import build_sigmas as jax_build
    from sdwebui_tpu.sampling.registry import get_sampler as jax_get

    disc_p = port_disc.Discretization(port_disc.make_alphas_cumprod())
    disc_j = jax_disc.Discretization(jax_disc.make_alphas_cumprod())
    for sched in ("Automatic", "Karras", "Exponential"):
        np.testing.assert_array_equal(
            build_sigmas(get_sampler("Euler a"), sched, 20, disc_p),
            jax_build(jax_get("Euler a"), sched, 20, disc_j))


def test_unported_samplers_raise_with_solver_name():
    # every name and alias of the JAX registry resolves to the same solver;
    # only a name outside it raises
    from sdwebui_tpu.sampling.registry import SAMPLER_MAP as JAX_MAP

    assert sorted(JAX_MAP) == sorted(port_registry.SAMPLER_MAP)
    for name, data in JAX_MAP.items():
        assert get_sampler(name).solver == data.solver, name
    assert get_sampler("DPM++ SDE").solver == "dpmpp_sde"
    with pytest.raises(ValueError):
        get_sampler("no such sampler")
    assert get_sampler("Automatic").name == "Euler a"


@pytest.mark.parametrize("quantize", [False, True])
def test_sigma_to_t_matches_jax(quantize):
    from sdwebui_tpu.pipeline.processing import _sigma_to_t_traced
    from sdwebui_tpu_torch.pipeline.processing import sigma_to_t

    disc = port_disc.Discretization(port_disc.make_alphas_cumprod())
    log_sigmas = np.asarray(disc.log_sigmas, np.float32)
    sigmas = np.asarray(disc.get_sigmas(20)[:-1], np.float32)
    ref = np.asarray(_sigma_to_t_traced(jnp.asarray(sigmas), jnp.asarray(log_sigmas),
                                        quantize))
    out = np.asarray([sigma_to_t(s, log_sigmas, quantize) for s in sigmas], np.float32)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-4)


def _toy_setup(skip):
    rng = np.random.default_rng(11)
    b, c, h, w, s, d = 2, 4, 8, 8, 6, 16
    x0 = rng.standard_normal((b, c, h, w), dtype=np.float32)
    cond_bank = rng.standard_normal((2, 2, s, d), dtype=np.float32)
    uncond_bank = rng.standard_normal((1, s, d), dtype=np.float32)
    steps = 5
    cond_idx = np.asarray([[0, 0, 1, 1, 1], [0, 1, 1, 1, 1]], np.int32)
    uncond_idx = np.zeros(steps, np.int32)
    weights = np.asarray([1.0, 0.6], np.float32)
    skip_mask = np.asarray([False, True, False, True, False]) if skip else None
    noise = rng.standard_normal((steps, 1, b, c, h, w), dtype=np.float32)
    disc = port_disc.Discretization(port_disc.make_alphas_cumprod())
    sigmas = np.asarray(disc.get_sigmas(steps), np.float32)
    proj = rng.standard_normal((d, c), dtype=np.float32) * 0.1
    return dict(x0=x0, cond_bank=cond_bank, uncond_bank=uncond_bank, cond_idx=cond_idx,
                uncond_idx=uncond_idx, weights=weights, skip=skip_mask, noise=noise,
                sigmas=sigmas, proj=proj)


@pytest.mark.parametrize("skip", [False, True])
def test_cfg_euler_ancestral_matches_jax(skip):
    """CFG with AND weights, per-step cond indices and NGMS skip steps
    around a toy denoiser, five Euler a steps; tolerance 1e-5 relative."""
    from sdwebui_tpu.sampling.cfg import CondSchedule as JaxSched
    from sdwebui_tpu.sampling.cfg import make_cfg_denoiser as jax_cfg
    from sdwebui_tpu.sampling.sampler import sample as jax_sample
    from sdwebui_tpu_torch.sampling.cfg import CondSchedule, make_cfg_denoiser
    from sdwebui_tpu_torch.sampling.sampler import sample

    t = _toy_setup(skip)
    proj = t["proj"]

    def jax_denoise(x, sigma, ctx, y=None, c_concat=None):   # x NHWC
        shift = jnp.einsum("nsd,dc->nc", ctx, jnp.asarray(proj))
        return x / (1.0 + sigma[:, None, None, None] ** 2) + shift[:, None, None, :]

    def port_denoise(x, sigma, ctx):                          # x NCHW
        shift = torch.einsum("nsd,dc->nc", ctx, torch.from_numpy(proj))
        return x / (1.0 + sigma ** 2) + shift[:, :, None, None]

    js = JaxSched(cond_bank=jnp.asarray(t["cond_bank"]), cond_idx=jnp.asarray(t["cond_idx"]),
                  cond_weights=jnp.asarray(t["weights"]),
                  uncond_bank=jnp.asarray(t["uncond_bank"]),
                  uncond_idx=jnp.asarray(t["uncond_idx"]), cond_scale=6.0,
                  skip_uncond=None if t["skip"] is None else jnp.asarray(t["skip"]))
    x_j = jnp.asarray(np.transpose(t["x0"], (0, 2, 3, 1))) * t["sigmas"][0]
    noise_j = jnp.asarray(np.transpose(t["noise"], (0, 1, 2, 4, 5, 3)))
    ref = jax_sample(jax_cfg(jax_denoise, js), x_j, t["sigmas"], solver="euler_ancestral",
                     noise=noise_j, mode="scan")

    ps = CondSchedule(cond_bank=torch.from_numpy(t["cond_bank"]), cond_idx=t["cond_idx"],
                      cond_weights=t["weights"], uncond_bank=torch.from_numpy(t["uncond_bank"]),
                      uncond_idx=t["uncond_idx"], cond_scale=6.0, skip_uncond=t["skip"])
    x_p = torch.from_numpy(t["x0"]) * float(t["sigmas"][0])
    out = sample(make_cfg_denoiser(port_denoise, ps), x_p, t["sigmas"], "euler_ancestral",
                 torch.from_numpy(t["noise"]))
    ref = np.transpose(np.asarray(ref), (0, 3, 1, 2))
    err = np.abs(out.numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err


def test_cfg_unported_branches_raise():
    from sdwebui_tpu_torch.sampling.cfg import CondSchedule, make_cfg_denoiser

    sched = CondSchedule(cond_bank=torch.zeros(1, 1, 2, 2), cond_idx=np.zeros((1, 1), int),
                         cond_weights=np.ones(1, np.float32), uncond_bank=torch.zeros(1, 2, 2),
                         uncond_idx=np.zeros(1, int), image_cfg_scale=1.5)
    # the edit model's CFG is ported; soft inpainting with it is not (JAX's
    # edit denoiser drops it); without it soft inpainting builds
    # (tests/test_torch_inpaint.py holds it against JAX)
    with pytest.raises(NotImplementedError, match="soft inpainting"):
        make_cfg_denoiser(lambda *a: None, sched, soft_inpainting=(1.0, 0.5, 4.0))
    sched.image_cfg_scale = None
    assert callable(make_cfg_denoiser(lambda *a: None, sched, soft_inpainting=(1.0, 0.5, 4.0)))
