"""The port's solvers and sampler names against the JAX package.

Every solver runs against JAX's step function on the same x, sigmas and
noise (numpy-seeded) around an analytic denoiser, in f32, to
max|Δ| <= 1e-5 · max|ref|, with the same model calls (DPM adaptive's
accept/reject sequence included).  Every sampler name of the JAX registry
runs through the port's tiny txt2img; one name of each kind is held
against JAX's process_txt2img within 1 uint8 level, with identical
infotext."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdwebui_tpu.pipeline import processing as jax_proc
from sdwebui_tpu.pipeline import sd_model as jax_sd
from sdwebui_tpu.pipeline.params import GenerationParams
from sdwebui_tpu.sampling import sampler as jax_sampler
from sdwebui_tpu.sampling import solvers as jax_solvers
from sdwebui_tpu.sampling.registry import SAMPLERS as JAX_SAMPLERS
from sdwebui_tpu.utils import devices as jax_devices
from sdwebui_tpu_torch.pipeline import processing as port_proc
from sdwebui_tpu_torch.pipeline import sd_model as port_sd
from sdwebui_tpu_torch.sampling import sampler as port_sampler
from sdwebui_tpu_torch.sampling import schedulers as port_sched
from sdwebui_tpu_torch.sampling import solvers as port_solvers
from sdwebui_tpu_torch.sampling.registry import SAMPLERS
from sdwebui_tpu_torch.utils import devices as port_devices
from test_torch_models import _perturbed

REL_TOL = 1e-5
SHAPE = (2, 4, 8, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models' ops are too small to split over threads; with
    several test workers on the machine's cores, extra threads only wait
    on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model(calls, cfgpp=False):
    def model(x, sigma, i):
        jax.debug.callback(lambda: calls.append(1))
        s = jnp.asarray(sigma, jnp.float32)
        den = x / (1.0 + s * s) + 0.1 * jnp.tanh(x) * (s / (1.0 + s)) \
            + 0.01 * jnp.asarray(i, jnp.float32)
        return jnp.stack([den, 0.9 * den + 0.05]) if cfgpp else den
    return model


def _port_model(calls, cfgpp=False):
    def model(x, sigma, i):
        calls.append(1)
        s = np.float32(sigma)
        den = x / float(np.float32(1) + s * s) + 0.1 * torch.tanh(x) * float(
            s / (np.float32(1) + s)) + float(np.float32(0.01) * np.float32(i))
        return torch.stack([den, 0.9 * den + 0.05]) if cfgpp else den
    return model


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal(SHAPE, dtype=np.float32)
    noise = rng.standard_normal((n, 2, *SHAPE), dtype=np.float32)
    sigmas = port_sched.karras(n, 0.0292, 14.61).astype(np.float32)
    return x0 * sigmas[0], sigmas, noise


CASES = [(name, {}) for name in sorted(port_solvers.SOLVERS)] + [
    ("euler", {"s_churn": 1.0, "s_tmin": 0.05, "s_tmax": 10.0}),
    ("heun", {"s_churn": 0.5}),
    ("dpm_2", {"s_churn": 2.0, "s_noise": 1.003}),
    ("dpmpp_2m_sde", {"solver_type": "heun"}),
    ("dpmpp_sde", {"eta": 0.6, "s_noise": 0.98}),
    ("ddim", {"eta": 0.7}),
    ("dpm_fast", {"eta": 0.0}),
    ("dpm_adaptive", {"eta": 0.0}),
]


@pytest.mark.parametrize("solver,extra", CASES,
                         ids=[f"{s}-{'-'.join(e) or 'default'}" for s, e in CASES])
def test_solver_matches_jax_step(solver, extra):
    # Restart at 24 steps so its plan holds a restart segment (its noise
    # then follows the plan); the others at 7
    n = 24 if solver == "restart" else 7
    x, sigmas, noise = _inputs(n, seed=len(solver))
    j_extra, p_extra = dict(extra), dict(extra)
    if solver == "restart":
        pairs, _ = jax_solvers.build_restart_plan(sigmas)
        reps = -(-len(pairs) // n)
        noise = np.tile(noise, (reps, 1, 1, 1, 1, 1))[:len(pairs)]
    if solver == "unipc":
        j_extra.update(unipc_order_setting=2, unipc_variant="bh2")
        p_extra.update(uni_pc_order=2, uni_pc_variant="bh2")
    cfgpp = solver == "ddim_cfgpp"
    j_calls, p_calls = [], []
    ref = jax_sampler.sample(_jax_model(j_calls, cfgpp), jnp.asarray(x), sigmas, solver=solver,
                             noise=jnp.asarray(noise), extra=j_extra, mode="stepwise")
    ref = np.asarray(jax.block_until_ready(ref))
    out = port_sampler.sample(_port_model(p_calls, cfgpp), torch.from_numpy(x), sigmas,
                              solver, torch.from_numpy(noise), p_extra).numpy()
    assert np.isfinite(ref).all() and out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= REL_TOL * np.abs(ref).max(), (err, np.abs(ref).max())
    assert len(p_calls) == len(j_calls)
    spec = port_solvers.SOLVERS[solver]
    expected = spec.model_calls(len(noise) if solver == "restart" else n)
    assert expected is None or expected == len(p_calls)


def test_adaptive_rejects_and_counts_like_jax():
    """DPM adaptive over a stiff schedule, where the controller rejects
    steps: the port's accept/reject sequence is JAX's (same model calls)."""
    x, sigmas, noise = _inputs(8, seed=3)
    j_calls, p_calls = [], []
    extra = {"dpm_rtol": 0.01, "dpm_atol": 0.001}
    jax_sampler.sample(_jax_model(j_calls), jnp.asarray(x), sigmas, solver="dpm_adaptive",
                       noise=jnp.asarray(noise), extra=extra)
    port_sampler.sample(_port_model(p_calls), torch.from_numpy(x), sigmas, "dpm_adaptive",
                        torch.from_numpy(noise), extra)
    assert len(p_calls) == len(j_calls) and len(j_calls) % 3 == 0 and len(j_calls) > 3 * 8


def test_host_tables_equal_jax():
    """LMS's and UniPC's coefficients and Restart's plan are copies."""
    for n in (3, 10, 20, 40):
        sig = port_sched.karras(n, 0.03, 14.6)
        np.testing.assert_array_equal(port_solvers.lms_coefficients(sig),
                                      jax_solvers.lms_coefficients(sig))
        for order, variant, lof in ((3, "bh1", True), (2, "bh2", False), (1, "bh1", True)):
            a = port_solvers.unipc_coefficients(sig, order, variant, lof)
            b = jax_solvers.unipc_coefficients(sig, order, variant, lof)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for pa, pb in zip(port_solvers.build_restart_plan(sig),
                          jax_solvers.build_restart_plan(sig)):
            np.testing.assert_array_equal(pa, pb)
    assert [port_solvers.dpm_fast_orders(n) for n in range(1, 12)] == \
        [jax_solvers.dpm_fast_orders(n) for n in range(1, 12)]
    for name, spec in jax_solvers.SOLVERS.items():
        ours = port_solvers.SOLVERS[name]
        for f in dataclasses.fields(spec):
            if f.name not in ("step", "custom_driver"):
                assert getattr(ours, f.name) == getattr(spec, f.name), (name, f.name)


def test_registry_table_equals_jax():
    assert [dataclasses.asdict(s) for s in SAMPLERS] == \
        [dataclasses.asdict(s) for s in JAX_SAMPLERS]
    assert len(SAMPLERS) == 24


# --------------------------------------------------------------------------
# the sampler names through txt2img
# --------------------------------------------------------------------------

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


_CHURN = ("euler", "heun", "dpm_2")
_TIMESTEP = ("ddim", "ddim_cfgpp", "plms", "unipc")


def _params(name, steps=4, **kw):
    """A request for `name` with the options its kind reads: ENSD, churn
    for the churn solvers, eta for DDIM."""
    data = next(s for s in SAMPLERS if s.name == name)
    override = {"sdtpu_vae_bf16": False, "eta_noise_seed_delta": 31337}
    if data.solver in _CHURN:
        kw.setdefault("s_churn", 0.5)
    if data.solver in ("ddim", "ddim_cfgpp"):
        kw.setdefault("eta", 0.4)
    base = dict(prompt="a red cat", negative_prompt="blurry", seed=11, steps=steps,
                width=64, height=64, batch_size=1, cfg_scale=6.0, sampler_name=name,
                override_settings=override)
    base.update(kw)
    return GenerationParams(**base)


@pytest.mark.parametrize("name", [s.name for s in SAMPLERS])
def test_every_sampler_name_runs(models, name):
    data = next(s for s in SAMPLERS if s.name == name)
    res = port_proc.process_txt2img(models[1], _params(name, steps=3))
    img, info = res.images[0], res.infotexts[0]
    assert img.shape == (64, 64, 3) and img.dtype == np.uint8
    assert f"Sampler: {name}," in info and "Steps: 3," in info and "Seed: 11," in info
    assert ("ENSD: 31337" in info) == data.uses_ensd
    assert ("Sigma churn: 0.5" in info) == (data.solver in _CHURN)
    assert ("Eta: 0.4" in info) == (data.solver in ("ddim", "ddim_cfgpp"))


def test_discard_penultimate_sigma_option(models):
    res = port_proc.process_txt2img(models[1], _params(
        "Euler", steps=3, override_settings={"always_discard_next_to_last_sigma": True}))
    assert "Discard penultimate sigma: True" in res.infotexts[0]


@pytest.mark.parametrize("name,steps", [
    ("Euler", 4), ("DPM++ SDE", 4), ("DPM++ 3M SDE", 4), ("LMS Karras", 4), ("DDIM", 4),
    ("UniPC", 4), ("LCM", 4), ("Restart", 20), ("DPM adaptive", 4)])
def test_sampler_kinds_match_jax_txt2img(models, f32_policies, name, steps):
    """uint8 max|Δ| <= 1 and identical infotext, one name of each kind."""
    jm, pm = models
    ref = jax_proc.process_txt2img(jm, _params(name, steps))
    out = port_proc.process_txt2img(pm, _params(name, steps))
    a, b = out.images[0].astype(int), np.asarray(ref.images[0]).astype(int)
    assert a.shape == b.shape == (64, 64, 3)
    assert np.abs(a - b).max() <= 1
    if next(s for s in SAMPLERS if s.name == name).uses_ensd:
        assert out.infotexts == ref.infotexts
    else:   # JAX records ENSD for every sampler, the port as the reference does
        assert [t.replace(", ENSD: 31337", "") for t in ref.infotexts] == out.infotexts
