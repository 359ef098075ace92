"""User-facing sampler registry — the reference's sampler name surface.

Copy of ``sdwebui_tpu/sampling/registry.py``: each entry names its solver,
its forced scheduler (the "... Karras" aliases and the timestep samplers'
DDIM grid), extra solver options, whether it consumes ancestral noise
(ENSD), and whether it drops the penultimate sigma.  Tests hold the table
and ``build_sigmas`` equal to the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SamplerData:
    name: str
    solver: str
    aliases: tuple = ()
    scheduler_override: str | None = None
    extra: tuple = ()                 # (key, value) pairs for solver extra
    uses_ensd: bool = False           # ancestral/sde: eta-noise-seed-delta applies
    second_order: bool = False
    # DPM2/DPM2a sample at a midpoint below σ_min on the last step unless the
    # penultimate sigma is dropped (reference sampler option
    # `discard_next_to_last_sigma`; forced globally by the
    # always_discard_next_to_last_sigma setting)
    discard_next_to_last_sigma: bool = False


_S = SamplerData

SAMPLERS = [
    _S("DPM++ 2M", "dpmpp_2m", ("k_dpmpp_2m",)),
    _S("DPM++ SDE", "dpmpp_sde", ("k_dpmpp_sde",), uses_ensd=True, second_order=True),
    _S("DPM++ 2M SDE", "dpmpp_2m_sde", ("k_dpmpp_2m_sde",), uses_ensd=True),
    _S("DPM++ 2M SDE Heun", "dpmpp_2m_sde", ("k_dpmpp_2m_sde_heun",),
       extra=(("solver_type", "heun"),), uses_ensd=True),
    _S("DPM++ 2S a", "dpmpp_2s_ancestral", ("k_dpmpp_2s_a",), uses_ensd=True,
       second_order=True),
    _S("DPM++ 3M SDE", "dpmpp_3m_sde", ("k_dpmpp_3m_sde",), uses_ensd=True),
    _S("Euler a", "euler_ancestral", ("k_euler_a", "k_euler_ancestral"), uses_ensd=True),
    _S("Euler", "euler", ("k_euler",)),
    _S("LMS", "lms", ("k_lms",)),
    _S("Heun", "heun", ("k_heun",), second_order=True),
    _S("DPM2", "dpm_2", ("k_dpm_2",), second_order=True,
       discard_next_to_last_sigma=True),
    _S("DPM2 a", "dpm_2_ancestral", ("k_dpm_2_a",), uses_ensd=True,
       second_order=True, discard_next_to_last_sigma=True),
    _S("LCM", "lcm", ("k_lcm",), uses_ensd=True),
    _S("DPM fast", "dpm_fast", ("k_dpm_fast",), uses_ensd=True),
    _S("DPM adaptive", "dpm_adaptive", ("k_dpm_ad",), uses_ensd=True),
    _S("Restart", "restart", ("restart",), scheduler_override="karras",
       uses_ensd=True, second_order=True),
    # timestep ("CompVis") samplers — integer-timestep schedules
    _S("DDIM", "ddim", ("ddim",), scheduler_override="ddim", uses_ensd=True),
    _S("UniPC", "unipc", ("unipc",), scheduler_override="ddim",
       second_order=True),
    _S("DDIM CFG++", "ddim_cfgpp", ("ddim_cfgpp",), scheduler_override="ddim",
       uses_ensd=True),
    _S("PLMS", "plms", ("plms",), scheduler_override="ddim", second_order=True),
    # scheduler-suffix aliases kept for infotext back-compat
    _S("LMS Karras", "lms", ("k_lms_ka",), scheduler_override="karras"),
    _S("DPM2 Karras", "dpm_2", ("k_dpm_2_ka",), scheduler_override="karras",
       uses_ensd=True, second_order=True, discard_next_to_last_sigma=True),
    _S("DPM2 a Karras", "dpm_2_ancestral", ("k_dpm_2_a_ka",),
       scheduler_override="karras", uses_ensd=True, second_order=True,
       discard_next_to_last_sigma=True),
    _S("DPM++ 2S a Karras", "dpmpp_2s_ancestral", ("k_dpmpp_2s_a_ka",),
       scheduler_override="karras", uses_ensd=True, second_order=True),
]

SAMPLER_MAP = {}
for _s in SAMPLERS:
    SAMPLER_MAP[_s.name] = _s
    for _a in _s.aliases:
        SAMPLER_MAP[_a] = _s


def get_sampler(name: str) -> SamplerData:
    if name in ("", None, "Automatic"):
        name = "Euler a"
    if name not in SAMPLER_MAP:
        raise ValueError(f"unknown sampler {name!r}")
    return SAMPLER_MAP[name]


def build_sigmas(sampler: SamplerData, scheduler: str, steps: int, disc,
                 extra_params_out: dict | None = None, **kw):
    """Schedule + the reference's get_sigmas post-passes
    (modules/sd_samplers_kdiffusion.py:60-80): penultimate-sigma discard
    (per-sampler or forced by always_discard_next_to_last_sigma) and the
    use_old_karras_scheduler_sigmas compat clamp (0.1..10)."""
    from sdwebui_tpu_torch.sampling.schedulers import ALIASES, get_schedule
    from sdwebui_tpu_torch.utils.options import opts

    discard = sampler.discard_next_to_last_sigma
    if opts.get("always_discard_next_to_last_sigma", False) and not discard:
        discard = True
        if extra_params_out is not None:
            extra_params_out["Discard penultimate sigma"] = "True"
    key = ALIASES.get(scheduler, scheduler.lower() if scheduler else "automatic")
    if sampler.solver == "lcm":
        # LCM samples over the 50-entry distillation subtable (reference
        # sd_samplers_lcm.py LCMCompVisDenoiser.get_sigmas): Automatic =
        # t-uniform over the subtable; named schedules get the subtable's
        # sigma range
        from sdwebui_tpu_torch.sampling.discretization import (lcm_schedule,
                                                               lcm_subtable)

        if key == "automatic":
            sigmas = lcm_schedule(disc, steps + 1 if discard else steps)
            if discard:
                sigmas = np.concatenate([sigmas[:-2], sigmas[-1:]])
            return sigmas
        _t_full, sub_sigmas = lcm_subtable(disc)
        kw.setdefault("sigma_min", float(sub_sigmas[0]))
        kw.setdefault("sigma_max", float(sub_sigmas[-1]))
    if key == "karras" and opts.get("use_old_karras_scheduler_sigmas", False):
        kw.setdefault("sigma_min", 0.1)
        kw.setdefault("sigma_max", 10.0)
    sigmas = get_schedule(scheduler, steps + 1 if discard else steps, disc, **kw)
    if discard:
        sigmas = np.concatenate([sigmas[:-2], sigmas[-1:]])
    return sigmas
