"""Sampler names the port runs, copied from ``sdwebui_tpu/sampling/registry.py``.

DPM++ 2M and Euler a are ported; every other name of the JAX registry
raises ``NotImplementedError`` naming its solver, so a request never falls
back to a different sampler.
"""

from __future__ import annotations

import dataclasses

from sdwebui_tpu_torch.sampling.schedulers import get_schedule


@dataclasses.dataclass(frozen=True)
class SamplerData:
    name: str
    solver: str
    aliases: tuple = ()


SAMPLERS = [   # in the JAX registry's order
    SamplerData("DPM++ 2M", "dpmpp_2m", ("k_dpmpp_2m",)),
    SamplerData("Euler a", "euler_ancestral", ("k_euler_a", "k_euler_ancestral")),
]

#: names of the JAX registry whose solvers are not ported yet
UNPORTED = {
    "DPM++ SDE": "dpmpp_sde", "DPM++ 2M SDE": "dpmpp_2m_sde",
    "DPM++ 2M SDE Heun": "dpmpp_2m_sde", "DPM++ 2S a": "dpmpp_2s_ancestral",
    "DPM++ 3M SDE": "dpmpp_3m_sde", "Euler": "euler", "LMS": "lms", "Heun": "heun",
    "DPM2": "dpm_2", "DPM2 a": "dpm_2_ancestral", "LCM": "lcm",
    "DPM fast": "dpm_fast", "DPM adaptive": "dpm_adaptive", "Restart": "restart",
    "DDIM": "ddim", "UniPC": "unipc", "DDIM CFG++": "ddim_cfgpp", "PLMS": "plms",
    "LMS Karras": "lms", "DPM2 Karras": "dpm_2", "DPM2 a Karras": "dpm_2_ancestral",
    "DPM++ 2S a Karras": "dpmpp_2s_ancestral",
}

SAMPLER_MAP = {}
for _s in SAMPLERS:
    SAMPLER_MAP[_s.name] = _s
    for _a in _s.aliases:
        SAMPLER_MAP[_a] = _s


def get_sampler(name: str) -> SamplerData:
    if name in ("", None, "Automatic"):
        name = "Euler a"
    if name in SAMPLER_MAP:
        return SAMPLER_MAP[name]
    if name in UNPORTED:
        raise NotImplementedError(
            f"sampler {name!r} (solver {UNPORTED[name]}) is not ported yet")
    raise ValueError(f"unknown sampler {name!r}")


def build_sigmas(sampler: SamplerData, scheduler: str, steps: int, disc,
                 is_sdxl: bool = False):
    """Schedule for `steps` steps (the JAX build_sigmas post-passes —
    penultimate-sigma discard and the old Karras clamp — belong to options
    the port rejects); is_sdxl picks Align Your Steps' SDXL table."""
    from sdwebui_tpu_torch.utils.options import opts

    for opt in ("always_discard_next_to_last_sigma", "use_old_karras_scheduler_sigmas"):
        if opts.get(opt, False):
            raise NotImplementedError(f"option {opt!r} is not ported yet")
    return get_schedule(scheduler, steps, disc, is_sdxl=is_sdxl)
