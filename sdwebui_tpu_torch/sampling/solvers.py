"""Diffusion solvers as step functions.

Port of ``sdwebui_tpu/sampling/solvers.py:35-826``: every solver is

    step(model, x, i, sigmas, noise, state, extra) -> (x_next, state)

with ``model(x, sigma, i) -> denoised``, ``sigmas`` a host float32 array
and ``noise`` the step's (noises_per_step, B, C, H, W) slice.  The scalar
arithmetic runs on the host in float32, as the JAX scan does on device.
Where JAX picks between two branches with ``jnp.where``, only the chosen
one is computed here, but every model call JAX makes is made (the
discarded second call of a step to σ = 0 included), so a run's model
calls are ``SolverSpec.model_calls``.  DPM fast and DPM adaptive are
whole-run drivers; adaptive's ``lax.while_loop`` is a Python loop that
reads one error scalar per step to accept or reject it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

F32 = np.float32
_EPS = F32(1e-12)
_ZERO, _ONE, _HALF, _TWO = F32(0), F32(1), F32(0.5), F32(2)


def _log(s):
    return np.log(np.maximum(F32(s), _EPS))


def _to_d(x, sigma, denoised):
    return (x - denoised) / float(np.maximum(F32(sigma), _EPS))


def _ancestral(sigma_from, sigma_to, eta):
    sf, st, eta = F32(sigma_from), F32(sigma_to), F32(eta)
    su = np.minimum(st, eta * np.sqrt(np.maximum(
        st ** 2 * (sf ** 2 - st ** 2) / np.maximum(sf ** 2, _EPS), _ZERO)))
    sd = np.sqrt(np.maximum(st ** 2 - su ** 2, _ZERO))
    return sd, su


def _s_noise(extra):
    return F32(extra.get("s_noise", 1.0))


# --------------------------------------------------------------------------
# first order
# --------------------------------------------------------------------------

def _apply_churn(x, s, sigmas, noise, extra):
    """Karras stochastic churn (solvers.py:58-74): σ → σ̂ = σ·(γ+1) inside
    [s_tmin, s_tmax], with fresh noise for the rise.  Returns (x̂, σ̂)."""
    s_churn = float(extra.get("s_churn", 0.0) or 0.0)
    if s_churn <= 0:
        return x, s
    s_tmin = float(extra.get("s_tmin", 0.0) or 0.0)
    s_tmax = float(extra.get("s_tmax", 0.0) or 0.0) or float("inf")
    gamma_max = min(s_churn / (len(sigmas) - 1), 2 ** 0.5 - 1)
    gamma = F32(gamma_max) if s_tmin <= s <= s_tmax else _ZERO
    s_hat = s * (gamma + _ONE)
    x = x + noise[0] * float(_s_noise(extra)) * float(
        np.sqrt(np.maximum(s_hat ** 2 - s ** 2, _ZERO)))
    return x, s_hat


def euler_step(model, x, i, sigmas, noise, state, extra):
    s, s_next = sigmas[i], sigmas[i + 1]
    x, s = _apply_churn(x, s, sigmas, noise, extra)
    denoised = model(x, s, i)
    return x + _to_d(x, s, denoised) * float(s_next - s), state


def euler_ancestral_step(model, x, i, sigmas, noise, state, extra):
    s, s_next = sigmas[i], sigmas[i + 1]
    denoised = model(x, s, i)
    sd, su = _ancestral(s, s_next, extra.get("eta", 1.0))
    x = x + _to_d(x, s, denoised) * float(sd - s)
    if s_next > 0:
        x = x + noise[0] * float(su * _s_noise(extra))
    return x, state


# --------------------------------------------------------------------------
# second order (2 model calls)
# --------------------------------------------------------------------------

def heun_step(model, x, i, sigmas, noise, state, extra):
    s, s_next = sigmas[i], sigmas[i + 1]
    x, s = _apply_churn(x, s, sigmas, noise, extra)
    denoised = model(x, s, i)
    d = _to_d(x, s, denoised)
    dt = float(s_next - s)
    x_euler = x + d * dt
    denoised_2 = model(x_euler, np.maximum(s_next, _EPS), i)
    if s_next <= 0:
        return x_euler, state
    return x + (d + _to_d(x_euler, s_next, denoised_2)) / 2 * dt, state


def dpm_2_step(model, x, i, sigmas, noise, state, extra):
    s, s_next = sigmas[i], sigmas[i + 1]
    x, s = _apply_churn(x, s, sigmas, noise, extra)
    denoised = model(x, s, i)
    d = _to_d(x, s, denoised)
    # the log-space midpoint of k-diffusion's sample_dpm_2 (solvers.py:118)
    s_mid = np.exp((_log(s) + _log(np.maximum(s_next, _EPS))) / _TWO)
    x_2 = x + d * float(s_mid - s)
    denoised_2 = model(x_2, s_mid, i)
    if s_next <= 0:
        return x + d * float(s_next - s), state
    return x + _to_d(x_2, s_mid, denoised_2) * float(s_next - s), state


def dpm_2_ancestral_step(model, x, i, sigmas, noise, state, extra):
    s, s_next = sigmas[i], sigmas[i + 1]
    denoised = model(x, s, i)
    sd, su = _ancestral(s, s_next, extra.get("eta", 1.0))
    d = _to_d(x, s, denoised)
    s_mid = np.exp((_log(s) + _log(np.maximum(sd, _EPS))) / _TWO)
    x_2 = x + d * float(s_mid - s)
    denoised_2 = model(x_2, s_mid, i)
    if sd <= 0:
        return x + d * float(sd - s), state
    x = x + _to_d(x_2, s_mid, denoised_2) * float(sd - s)
    return x + noise[0] * float(su * _s_noise(extra)), state


def dpmpp_2s_ancestral_step(model, x, i, sigmas, noise, state, extra):
    s, s_next = sigmas[i], sigmas[i + 1]
    denoised = model(x, s, i)
    sd, su = _ancestral(s, s_next, extra.get("eta", 1.0))
    t, t_next = -_log(s), -_log(sd)
    h = t_next - t
    s_mid = np.exp(-(t + _HALF * h))
    x_2 = x * float(s_mid / np.maximum(s, _EPS)) - denoised * float(np.expm1(-h * _HALF))
    denoised_2 = model(x_2, s_mid, i)
    if sd > 0:
        x = x * float(np.maximum(sd, _EPS) / np.maximum(s, _EPS)) \
            - denoised_2 * float(np.expm1(-h))
    else:
        x = x + _to_d(x, s, denoised) * float(sd - s)
    return x + noise[0] * float(su * _s_noise(extra)), state


def dpmpp_sde_step(model, x, i, sigmas, noise, state, extra):
    s, s_next = sigmas[i], sigmas[i + 1]
    eta, s_noise, r = extra.get("eta", 1.0), _s_noise(extra), F32(extra.get("r", 0.5))
    denoised = model(x, s, i)
    t, t_next = -_log(s), -_log(s_next)
    h = t_next - t
    fac = _ONE / (_TWO * r)
    sig_s = np.exp(-(t + h * r))
    sd_1, su_1 = _ancestral(s, sig_s, eta)
    t_d1 = -_log(sd_1)
    x_2 = x * float(np.exp(-t_d1) / np.maximum(s, _EPS)) - denoised * float(np.expm1(t - t_d1))
    x_2 = x_2 + noise[0] * float(su_1 * s_noise)
    denoised_2 = model(x_2, sig_s, i)
    if s_next <= 0:
        return x + _to_d(x, s, denoised) * float(s_next - s), state
    sd_2, su_2 = _ancestral(s, s_next, eta)
    t_d2 = -_log(sd_2)
    denoised_d = denoised * float(_ONE - fac) + denoised_2 * float(fac)
    x = x * float(np.exp(-t_d2) / np.maximum(s, _EPS)) - denoised_d * float(np.expm1(t - t_d2))
    return x + noise[1] * float(su_2 * s_noise), state


# --------------------------------------------------------------------------
# multistep (1 model call, carried history)
# --------------------------------------------------------------------------

def _h_ratio(sigmas, i, h):
    """r = h_last / h of the multistep solvers (h == 0 guarded)."""
    h_last = -_log(sigmas[i]) + _log(sigmas[max(i - 1, 0)])
    return h_last / (h if h != 0 else _EPS)


def dpmpp_2m_step(model, x, i, sigmas, noise, state, extra):
    """DPM-Solver++(2M): the previous denoised carried in `state`.  The
    first step (and a step to σ = 0) is first order, so a fresh run — the
    refiner handoff — restarts the history."""
    s, s_next = sigmas[i], sigmas[i + 1]
    denoised = model(x, s, i)
    h = -_log(s_next) + _log(s)
    if i > 0 and s_next != 0:
        c = _ONE / (_TWO * _h_ratio(sigmas, i, h))
        denoised_d = denoised * float(_ONE + c) - state["old_denoised"] * float(c)
    else:
        denoised_d = denoised
    x = x * float(s_next / np.maximum(s, _EPS)) - denoised_d * float(np.expm1(-h))
    return x, {"old_denoised": denoised}


def dpmpp_2m_sde_step(model, x, i, sigmas, noise, state, extra):
    s, s_next = sigmas[i], sigmas[i + 1]
    eta = F32(extra.get("eta", 1.0))
    denoised = model(x, s, i)
    new_state = {"old_denoised": denoised}
    if s_next <= 0:
        return denoised, new_state
    h = -_log(s_next) + _log(s)
    eta_h = eta * h
    em = -np.expm1(-h - eta_h)
    x_new = x * float(s_next / np.maximum(s, _EPS) * np.exp(-eta_h)) + denoised * float(em)
    if i > 0:
        inv_r = _ONE / _h_ratio(sigmas, i, h)
        if extra.get("solver_type", "midpoint") == "heun":
            den = -h - eta_h
            coef = (em / (den if den != 0 else _EPS) + _ONE) * inv_r
        else:
            coef = _HALF * em * inv_r
        x_new = x_new + (denoised - state["old_denoised"]) * float(coef)
    return x_new + noise[0] * float(
        s_next * np.sqrt(np.maximum(-np.expm1(-_TWO * eta_h), _ZERO)) * _s_noise(extra)), \
        new_state


def dpmpp_3m_sde_step(model, x, i, sigmas, noise, state, extra):
    s, s_next = sigmas[i], sigmas[i + 1]
    eta = F32(extra.get("eta", 1.0))
    denoised = model(x, s, i)
    h = -_log(s_next) + _log(s)
    new_state = {"denoised_2": state["denoised_1"], "denoised_1": denoised,
                 "h_2": state["h_1"], "h_1": h}
    if s_next <= 0:
        return denoised, new_state
    h_eta = h * (eta + _ONE)
    x_new = x * float(np.exp(-h_eta)) + denoised * float(-np.expm1(-h_eta))
    if i >= 1:
        hh = h if h != 0 else _EPS
        he = h_eta if h_eta != 0 else _EPS
        r0 = state["h_1"] / hh
        phi_2 = np.expm1(-h_eta) / he + _ONE
        d1_0 = (denoised - state["denoised_1"]) / float(r0 if r0 != 0 else _EPS)
        if i == 1:
            x_new = x_new + d1_0 * float(phi_2)
        else:
            r1 = state["h_2"] / hh
            d1_1 = (state["denoised_1"] - state["denoised_2"]) / float(r1 if r1 != 0 else _EPS)
            rr = np.maximum(r0 + r1, _EPS)
            d1 = d1_0 + (d1_0 - d1_1) * float(r0 / rr)
            d2 = (d1_0 - d1_1) / float(rr)
            phi_3 = phi_2 / he - _HALF
            x_new = x_new + (d1 * float(phi_2) - d2 * float(phi_3))
    x_new = x_new + noise[0] * float(
        s_next * np.sqrt(np.maximum(-np.expm1(-_TWO * h * eta), _ZERO)) * _s_noise(extra))
    return x_new, new_state


def lms_step(model, x, i, sigmas, noise, state, extra):
    """Linear multistep (order ≤ 4) with host-precomputed coefficients."""
    s = sigmas[i]
    d = _to_d(x, s, model(x, s, i))
    ds = [d] + state["ds"][:3]                    # newest first
    coeffs = extra["lms_coeffs"][i]
    x = x + sum(d_j * float(c) for c, d_j in zip(coeffs, ds))
    return x, {"ds": ds}


def lms_coefficients(sigmas: np.ndarray, order: int = 4) -> np.ndarray:
    """(n, order) integrated Lagrange coefficients (k-diffusion's
    linear_multistep_coeff; a copy of solvers.py:293-312)."""
    import scipy.integrate

    sigmas = np.asarray(sigmas, dtype=np.float64)
    n = len(sigmas) - 1
    out = np.zeros((n, order))
    for i in range(n):
        cur_order = min(i + 1, order)
        for j in range(cur_order):
            def fn(tau):
                prod = 1.0
                for k in range(cur_order):
                    if k == j:
                        continue
                    prod *= (tau - sigmas[i - k]) / (sigmas[i - j] - sigmas[i - k])
                return prod
            out[i, j] = scipy.integrate.quad(fn, sigmas[i], sigmas[i + 1], epsrel=1e-4)[0]
    return out


# --------------------------------------------------------------------------
# timestep ("CompVis") samplers in VE sigma space (solvers.py:316-385)
# --------------------------------------------------------------------------

def _ddim_coeffs(s, s_next, eta):
    a = _ONE / (_ONE + s ** 2)
    a_prev = _ONE / (_ONE + s_next ** 2)
    s_vp = F32(eta) * np.sqrt(np.maximum(
        (_ONE - a_prev) / np.maximum(_ONE - a, _EPS) * (_ONE - a / a_prev), _ZERO))
    dir_coeff = np.sqrt(np.maximum((_ONE - a_prev) / a_prev - s_vp ** 2 / a_prev, _ZERO))
    return dir_coeff, s_vp / np.sqrt(a_prev)


def ddim_step(model, x, i, sigmas, noise, state, extra):
    s, s_next = sigmas[i], sigmas[i + 1]
    dir_coeff, noise_coeff = _ddim_coeffs(s, s_next, extra.get("eta", 0.0))
    denoised = model(x, s, i)
    x = denoised + _to_d(x, s, denoised) * float(dir_coeff)
    return x + noise[0] * float(noise_coeff * _s_noise(extra)), state


def ddim_cfgpp_step(model, x, i, sigmas, noise, state, extra):
    """DDIM CFG++: x0 from the CFG combine, the noise direction from the
    unconditional prediction; `model` returns stacked [cfg, uncond]."""
    s, s_next = sigmas[i], sigmas[i + 1]
    dir_coeff, noise_coeff = _ddim_coeffs(s, s_next, extra.get("eta", 0.0))
    both = model(x, s, i)
    x = both[0] + _to_d(x, s, both[1]) * float(dir_coeff)
    return x + noise[0] * float(noise_coeff * _s_noise(extra)), state


def plms_step(model, x, i, sigmas, noise, state, extra):
    """Pseudo linear multistep: Adams-Bashforth on ε with an RK2 priming
    step at i == 0."""
    s, s_next = sigmas[i], sigmas[i + 1]
    e_t = _to_d(x, s, model(x, s, i))
    old = state["eps_hist"]                       # newest first

    def x_prev_for(e):
        return (x - e * float(s)) + e * float(s_next)

    if i == 0:
        s_2 = np.maximum(s_next, _EPS)
        x_1 = x_prev_for(e_t)
        e_prime = (e_t + _to_d(x_1, s_2, model(x_1, s_2, i))) / 2
    elif i == 1:
        e_prime = (3 * e_t - old[0]) / 2
    elif i == 2:
        e_prime = (23 * e_t - 16 * old[0] + 5 * old[1]) / 12
    else:
        e_prime = (55 * e_t - 59 * old[0] + 37 * old[1] - 9 * old[2]) / 24
    return x_prev_for(e_prime), {"eps_hist": [e_t] + old[:2]}


# --------------------------------------------------------------------------
# Restart sampling (Xu et al. 2023; solvers.py:392-453)
# --------------------------------------------------------------------------

def restart_step(model, x, i, sigmas, noise, state, extra):
    """Heun over the plan's (old, new) sigma pairs, with noise re-injected
    at each upward jump (build_restart_plan)."""
    s, s_next = extra["restart_pairs"][i]
    scale = extra["restart_noise_scale"][i]
    if scale != 0:
        x = x + noise[0] * float(scale * _s_noise(extra))
    denoised = model(x, s, i)
    d = _to_d(x, s, denoised)
    dt = float(s_next - s)
    x_euler = x + d * dt
    denoised_2 = model(x_euler, np.maximum(s_next, _EPS), i)
    if s_next <= 0:
        return x_euler, state
    return x + (d + _to_d(x_euler, s_next, denoised_2)) / 2 * dt, state


def build_restart_plan(sigmas: np.ndarray, restart_list: dict | None = None):
    """(pairs (n, 2), noise_scale (n,)): the reference's automatic restart
    segments, with the Karras re-schedule for >= 20 steps (a copy of
    solvers.py:409-453)."""
    from sdwebui_tpu_torch.sampling.schedulers import karras as karras_schedule

    sigmas = np.asarray(sigmas, np.float64)
    steps = len(sigmas) - 1
    if restart_list is None:
        if steps >= 20:
            restart_steps = 9
            restart_times = 1
            if steps >= 36:
                restart_steps = steps // 4
                restart_times = 2
            sigmas = karras_schedule(steps - restart_steps * restart_times,
                                     float(sigmas[-2]), float(sigmas[0]))
            restart_list = {0.1: [restart_steps + 1, restart_times, 2]}
        else:
            restart_list = {}

    restart_idx = {int(np.argmin(np.abs(sigmas - key))): value
                   for key, value in restart_list.items()}

    step_list = []
    for i in range(len(sigmas) - 1):
        step_list.append((sigmas[i], sigmas[i + 1]))
        if i + 1 in restart_idx:
            r_steps, r_times, r_max = restart_idx[i + 1]
            min_idx = i + 1
            max_idx = int(np.argmin(np.abs(sigmas - r_max)))
            if max_idx < min_idx:
                sigma_restart = karras_schedule(
                    r_steps, float(sigmas[min_idx]), float(sigmas[max_idx]))[:-1]
                for _ in range(r_times):
                    step_list.extend(zip(sigma_restart[:-1], sigma_restart[1:]))

    pairs = np.asarray(step_list, np.float64)
    noise_scale = np.zeros(len(pairs))
    last = None
    for j, (old, new) in enumerate(pairs):
        if last is not None and last < old:
            noise_scale[j] = np.sqrt(old ** 2 - last ** 2)
        last = new
    return pairs.astype(np.float32), noise_scale.astype(np.float32)


# --------------------------------------------------------------------------
# UniPC (Zhao et al. 2023; solvers.py:456-572)
# --------------------------------------------------------------------------

def unipc_coefficients(sigmas: np.ndarray, order: int = 3,
                       variant: str = "bh1", lower_order_final: bool = True):
    """Per-step arrays: ratio, h_phi_1, B_h, rks (n,2), rhos_p (n,2),
    rhos_c (n,3), order (n,) — a copy of solvers.py:465-536."""
    sigmas = np.asarray(sigmas, np.float64)
    n = len(sigmas) - 1
    lam = -np.log(np.maximum(sigmas, 1e-12))

    ratio = np.zeros(n)
    h_phi_1 = np.zeros(n)
    B_h = np.zeros(n)
    rks_arr = np.zeros((n, 2))
    rhos_p = np.zeros((n, 2))
    rhos_c = np.zeros((n, 3))
    orders = np.zeros(n, np.int32)

    for i in range(n):
        cur_order = min(i + 1, order)
        if lower_order_final:
            cur_order = min(cur_order, n - i)
        cur_order = max(cur_order, 1)
        orders[i] = cur_order

        if sigmas[i + 1] <= 0:
            # terminal step: x_t = m0 exactly
            ratio[i] = 0.0
            h_phi_1[i] = -1.0
            B_h[i] = 0.0
            continue

        h = lam[i + 1] - lam[i]
        hh = -h
        ratio[i] = sigmas[i + 1] / sigmas[i]
        h_phi_1[i] = np.expm1(hh)
        B_h[i] = hh if variant == "bh1" else np.expm1(hh)

        rks = []
        for k in range(1, cur_order):
            rks.append((lam[i - k] - lam[i]) / h)
        rks_full = rks + [1.0]
        rks_arr[i, :len(rks)] = rks

        # b_k = h_phi_k · k! / B_h with the phi recursion
        b = []
        h_phi_k = h_phi_1[i] / hh - 1
        fact = 1
        for k in range(1, cur_order + 1):
            b.append(h_phi_k * fact / B_h[i])
            fact *= (k + 1)
            h_phi_k = h_phi_k / hh - 1 / fact
        b = np.asarray(b)
        R = np.stack([np.asarray(rks_full) ** k for k in range(cur_order)])

        if cur_order >= 2:
            if cur_order == 2:
                rhos_p[i, 0] = 0.5
            else:
                sol = np.linalg.solve(R[:-1, :-1], b[:-1])
                rhos_p[i, :len(sol)] = sol
        if cur_order == 1:
            rhos_c[i, 0] = 0.5
        else:
            sol = np.linalg.solve(R, b)
            rhos_c[i, :len(sol)] = sol

    return {"unipc_ratio": ratio.astype(np.float32),
            "unipc_h_phi_1": h_phi_1.astype(np.float32),
            "unipc_B_h": B_h.astype(np.float32),
            "unipc_rks": rks_arr.astype(np.float32),
            "unipc_rhos_p": rhos_p.astype(np.float32),
            "unipc_rhos_c": rhos_c.astype(np.float32),
            "unipc_order": orders}


def unipc_step(model, x, i, sigmas, noise, state, extra):
    """Predictor-corrector in λ = −log σ; the corrector's model value is
    the next step's m0, so after the first step it is one call a step."""
    s, s_next = sigmas[i], sigmas[i + 1]
    ratio, h_phi_1, B_h = (float(extra[k][i]) for k in
                           ("unipc_ratio", "unipc_h_phi_1", "unipc_B_h"))
    rks, rhos_p, rhos_c = (extra[k][i] for k in ("unipc_rks", "unipc_rhos_p", "unipc_rhos_c"))
    cur_order = int(extra["unipc_order"][i])
    m0 = model(x, s, i) if i == 0 else state["m0"]
    m1, m2 = state["m1"], state["m2"]
    d1_1 = (m1 - m0) / float(rks[0] if rks[0] != 0 else _ONE)
    d1_2 = (m2 - m0) / float(rks[1] if rks[1] != 0 else _ONE)
    x_t_ = x * ratio - m0 * h_phi_1
    x_pred = x_t_ - (d1_1 * float(rhos_p[0]) + d1_2 * float(rhos_p[1])) * B_h
    m_t = model(x_pred, np.maximum(s_next, _EPS), i)
    if s_next > 0:
        if cur_order >= 3:
            corr, rho_last = d1_1 * float(rhos_c[0]) + d1_2 * float(rhos_c[1]), rhos_c[2]
        elif cur_order == 2:
            corr, rho_last = d1_1 * float(rhos_c[0]), rhos_c[1]
        else:
            corr, rho_last = 0.0, rhos_c[0]
        x_pred = x_t_ - (corr + (m_t - m0) * float(rho_last)) * B_h
    return x_pred, {"m2": m1, "m1": m0, "m0": m_t}


# --------------------------------------------------------------------------
# LCM
# --------------------------------------------------------------------------

def lcm_step(model, x, i, sigmas, noise, state, extra):
    """Latent Consistency Models: the predicted x0 plus fresh noise at the
    next sigma."""
    s, s_next = sigmas[i], sigmas[i + 1]
    denoised = model(x, s, i)
    if s_next > 0:
        return denoised + noise[0] * float(s_next), state
    return denoised, state


# --------------------------------------------------------------------------
# DPM-Solver fast / adaptive: whole-run drivers (solvers.py:594-759)
# --------------------------------------------------------------------------

def dpm_fast_orders(n: int) -> list:
    """k-diffusion dpm_solver_fast order plan for an n model-call budget."""
    m = n // 3 + 1
    if n % 3 == 0:
        return [3] * (m - 2) + [2, 1]
    return [3] * (m - 1) + [n % 3]


def _dpm_eps(model, x, t, i):
    """eps in t = −log σ space: (x − denoised) / σ."""
    s = np.exp(-t)
    return (x - model(x, s, i)) / float(np.maximum(s, _EPS))


def _dpm_1_update(x, t, t_next, eps):
    return x - eps * float(np.exp(-t_next) * np.expm1(t_next - t))


def _dpm_2_update(x, t, t_next, eps, eps_r1, r1):
    h = t_next - t
    st = np.exp(-t_next)
    return x - eps * float(st * np.expm1(h)) \
        - (eps_r1 - eps) * float(st / (_TWO * r1) * np.expm1(h))


def _dpm_3_update(x, t, t_next, eps, eps_r1, eps_r2, r1, r2):
    h = t_next - t
    st = np.exp(-t_next)
    return x - eps * float(st * np.expm1(h)) \
        - (eps_r2 - eps) * float(st / r2 * (np.expm1(h) / h - _ONE))


def _dpm_u2(x, t, h, eps, eps_r1, r1, r2):
    """The intermediate u2 of the third-order step."""
    ss2 = np.exp(-(t + r2 * h))
    return x - eps * float(ss2 * np.expm1(r2 * h)) \
        - (eps_r1 - eps) * float(ss2 * (r2 / r1) * (np.expm1(r2 * h) / (r2 * h) - _ONE))


_R13, _R23 = F32(1.0 / 3.0), F32(2.0 / 3.0)


def _ancestral_t(t, t_next, t_end, eta):
    """(t_next', su): the ancestral step of the DPM drivers in t space."""
    if eta <= 0:
        return t_next, _ZERO
    sd, _ = _ancestral(np.exp(-t), np.exp(-t_next), eta)
    t_next_ = np.minimum(t_end, -np.log(np.maximum(sd, _EPS)))
    return t_next_, np.sqrt(np.maximum(np.exp(-t_next) ** 2 - np.exp(-t_next_) ** 2, _ZERO))


def sample_dpm_fast_driver(model, x, sigmas, noise, extra):
    """DPM-Solver fast: a uniform grid in t = −log σ over [σ_max, σ_min],
    orders 3, 3, ..., remainder; ancestral noise per outer step when
    eta > 0.  The model's step index counts model calls."""
    n = len(sigmas) - 1
    orders = dpm_fast_orders(n)
    m = len(orders)
    eta = float(extra.get("eta", 1.0))
    s_noise = _s_noise(extra)
    t_start, t_end = -_log(sigmas[0]), -_log(sigmas[-2])     # the last nonzero sigma
    ts = t_start + (t_end - t_start) * np.arange(m + 1, dtype=F32) / F32(m)
    ev = 0
    for k in range(m):
        t = ts[k]
        t_next_, su = _ancestral_t(t, ts[k + 1], t_end, eta)
        eps = _dpm_eps(model, x, t, min(ev, n - 1))
        ev += 1
        h = t_next_ - t
        if orders[k] == 1:
            x = _dpm_1_update(x, t, t_next_, eps)
        elif orders[k] == 2:
            s1 = t + _HALF * h
            u1 = x - eps * float(np.exp(-s1) * np.expm1(_HALF * h))
            eps_r1 = _dpm_eps(model, u1, s1, min(ev, n - 1))
            ev += 1
            x = _dpm_2_update(x, t, t_next_, eps, eps_r1, _HALF)
        else:
            s1 = t + _R13 * h
            u1 = x - eps * float(np.exp(-s1) * np.expm1(_R13 * h))
            eps_r1 = _dpm_eps(model, u1, s1, min(ev, n - 1))
            ev += 1
            u2 = _dpm_u2(x, t, h, eps, eps_r1, _R13, _R23)
            eps_r2 = _dpm_eps(model, u2, t + _R23 * h, min(ev, n - 1))
            ev += 1
            x = _dpm_3_update(x, t, t_next_, eps, eps_r1, eps_r2, _R13, _R23)
        if eta > 0:
            x = x + noise[min(k, noise.shape[0] - 1), 0] * float(su * s_noise)
    return x


def sample_dpm_adaptive_driver(model, x, sigmas, noise, extra):
    """DPM-Solver-12/23 adaptive: an embedded lower-order error estimate
    and a PID step-size controller (k-diffusion's defaults: order 3, rtol
    0.05, atol 0.0078, h_init 0.05, icoeff 1, accept_safety 0.81), at most
    dpm_adaptive_max_steps (80) iterations of three model calls.  Each
    iteration reads its error scalar to the host to accept or reject."""
    eta = float(extra.get("eta", 1.0))
    s_noise = _s_noise(extra)
    rtol = F32(extra.get("dpm_rtol", 0.05))
    atol = float(F32(extra.get("dpm_atol", 0.0078)))
    max_steps = int(extra.get("dpm_adaptive_max_steps", 80))
    b1 = _ONE / F32(1.5 if eta > 0 else 3)          # pcoeff 0, icoeff 1, dcoeff 0
    accept_safety = F32(0.81)
    t_end = -_log(sigmas[-2])
    sqrt_numel = np.sqrt(F32(np.prod(x.shape)))
    n_pool, n_sched = noise.shape[0], len(sigmas) - 1

    x_prev, s, h, k = x, -_log(sigmas[0]), F32(0.05), 0
    while s < t_end - F32(1e-5) and k < max_steps:
        t = np.minimum(t_end, s + h)
        t_, su = _ancestral_t(s, t, t_end, eta)
        i = min(k, n_sched - 1)
        hh = t_ - s
        eps = _dpm_eps(model, x, s, i)
        s1 = s + _R13 * hh
        u1 = x - eps * float(np.exp(-s1) * np.expm1(_R13 * hh))
        eps_r1 = _dpm_eps(model, u1, s1, i)
        x_low = _dpm_2_update(x, s, t_, eps, eps_r1, _R13)
        u2 = _dpm_u2(x, s, hh, eps, eps_r1, _R13, _R23)
        eps_r2 = _dpm_eps(model, u2, s + _R23 * hh, i)
        x_high = _dpm_3_update(x, s, t_, eps, eps_r1, eps_r2, _R13, _R23)

        delta = torch.clamp(torch.maximum(x_low.abs(), x_prev.abs()) * float(rtol), min=atol)
        error = F32(torch.sqrt((((x_low - x_high) / delta) ** 2).sum()).item()) / sqrt_numel
        factor = _ONE + np.arctan((_ONE / (error + F32(1e-8))) ** b1 - _ONE)
        if factor >= accept_safety:
            x = x_high + noise[min(k, n_pool - 1), 0] * float(su * s_noise)
            x_prev, s = x_low, t
        h = h * factor
        k += 1
    return x


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    name: str
    step: Callable
    noises_per_step: int = 0
    model_calls_per_step: int = 1
    needs_old_denoised: bool = False
    order3_state: bool = False
    uses_lms_coeffs: bool = False
    eps_history: bool = False
    uses_unipc: bool = False
    default_eta: float = 1.0
    custom_driver: object = None   # whole-run driver (DPM fast/adaptive):
                                   # (model, x, sigmas, noise, extra) -> x

    def init_state(self, x):
        state = {}
        if self.needs_old_denoised:
            state["old_denoised"] = torch.zeros_like(x)
        if self.order3_state:
            state.update(denoised_1=torch.zeros_like(x), denoised_2=torch.zeros_like(x),
                         h_1=_ZERO, h_2=_ZERO)
        if self.uses_lms_coeffs:
            state["ds"] = []
        if self.eps_history:
            state["eps_hist"] = [torch.zeros_like(x)] * 3
        if self.uses_unipc:
            state.update(m0=torch.zeros_like(x), m1=torch.zeros_like(x),
                         m2=torch.zeros_like(x))
        return state

    def model_calls(self, n_steps: int) -> int | None:
        """Model calls of a run of n_steps (a restart plan's length for
        restart), as JAX makes them: PLMS and UniPC make two on their first
        step and one after, DPM fast spends n_steps; None for DPM adaptive,
        whose controller decides."""
        if self.custom_driver is sample_dpm_adaptive_driver:
            return None
        if self.custom_driver is not None:
            return n_steps
        if self.eps_history or self.uses_unipc:
            return n_steps + 1
        return self.model_calls_per_step * n_steps


SOLVERS = {
    "euler": SolverSpec("euler", euler_step),
    "euler_ancestral": SolverSpec("euler_ancestral", euler_ancestral_step, noises_per_step=1),
    "heun": SolverSpec("heun", heun_step, model_calls_per_step=2),
    "dpm_2": SolverSpec("dpm_2", dpm_2_step, model_calls_per_step=2),
    "dpm_2_ancestral": SolverSpec("dpm_2_ancestral", dpm_2_ancestral_step,
                                  noises_per_step=1, model_calls_per_step=2),
    "dpmpp_2s_ancestral": SolverSpec("dpmpp_2s_ancestral", dpmpp_2s_ancestral_step,
                                     noises_per_step=1, model_calls_per_step=2),
    "dpmpp_sde": SolverSpec("dpmpp_sde", dpmpp_sde_step, noises_per_step=2,
                            model_calls_per_step=2),
    "dpmpp_2m": SolverSpec("dpmpp_2m", dpmpp_2m_step, needs_old_denoised=True),
    "dpmpp_2m_sde": SolverSpec("dpmpp_2m_sde", dpmpp_2m_sde_step, noises_per_step=1,
                               needs_old_denoised=True),
    "dpmpp_3m_sde": SolverSpec("dpmpp_3m_sde", dpmpp_3m_sde_step, noises_per_step=1,
                               order3_state=True),
    "lms": SolverSpec("lms", lms_step, uses_lms_coeffs=True),
    "lcm": SolverSpec("lcm", lcm_step, noises_per_step=1),
    "ddim": SolverSpec("ddim", ddim_step, noises_per_step=1, default_eta=0.0),
    "ddim_cfgpp": SolverSpec("ddim_cfgpp", ddim_cfgpp_step, noises_per_step=1,
                             default_eta=0.0),
    "dpm_fast": SolverSpec("dpm_fast", None, noises_per_step=1,
                           custom_driver=sample_dpm_fast_driver),
    "dpm_adaptive": SolverSpec("dpm_adaptive", None, noises_per_step=1,
                               custom_driver=sample_dpm_adaptive_driver),
    "restart": SolverSpec("restart", restart_step, noises_per_step=1,
                          model_calls_per_step=2),
    "unipc": SolverSpec("unipc", unipc_step, model_calls_per_step=2, uses_unipc=True),
    "plms": SolverSpec("plms", plms_step, eps_history=True, model_calls_per_step=2),
}


def get_solver(name: str) -> SolverSpec:
    return SOLVERS[name]
