"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  0. environment: torch/CUDA versions, the card's name and power limit,
     the three kernel sources of csrc/ built with nvcc, all at once, and
     the SASS of the attention and conv libraries: their bf16 kernels hold
     wgmma (HGMMA) and TMA (UTMALDG) instructions, and no other kernels
     are there;
  1. each kernel entry point vs its plain PyTorch version at the main
     paths' shapes (attention: max|Δ|/max|ref| <= ATTN_REL_TOL in bf16,
     max|Δ| <= 1e-4 in f32, TF32 off; B4 by max|Δ|/max|ref| <= 1e-2 bf16,
     1e-5 f32; B5 in bf16 within one bf16 ulp of the larger magnitude, f32
     1e-4), with the kernel's, the plain version's and one library call's
     time, the card's bound for the work and the wrapper's host µs per
     call (for B5 also F.layer_norm's): B1 (per head: the SD1.5 UNet
     shapes and the SD1.5/SDXL VAE mid-block at 512², 768², 1024² and
     1536², S = 36864), B2 (head-packed, SD1.5 and SDXL base and refiner at
     their first pass's levels and at the hires pass's: SD1.5 at 1024² and
     768², SDXL at 1536²; the SD1.5 rows also on fused-qkv chunk views:
     d = 160 at S = 1024 takes the split-d wide kernel), B3 (4-D, the same
     shapes), B5 (LayerNorm at every UNet row count and width of both
     families, first and hires pass, and at CLIP's) and B4 (3x3 conv at the
     JAX docstring's shapes, the SD1.5 UNet's B=2 shapes and two ragged
     widths);
  2. the full-width SD1.5 UNet CFG step (B=2, latent 64² and the hires
     pass's 128², ctx 2x77x768, bf16, random weights) in three arms: the kernels (B2 + B5), plain
     LayerNorm (B2 only), and plain attention and LayerNorm: finite,
     max|Δ|/max|ref| <= 5e-2, ms and device events per call in each arm;
  3. the HTTP server with random-weight SD1.5 (and two upscaler files made
     from a seed at the published widths in a temporary directory,
     registered as --esrgan-models-path registers them and dropped with it:
     "R-ESRGAN 4x+", an RRDBNet of 23 blocks, nf 64, gc 32, and
     "realesr-general-x4v3", an SRVGGNetCompact of 32 convs, nf 64)
     answering BASELINE config 1
     txt2img requests (512², Euler a, 20 steps, CFG 7.5; batch 1, batch 4
     and a repeated seed): PNGs decoded with the standard library, infotext
     checked, the repeat's image within 2 uint8 levels, and the B2, B1
     (VAE decode) and B5 launch counts equal to the plan's;
  4. the same server answering BASELINE config 2 on /sdapi/v1/img2img: two
     img2img requests (denoising 0.75, one seed) on a phase-3 PNG and one
     inpaint request (rectangle mask, mask_blur 4, inpainting_fill 1): the
     repeat within 2 levels, the inpaint's pixels outside the blurred mask
     within 1 level of the init image and changed inside it, and B2, B1
     (the VAE encode and decode) and B5 launches equal to the plan's;
  4c. BASELINE config 3 (hires fix) on the same server: two 512² → 1024²
     requests with one seed (Euler a, 20 steps, CFG 7.5, "Latent",
     denoising 0.7: 20 UNet calls at 64² and 15 at 128²), the repeat within
     2 levels, infotext naming the hires fields; one each with "Latent
     (bicubic)" and "Latent (nearest-exact)" at hr_scale 1.5 (8 steps); then
     the image-space route 512² → 1024² with R-ESRGAN 4x+ (20 steps),
     realesr-general-x4v3 and Lanczos (8 steps) (B1 = 3: the 512² decode,
     the f32 1024² encode and the 1024² decode), the upscaler's seconds
     logged apart from the request's; B2, B1 and B5 launches equal to the
     plan's; each ESRGAN net's forward of one 192² tile on the card against
     the same net on the CPU (f32, TF32 off, max|Δ|/max|ref| <= 1e-4); one
     config 3 request under torch.profiler, as phase 7, its wall the median
     of the two timed "Latent" requests;
  4d. the Extras routes on the same server (the upscale cache off):
     /extra-single-image with R-ESRGAN 4x+ at upscaling_resize 2 and
     Lanczos as upscaler_2 at visibility 0.5 on a phase-3 PNG, with
     resize_mode 1 and crop, /extra-batch-images with two images, and
     /upscalers listing the two files: sizes checked, s/image logged;
  4a. checkpoint files: phase 3's model written as an ldm-layout
     .safetensors in its own dtypes, and a second random SD1.5 (seed 1) in
     fp16 beside it, in a temporary directory, served by an Engine built as
     `--ckpt-dir`/`--ckpt` builds it (sd_checkpoints_limit 2): phase 3's
     seed-1234 request from the file within 2 levels of phase 3's image,
     its infotext's Model hash the file's sha256[:10]; POST
     /sdapi/v1/options to the second gives another image; override_settings
     back to the first gives phase 3's image again with no file read; GET
     /sdapi/v1/sd-models lists both; B1, B2 and B5 launches equal the plan's;
     the load (s, s/GB, s to the first image) and the swap time logged; the
     files are deleted at the end of the phase;
  4b. every name of /sdapi/v1/samplers on the loaded model, one 512²
     batch-1 request of 8 steps each: an image that is not flat, infotext
     naming the sampler, B2 launches equal to the per-call plan times the
     solver's model calls (for DPM adaptive a multiple of the per-call
     plan), s/request logged;
  5. the full-width SDXL base step (B=2, latent 128², ctx 2x77x2048, y
     2x2816) and refiner step (ctx 2x77x1280, y 2x2560), bf16, in the
     three arms of phase 2, and the SDXL VAE decode at 1024² in bf16 and in
     its fp32 retry dtype;
  6. the server with random SDXL base + refiner answering two BASELINE
     config 5 requests with one seed (1024², DPM++ 2M Karras, 20 steps,
     CFG 7.0, refiner switch at 0.8): 1024x1024 PNGs, infotext naming the
     sampler, seed and refiner, the repeat within 2 uint8 levels, an image
     that is not flat, and B2, B1 and B5 launch counts equal to the plan's;
  6b. the same server answering one config 5 request with hires fix
     (hr_scale 1.5, "Latent", denoising 0.5, hr_second_pass_steps 20): the
     base runs the first pass and, under hires_fix_refiner_pass "second
     pass", hands over to the refiner inside the second (1536², latent
     192²); a 1536x1536 PNG, infotext naming Hires and Refiner, B2, B1 (the
     1536² decode, S = 36864) and B5 launches equal to the plan's;
  7. one more in-process SDXL request under torch.profiler (CUDA activity
     only): wall (median of two untraced requests), device busy (union of
     the kernel intervals), idle share, device time by kernel class and
     the top kernels.
Each phase's seconds are logged as it ends.  The last two lines are the
kernels JSON and {"ok": true, "device": ...}.
Needs a CUDA card; without one it exits 1 and prints no result.
"""

from __future__ import annotations

import base64
import contextlib
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

# bf16 attention: max|Δ| / max|ref|.  Outputs of N(0, 1) inputs shrink as
# sqrt(e / Skv), so an absolute bound would pass a dropped kv tile at
# Skv = 16384; this one sits between the sound readings and planted faults
# (PERF.md, PR 4: one kv tile skipped, a cluster merge that drops a block)
ATTN_REL_TOL = 2e-2
F32_TOL = 1e-4
CONV_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}   # max|Δ| / max|ref|
# B5 in bf16: kernel and plain version both round the fp32 result once, so
# they may differ by one bf16 ulp where their fp32 sums differ in the last
# bit (plus 1e-5 near zero); at outputs in [4, 8) one ulp is 3.1e-2, above
# an absolute 2e-2
LN_ULP_TOL = 1.0
UNET_REL_TOL = 5e-2
UNET_ROUNDS = 3         # interleaved timing rounds per UNet arm
REPEAT_TOL = 2          # uint8 levels
OVERLAY_TOL = 1         # uint8 levels, inpaint pixels outside the blurred mask
STEPS = 20
SAMPLER_STEPS = 8       # phase 4b
DENOISE = 0.75
MASK_BLUR = 4
SDXL_SWITCH_AT = 0.8
VAE_MEAN_DIFF_TOL = 2.0   # uint8 levels, SDXL VAE bf16 vs fp32 decode
HR_DENOISE = 0.7          # config 3
SDXL_HR_DENOISE = 0.5
ESRGAN_REL_TOL = 1e-4     # max|Δ| / max|ref|, one tile on the card vs the CPU, f32
ESRGAN_TILE = 192

# The card's rates for the bound of each kernel row (H100 SXM data sheet,
# dense, at the 700 W limit): bf16 tensor cores, fp32 outside the tensor
# cores (the f32 kernels and every LayerNorm, whose math is fp32), HBM3.
PEAK_FLOPS = {"bf16_tensor": 989e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12

# B1 rows: (name, BH, Sq, Skv, D, dtype)
B1_SHAPES = [
    ("unet_64x64_d40", 16, 4096, 4096, 40, torch.bfloat16),
    ("unet_32x32_d80", 16, 1024, 1024, 80, torch.bfloat16),
    ("vae_mid_512", 1, 4096, 4096, 512, torch.bfloat16),
    ("vae_mid_512_f32", 1, 4096, 4096, 512, torch.float32),
    ("vae_mid_768", 1, 9216, 9216, 512, torch.bfloat16),
    ("vae_mid_1024", 1, 16384, 16384, 512, torch.bfloat16),
    ("vae_mid_1024_f32", 1, 16384, 16384, 512, torch.float32),
    ("vae_mid_1536", 1, 36864, 36864, 512, torch.bfloat16),
    ("vae_mid_1536_f32", 1, 36864, 36864, 512, torch.float32),
    ("ragged_d64", 3, 1000, 1100, 64, torch.bfloat16),
]
# B2 / B3 rows: (name, B, S, H, D), bf16, Sq = Skv = S
HEAD_SHAPES = [
    ("sd15_64x64", 2, 4096, 8, 40),
    ("sd15_32x32", 2, 1024, 8, 80),
    ("sdxl_base_64x64", 2, 4096, 10, 64),
    ("sdxl_base_32x32", 2, 1024, 20, 64),
    ("sdxl_refiner_64x64", 2, 4096, 12, 64),
    ("sdxl_refiner_32x32", 2, 1024, 24, 64),
    # the hires pass: SD1.5 at a 128² latent (hr_scale 2) and at 96² (1.5),
    # SDXL at 192²
    ("sd15_hr_128x128", 2, 16384, 8, 40),
    ("sd15_hr_64x64", 2, 4096, 8, 80),
    ("sd15_hr_32x32", 2, 1024, 8, 160),
    ("sd15_hr_96x96", 2, 9216, 8, 40),
    ("sd15_hr_48x48", 2, 2304, 8, 80),
    ("sdxl_base_96x96", 2, 9216, 10, 64),
    ("sdxl_base_48x48", 2, 2304, 20, 64),
    ("sdxl_refiner_96x96", 2, 9216, 12, 64),
    ("sdxl_refiner_48x48", 2, 2304, 24, 64),
]
# B4 rows: (name, B, H, W, Cin, Cout): the shapes of the JAX kernel's
# docstring (sdwebui_tpu/ops/conv.py:6-8), the SD1.5 UNet's at B = 2 (the
# 32² and 16² levels take the split-K path: ops/conv.conv_plan) and two
# widths that no rectangle tiles (pixels past the image masked; split K)
CONV_SHAPES = [
    ("jax_doc_64x64x320", 8, 64, 64, 320, 320),
    ("jax_doc_32x32x640", 8, 32, 32, 640, 640),
    ("jax_doc_16x16x1280", 8, 16, 16, 1280, 1280),
    ("sd15_64x64x320", 2, 64, 64, 320, 320),
    ("sd15_32x32x640", 2, 32, 32, 640, 640),
    ("sd15_16x16x1280", 2, 16, 16, 1280, 1280),
    ("ragged_17x17x640", 2, 17, 17, 640, 640),
    ("ragged_33x33x320", 2, 33, 33, 320, 320),
]
# the UNets call B2 on the chunk views of their fused qkv projection
FUSED_QKV_ROWS = ("sd15_64x64", "sdxl_base_64x64", "sd15_hr_128x128", "sd15_hr_64x64",
                  "sd15_hr_32x32", "sd15_hr_96x96", "sd15_hr_48x48")
HOST_CALLS = 20           # calls per host-cost reading


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters: int = 5, warmup: int = 2, hide_host: bool = True) -> float:
    """ms per call from CUDA events around `iters` back-to-back calls.  With
    hide_host a sleep kernel holds the stream while the host enqueues them,
    so a call whose launch costs the host more than its kernels cost the
    device is timed on the device (kernel rows); without it the time
    includes the host's launch rate (UNet calls, which are host-bound)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if hide_host:
        torch.cuda._sleep(50_000_000)      # ~25 ms at the H100's clocks
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """µs of host time per call: `calls` back-to-back calls on an idle
    stream, no sleep kernel and no synchronisation inside the window (the
    launches queue; the wrapper's checks, allocation and ctypes call are
    what is timed)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def bound(flops: float, nbytes: float, rate: str):
    """(ms, "operations" | "bytes"): the least time the card could take."""
    t_ops, t_bytes = flops / PEAK_FLOPS[rate], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def reset_counts():
    from sdwebui_tpu_torch.ops import conv, flash_attention, layer_norm

    flash_attention.reset_launch_count()
    layer_norm.reset_launch_count()
    conv.reset_launch_count()


def read_counts() -> dict:
    from sdwebui_tpu_torch.ops import conv, flash_attention, layer_norm

    out = {name: flash_attention.launch_count(name) for name in flash_attention.ENTRY_POINTS}
    out["layer_norm"] = layer_norm.launch_count()
    out["conv3x3"] = conv.launch_count()
    return out


def phase_env():
    from sdwebui_tpu_torch.ops import _build

    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    log(smi)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.KERNELS)) as pool:   # one nvcc per source, together
        list(pool.map(lambda name: _build.load_library(name, rebuild=True), _build.KERNELS))
    log(f"built {', '.join(f'{n}.cu' for n in _build.KERNELS)} for sm_90a in "
        f"{time.perf_counter() - t0:.2f} s (nvcc "
        + ", ".join(f"{n} {_build.build_seconds[n]:.2f} s" for n in _build.KERNELS) + ")")
    for name in SASS_KERNELS:
        sass_check(name, _build.load_library(name)._name)
    return smi


def sass_counts(lib_path: str) -> dict:
    """{function name: {"HGMMA": n, "UTMALDG": n}}: the wgmma and TMA load
    instructions in each device function of a built library's SASS."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = {"HGMMA": 0, "UTMALDG": 0}
        elif name:
            for op in counts[name]:
                counts[name][op] += op in line
    return counts


#: the wgmma + TMA kernels of each library, and every kernel it may hold:
#: the bf16 conv and attention kernels that replaced the mma.sync ones
SASS_KERNELS = {
    "flash_attention": (("attn_tc_kernel", "attn_wide_kernel"),
                        ("attn_tc_kernel", "attn_wide_kernel", "attn_f32_kernel")),
    "conv3x3": (("conv_wgmma_kernel",), ("conv_wgmma_kernel", "conv_f32_kernel")),
}


def sass_check(name: str, lib_path: str):
    """The wgmma kernels of a built library are what was built: each one's
    SASS holds HGMMA (wgmma) and UTMALDG (TMA loads) instructions, and the
    library holds no kernel but the listed ones."""
    wgmma, known = SASS_KERNELS[name]
    counts = {}
    for fn, ops in sass_counts(lib_path).items():
        kernel = next((k for k in known if k in fn), fn)
        mine = counts.setdefault(kernel, {"HGMMA": 0, "UTMALDG": 0})
        for op, n in ops.items():
            mine[op] += n
    log(f"{name} SASS: {counts}")
    unknown = set(counts) - set(known)
    if unknown:
        raise AssertionError(f"{name} holds other kernels than {known}: {sorted(unknown)}")
    for kernel in wgmma:
        if not (counts.get(kernel, {}).get("HGMMA") and counts[kernel]["UTMALDG"]):
            raise AssertionError(f"{kernel} lacks wgmma or TMA instructions: {counts}")


def bf16_ulps(out, ref) -> float:
    """max |Δ| in bf16 units in the last place of the larger magnitude,
    after 1e-5 absolute for outputs near zero (where x − mean cancels)."""
    a = torch.maximum(out.float().abs(), ref.float().abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(a)) - 7)
    return (((out.float() - ref.float()).abs() - 1e-5).clamp_min(0) / ulp).max().item()


def agreement(out, ref, dtype, rel_tol=None, ulp_tol=None) -> dict:
    """How far a kernel's output lies from its plain version's, against the
    row's bound: relative to max|ref| (rel_tol), in bf16 ulps (ulp_tol, bf16
    only), or else absolute (F32_TOL)."""
    err = (out.float() - ref.float()).abs().max().item()
    ref_max = ref.float().abs().max().item()
    rel = err / max(ref_max, 1e-30)
    ulps = bf16_ulps(out, ref) if ulp_tol is not None and dtype == torch.bfloat16 else None
    if ulps is not None:
        tol, ok = ulp_tol, ulps <= ulp_tol
        text = f"max|Δ| {err:.3e}, {ulps:.2f} bf16 ulps (tol {tol:g} ulp)"
    elif rel_tol is None:
        tol, ok = F32_TOL, err <= F32_TOL
        text = f"max|Δ| {err:.3e} (tol {tol:g}), max|ref| {ref_max:.3e}"
    else:
        tol, ok = rel_tol, rel <= rel_tol
        text = f"max|Δ| {err:.3e}, /max|ref| {ref_max:.3e} = {rel:.3e} (tol {tol:g})"
    return dict(max_abs_err=err, max_ref=ref_max, rel_err=rel, ulps=ulps, tol=tol, ok=ok,
                text=text)


def _compare(entry, name, shape, dtype, kernel, plain, library, work, rows, rel_tol=None,
             ulp_tol=None, library_host=False):
    """One kernel row: the kernel vs its plain version on the same inputs
    (see agreement), then the kernel's, the plain version's and the library
    call's times, and the host µs per call of the kernel's wrapper (and of
    the library call where library_host); work = (flops, bytes, rate) for
    the bound."""
    out = kernel()
    ref = plain()
    torch.cuda.synchronize()
    agree = agreement(out, ref, dtype, rel_tol, ulp_tol)
    del out, ref
    ms = cuda_ms(kernel)
    plain_ms = cuda_ms(plain)
    library_ms = cuda_ms(library)
    host = host_us(kernel)
    lib_host = host_us(library) if library_host else None
    bound_ms, bound_by = bound(*work)
    log(f"{entry} {name} {tuple(shape)} {str(dtype)[6:]}: {agree['text']}, kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, library {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}), host {host:.1f} µs/call"
        + (f" (library {lib_host:.1f})" if library_host else ""))
    if not agree["ok"]:
        raise AssertionError(f"{entry} disagrees with its plain version at {name}: "
                             f"{agree['text']}")
    rows.append(dict(entry=entry, name=name, shape=list(shape), dtype=str(dtype)[6:],
                     max_abs_err=agree["max_abs_err"], max_ref=agree["max_ref"],
                     rel_err=agree["rel_err"], tol=agree["tol"], ms=ms, plain_ms=plain_ms,
                     library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                     host_us=host, library_host_us=lib_host))


def _attn_work(bh, sq, skv, d, dtype):
    size = 2 if dtype == torch.bfloat16 else 4
    rate = "bf16_tensor" if dtype == torch.bfloat16 else "fp32"
    return 4.0 * bh * sq * skv * d, size * bh * (2 * sq + 2 * skv) * d, rate


def layer_norm_shapes():
    """(name, rows, width) of every LayerNorm on the SD1.5 and SDXL paths:
    three per transformer block at B = 2 (from the configs' build plans) at
    the first pass's latent and the hires pass's (SD1.5 at 128² and 96²,
    SDXL at 192²), and the CLIP-L / bigG encoders over cond + uncond
    (2 x 77 tokens)."""
    from sdwebui_tpu_torch.models.configs import (CLIP_L, OPEN_CLIP_BIGG, SD15_UNET,
                                                  SDXL_REFINER_UNET, SDXL_UNET)
    from sdwebui_tpu_torch.models.unet import self_attention_calls

    shapes = {}
    for fam, cfg, latents in (("sd15", SD15_UNET, (64, 128, 96)),
                              ("sdxl_base", SDXL_UNET, (128, 192)),
                              ("sdxl_refiner", SDXL_REFINER_UNET, (128, 192))):
        for latent in latents:
            for s, h, d in self_attention_calls(cfg, latent):
                shapes.setdefault(f"{fam}_s{s}_c{h * d}", (2 * s, h * d))
    shapes.update(clip_l=(2 * 77, CLIP_L.width), clip_bigg=(2 * 77, OPEN_CLIP_BIGG.width))
    return [(name, rows, c) for name, (rows, c) in shapes.items()]


def phase_kernel(device):
    from sdwebui_tpu_torch.ops import flash_attention as fa

    rows = []
    sdpa = F.scaled_dot_product_attention

    def randn(shape, g, dtype):
        return _randn(shape, g, dtype, device)

    for name, bh, sq, skv, d, dtype in B1_SHAPES:
        g = torch.Generator(device=device).manual_seed(0)
        q, k, v = randn((bh, sq, d), g, dtype), randn((bh, skv, d), g, dtype), \
            randn((bh, skv, d), g, dtype)
        _compare("flash_attention", name, (bh, sq, skv, d), dtype,
                 lambda: fa.flash_attention(q, k, v),
                 lambda: fa.flash_attention_plain(q, k, v),
                 lambda: sdpa(q[None], k[None], v[None]),
                 _attn_work(bh, sq, skv, d, dtype), rows,
                 rel_tol=ATTN_REL_TOL if dtype == torch.bfloat16 else None)
        del q, k, v
        torch.cuda.empty_cache()
    bf16 = torch.bfloat16
    for name, b, s, h, d in HEAD_SHAPES:
        g = torch.Generator(device=device).manual_seed(1)
        q, k, v = (randn((b, s, h * d), g, bf16) for _ in range(3))
        heads = [t.unflatten(-1, (h, d)).transpose(1, 2) for t in (q, k, v)]
        work = _attn_work(b * h, s, s, d, bf16)
        _compare("flash_attention_packed", name, (b, s, h, d), bf16,
                 lambda: fa.flash_attention_packed(q, k, v, num_heads=h),
                 lambda: fa.flash_attention_packed_plain(q, k, v, num_heads=h),
                 lambda: sdpa(*heads), work, rows, rel_tol=ATTN_REL_TOL)
        q4, k4, v4 = (t.unflatten(-1, (h, d)) for t in (q, k, v))
        _compare("flash_attention_4d", name, (b, s, h, d), bf16,
                 lambda: fa.flash_attention_4d(q4, k4, v4),
                 lambda: fa.flash_attention_4d_plain(q4, k4, v4),
                 lambda: sdpa(*heads), work, rows, rel_tol=ATTN_REL_TOL)
        if name in FUSED_QKV_ROWS:   # the chunk views of a fused projection
            qkv = randn((b, s, 3 * h * d), g, bf16)
            qc, kc, vc = qkv.chunk(3, dim=-1)
            chunk_heads = [t.unflatten(-1, (h, d)).transpose(1, 2) for t in (qc, kc, vc)]
            _compare("flash_attention_packed", name + "_fused_qkv", (b, s, h, d), bf16,
                     lambda: fa.flash_attention_packed(qc, kc, vc, num_heads=h),
                     lambda: fa.flash_attention_packed_plain(qc, kc, vc, num_heads=h),
                     lambda: sdpa(*chunk_heads), work, rows, rel_tol=ATTN_REL_TOL)
            del qkv, qc, kc, vc, chunk_heads
        del q, k, v, q4, k4, v4, heads
        torch.cuda.empty_cache()

    for case in layer_norm_cases(device):
        _compare(**case, rows=rows, library_host=True)
    for case in conv_cases(device):
        _compare(**case, rows=rows)
    torch.cuda.empty_cache()
    return rows


def _randn(shape, g, dtype, device):
    return torch.randn(shape, generator=g, device=device).to(dtype)


def layer_norm_cases(device):
    """The B5 rows of phase 1, one at a time (each row's tensors live while
    it is compared): _compare's arguments without `rows`."""
    from sdwebui_tpu_torch.ops import layer_norm as ln_mod

    for dtype in (torch.bfloat16, torch.float32):
        size = 2 if dtype == torch.bfloat16 else 4
        for name, n_rows, c in layer_norm_shapes():
            g = torch.Generator(device=device).manual_seed(2)
            x = (_randn((n_rows, c), g, torch.float32, device) * 2 + 0.5).to(dtype)
            w, b = _randn((c,), g, dtype, device), _randn((c,), g, dtype, device)
            yield dict(entry="layer_norm", name=name, shape=(n_rows, c), dtype=dtype,
                       kernel=lambda: ln_mod.layer_norm(x, w, b),
                       plain=lambda: ln_mod.layer_norm_plain(x, w, b),
                       library=lambda: F.layer_norm(x, (c,), w, b, 1e-5),
                       work=(7.0 * n_rows * c, size * (2 * n_rows * c + 2 * c), "fp32"),
                       ulp_tol=LN_ULP_TOL)


def conv_cases(device):
    """The B4 rows of phase 1, as layer_norm_cases."""
    from sdwebui_tpu_torch.ops import conv as conv_mod

    cl = torch.channels_last
    for dtype in (torch.bfloat16, torch.float32):
        size = 2 if dtype == torch.bfloat16 else 4
        for name, bsz, hh, ww, cin, cout in CONV_SHAPES:
            g = torch.Generator(device=device).manual_seed(3)
            x = _randn((bsz, cin, hh, ww), g, dtype, device).contiguous(memory_format=cl)
            w = (_randn((cout, cin, 3, 3), g, dtype, device) * 0.05).contiguous(memory_format=cl)
            b = _randn((cout,), g, dtype, device)
            flops = 2.0 * bsz * hh * ww * 9 * cin * cout
            nbytes = size * (bsz * hh * ww * (cin + cout) + 9 * cin * cout + cout)
            yield dict(entry="conv3x3", name=name, shape=(bsz, hh, ww, cin, cout), dtype=dtype,
                       kernel=lambda: conv_mod.conv3x3(x, w, b),
                       plain=lambda: conv_mod.conv3x3_plain(x, w, b),
                       library=lambda: F.conv2d(x, w, b, 1, 1),
                       work=(flops, nbytes, "bf16_tensor" if dtype == torch.bfloat16 else "fp32"),
                       rel_tol=CONV_REL_TOL[dtype])


def device_events(fn) -> int:
    """Device activities (kernels, copies, sets) of one call of fn."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type.name == "CUDA")


@contextlib.contextmanager
def _all_plain():
    """Plain attention and plain LayerNorm: the yardstick arm."""
    from sdwebui_tpu_torch.ops import norms
    from sdwebui_tpu_torch.ops.attention import forced_impl

    with forced_impl("plain"), norms.forced_plain():
        yield


def _unet_step(label, unet, cfg, latent, x, t, ctx, y=None):
    """The UNet call in three arms: the kernels (attention kernels + B5),
    plain LayerNorm, and plain attention with plain LayerNorm."""
    from sdwebui_tpu_torch.ops import flash_attention as fa
    from sdwebui_tpu_torch.ops import layer_norm as ln_mod
    from sdwebui_tpu_torch.ops import norms

    arms = {"kernels": contextlib.nullcontext, "plain_layer_norm": norms.forced_plain,
            "plain": _all_plain}
    step = lambda: unet(x, t, ctx, y)  # noqa: E731
    res, outs = {}, {}
    with torch.inference_mode():
        for arm, ctx_mgr in arms.items():
            with ctx_mgr():
                reset_counts()
                outs[arm] = step().float()
                torch.cuda.synchronize()
                if arm == "kernels":
                    planned = (launch_plan(cfg, latent), 0, ln_plan(cfg, latent))
                    counted = (fa.launch_count("flash_attention_packed"), fa.launch_count(),
                               ln_mod.launch_count())
                    log(f"{label}: (B2, B1, B5) launches per call {counted}, planned {planned}")
                    if counted != planned:
                        raise AssertionError(f"{label}: launches {counted} != planned {planned}")
                    res["launches_per_call"] = dict(zip(("b2", "b1", "b5"), counted))
                res[f"{arm}_events"] = device_events(step)
        # the step is host-bound and the host's pace drifts within a run, so
        # the arms take turns and each reports its median round
        times = {arm: [] for arm in arms}
        for _ in range(UNET_ROUNDS):
            for arm, ctx_mgr in arms.items():
                with ctx_mgr():
                    times[arm].append(cuda_ms(step, iters=5, hide_host=False))
        for arm, ts in times.items():
            res[f"{arm}_ms"] = statistics.median(ts)
    ref = outs["plain"]
    for arm in ("kernels", "plain_layer_norm"):
        out = outs[arm]
        if not (torch.isfinite(out).all() and torch.isfinite(ref).all()):
            raise AssertionError(f"non-finite {label} UNet output ({arm})")
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        res[f"{arm}_rel_err"] = rel
        if tuple(out.shape) != tuple(x.shape) or not rel <= UNET_REL_TOL:
            raise AssertionError(f"{label} UNet {arm} arm disagrees with the plain arm: {rel}")
    log(f"unet {label}: max|Δ|/max|ref| vs plain {res['kernels_rel_err']:.3e} "
        f"(bound {UNET_REL_TOL:g}); ms/call kernels {res['kernels_ms']:.2f}, plain LayerNorm "
        f"{res['plain_layer_norm_ms']:.2f}, plain {res['plain_ms']:.2f}; device events/call "
        f"{res['kernels_events']}, {res['plain_layer_norm_events']}, {res['plain_events']}")
    return res


def phase_unet(model, device):
    """The SD1.5 UNet step at the first pass's 64² latent and at the hires
    pass's 128² (config 3)."""
    out = {}
    for latent in (64, 128):
        g = torch.Generator(device=device).manual_seed(1)
        x = torch.randn((2, 4, latent, latent), generator=g, device=device).to(torch.bfloat16)
        t = torch.tensor([500.0, 500.0], device=device)
        ctx = torch.randn((2, 77, 768), generator=g, device=device).to(torch.bfloat16)
        out[f"{latent}x{latent}"] = _unet_step(f"SD1.5 B=2 {latent}x{latent} bf16", model.unet,
                                               model.unet_cfg, latent, x, t, ctx)
        del x, ctx
        torch.cuda.empty_cache()
    return out


def launch_plan(cfg, latent: int) -> int:
    """B2 launches of one UNet forward at latent², from the config and the
    dispatch rule (ops/attention.py): every self-attention with Skv >=
    FLASH_MIN_KV, whatever its head dim.  No UNet call reaches B1."""
    from sdwebui_tpu_torch.models.unet import self_attention_calls
    from sdwebui_tpu_torch.ops.attention import FLASH_MIN_KV

    return sum(s >= FLASH_MIN_KV for s, _, _ in self_attention_calls(cfg, latent))


def ln_plan(cfg, latent: int) -> int:
    """B5 launches of one UNet forward: three per transformer block."""
    from sdwebui_tpu_torch.models.unet import self_attention_calls

    return 3 * len(self_attention_calls(cfg, latent))


def clip_ln_plan(model) -> int:
    """B5 launches of one prompt encode: two per CLIP layer, the final norm
    on the pooled state, and on the hidden state when it is applied."""
    return sum(2 * c.cfg.layers + 1 + int(c.apply_final_norm)
               for c in (model.conditioner, model.conditioner2) if c is not None)


def _post(url, body=None):
    """POST `body` as JSON (GET without one); the decoded JSON answer."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


@contextlib.contextmanager
def _server(engine):
    """A server around `engine` on a free port; yields its /sdapi/v1 URL."""
    from sdwebui_tpu_torch.server.api import make_server

    server = make_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}/sdapi/v1"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def _request(url, route, body, check, size, label=None) -> dict:
    """POST one generation request and check its images: (seconds, the
    last image decoded and as sent, launches)."""
    from sdwebui_tpu_torch.utils.png import decode_png

    reset_counts()
    t0 = time.perf_counter()
    res = _post(f"{url}/{route}", body)
    dt = time.perf_counter() - t0
    launches = read_counts()
    first = json.loads(res["info"])["index_of_first_image"]
    images = [decode_png(base64.b64decode(b)) for b in res["images"][first:]]
    if len(images) != body.get("batch_size", 1):
        raise AssertionError(f"{len(images)} images for batch {body.get('batch_size')}")
    for i, (img, text) in enumerate(images):
        if img.shape != (size, size, 3):
            raise AssertionError(f"image shape {img.shape}")
        check(text.get("parameters", ""), body["seed"] + i)
    log(f"{label or route} {size}² batch {len(images)} seed {body['seed']}: {dt:.3f} s, "
        f"{len(images) / dt:.3f} images/s, launches {launches}")
    return dict(route=route, batch=len(images), seed=body["seed"], seconds=dt,
                images_per_s=len(images) / dt, launches=launches, image=images[-1][0],
                png_b64=res["images"][-1], infotext=images[-1][1].get("parameters", ""))


def _serve(engine, route, requests, warmup, check, size):
    """POST `requests` to `route` of a server around `engine`, after an
    untimed, uncounted `warmup` request; the results of _request."""
    with _server(engine) as url:
        _post(f"{url}/{route}", warmup)
        return [_request(url, route, body, check, size) for body in requests]


def _check_repeat(results, i, j):
    a, b = results[i]["image"].astype(int), results[j]["image"].astype(int)
    delta = int(abs(a - b).max())
    log(f"repeated seed {results[i]['seed']}: max|Δ| {delta} uint8 levels (bound {REPEAT_TOL})")
    if delta > REPEAT_TOL:
        raise AssertionError(f"repeated seed differs by {delta}")
    if results[i]["image"].std() < 1.0:
        raise AssertionError("the generated image is flat")


def _check_launches(results, expected):
    launches = [r["launches"] for r in results]
    log(f"kernel launches per request {launches}, planned {expected}")
    if launches != expected:
        raise AssertionError(f"launch count {launches} != planned {expected}")


def _plan(b1=0, b2=0, b5=0) -> dict:
    return dict(flash_attention=b1, flash_attention_packed=b2, flash_attention_4d=0,
                layer_norm=b5, conv3x3=0)


SD15_BASE = dict(prompt="a photograph of an astronaut riding a horse",
                 negative_prompt="blurry, lowres", width=512, height=512,
                 sampler_name="Euler a", steps=STEPS, cfg_scale=7.5)


def _sd15_check(params, seed):
    if f"Seed: {seed}" not in params or "Sampler: Euler a" not in params:
        raise AssertionError(f"infotext lacks seed/sampler: {params!r}")


def phase_serve(engine, model):
    requests = [dict(SD15_BASE, seed=1234, batch_size=1),
                dict(SD15_BASE, seed=99, batch_size=4),
                dict(SD15_BASE, seed=1234, batch_size=1)]
    results = _serve(engine, "txt2img", requests, dict(SD15_BASE, seed=1, batch_size=1, steps=2),
                     _sd15_check, 512)
    _check_repeat(results, 0, 2)
    expected = [_plan(b1=1, b2=STEPS * launch_plan(model.unet_cfg, 64),   # B1: the decode
                      b5=STEPS * ln_plan(model.unet_cfg, 64) + clip_ln_plan(model))
                ] * len(requests)
    _check_launches(results, expected)
    return results


def phase_img2img(engine, model, init_png: str):
    """BASELINE config 2: img2img twice with one seed, then an inpaint."""
    from sdwebui_tpu_torch.pipeline.img2img import setup_img2img_steps
    from sdwebui_tpu_torch.utils.masking import blur_mask
    from sdwebui_tpu_torch.utils.png import decode_png, encode_png

    init = decode_png(base64.b64decode(init_png))[0]
    mask_rgb = torch.zeros((512, 512, 3), dtype=torch.uint8)
    mask_rgb[160:352, 128:384] = 255                 # a rectangle, sent as an RGB PNG
    mask = mask_rgb[:, :, 0].numpy()
    base = dict(SD15_BASE, init_images=[init_png], denoising_strength=DENOISE, batch_size=1)
    inpaint = dict(base, seed=4321, mask=base64.b64encode(encode_png(mask_rgb.numpy())).decode(
        "ascii"), mask_blur=MASK_BLUR, inpainting_fill=1, inpaint_full_res=False)

    def check(params, seed):
        _sd15_check(params, seed)
        if f"Denoising strength: {DENOISE}" not in params:
            raise AssertionError(f"infotext lacks the denoising strength: {params!r}")

    results = _serve(engine, "img2img", [dict(base, seed=1234), dict(base, seed=1234), inpaint],
                     dict(base, seed=1, steps=2), check, 512)
    _check_repeat(results, 0, 1)
    out = results[2]["image"].astype(int)
    blurred = blur_mask(mask, MASK_BLUR)
    outside = int(abs(out - init.astype(int))[blurred == 0].max())
    inside = float(abs(out - init.astype(int))[mask > 0].mean())
    log(f"inpaint: outside the blurred mask max|Δ| {outside} uint8 levels from the init "
        f"image (bound {OVERLAY_TOL}); inside mean|Δ| {inside:.2f}")
    if outside > OVERLAY_TOL or not inside > 1.0:
        raise AssertionError(f"inpaint overlay wrong: outside {outside}, inside {inside}")
    _, t_enc = setup_img2img_steps(STEPS, DENOISE)
    calls = t_enc + 1                  # the last t_enc + 2 sigmas; Euler a: one call per step
    expected = [_plan(b1=2, b2=calls * launch_plan(model.unet_cfg, 64),   # B1: encode, decode
                      b5=calls * ln_plan(model.unet_cfg, 64) + clip_ln_plan(model))
                ] * 3
    _check_launches(results, expected)
    return results, calls


# the published widths of the two upscaler files: R-ESRGAN 4x+ (RRDBNet) and
# realesr-general-x4v3 (SRVGGNetCompact)
UPSCALER_FILES = {"R-ESRGAN 4x+": ("rrdbnet", dict(in_ch=3, nf=64, gc=32, n_blocks=23)),
                  "realesr-general-x4v3": ("srvgg", dict(nf=64, num_conv=32, scale=4))}


def write_upscaler_files(directory: str, seed: int = 0) -> dict:
    """The upscaler files, random weights from `seed` in f32: each conv
    N(0, 0.5² / fan-in), the RRDBNet's last bias lifted by 0.5, so that the
    output is neither flat nor clipped; {name: path}."""
    from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
    from sdwebui_tpu_torch.models.esrgan import RRDBNet, SRVGGNetCompact

    paths = {}
    for i, (name, (arch, kw)) in enumerate(UPSCALER_FILES.items()):
        net = RRDBNet(**kw) if arch == "rrdbnet" else SRVGGNetCompact(**kw)
        g = torch.Generator().manual_seed(seed + i)
        sd = {k: torch.randn(v.shape, generator=g) * (0.5 / v[0].numel() ** 0.5 if v.ndim == 4
                                                       else 0.05)
              for k, v in net.state_dict().items()}
        if arch == "rrdbnet":
            sd["conv_last.bias"] += 0.5
        paths[name] = os.path.join(directory, name + ".safetensors")
        write_safetensors(paths[name], sd)
    return paths


def check_upscaler_nets(paths: dict, device) -> dict:
    """Each upscaler net's forward of one ESRGAN_TILE² tile on the card
    against the same net on the CPU, f32 with TF32 off."""
    from sdwebui_tpu_torch.models.esrgan import load_upscaler_net

    out = {}
    for name, path in paths.items():
        g = torch.Generator().manual_seed(5)
        x = torch.rand((1, 3, ESRGAN_TILE, ESRGAN_TILE), generator=g)
        with torch.inference_mode():
            ref = load_upscaler_net(path, "cpu")(x)
            net = load_upscaler_net(path, device)
            got = net(x.to(device))
            torch.cuda.synchronize()
            xd = x.to(device)
            ms = cuda_ms(lambda: net(xd), iters=3, warmup=1, hide_host=False)
        got = got.cpu()
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        out[name] = dict(rel_err=rel, tile_ms=ms, out_std=ref.std().item())
        log(f"{name}: one {ESRGAN_TILE}² tile, card vs CPU max|Δ|/max|ref| {rel:.3e} (bound "
            f"{ESRGAN_REL_TOL:g}), {ms:.2f} ms a tile on the card, output std {ref.std():.3f}")
        if not rel <= ESRGAN_REL_TOL or got.shape != (1, 3, 4 * ESRGAN_TILE, 4 * ESRGAN_TILE):
            raise AssertionError(f"{name} on the card disagrees with the CPU: {rel}, {got.shape}")
        del net
    torch.cuda.empty_cache()
    return out


def hires_request(seed: int, upscaler: str = "Latent", scale: float = 2.0,
                  steps: int = STEPS) -> dict:
    """BASELINE config 3: 512² → 512·scale², Euler a, 20 steps, CFG 7.5
    (`steps` in both passes)."""
    return dict(SD15_BASE, seed=seed, batch_size=1, enable_hr=True, hr_scale=scale,
                hr_upscaler=upscaler, denoising_strength=HR_DENOISE, steps=steps)


def _hires_check(upscaler: str, scale: float):
    def check(params, seed):
        _sd15_check(params, seed)
        for want in (f"Hires upscale: {scale:g}", f"Hires upscaler: {upscaler}",
                     f"Denoising strength: {HR_DENOISE}",
                     f"Size: {SD15_BASE['width']}x{SD15_BASE['height']}"):
            if want not in params:
                raise AssertionError(f"infotext lacks {want!r}: {params!r}")
    return check


@contextlib.contextmanager
def _timed_upscales(seconds: list):
    """Each hires upscale's seconds (upscalers.upscale_by_name)."""
    from sdwebui_tpu_torch.postprocessing import upscalers

    real = upscalers.upscale_by_name

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = real(*args, **kw)
        seconds.append(time.perf_counter() - t0)
        return out
    upscalers.upscale_by_name = timed
    try:
        yield
    finally:
        upscalers.upscale_by_name = real


def phase_hires(engine, model, upscaler_paths: dict):
    """4c: BASELINE config 3 over HTTP; returns (results, summary).  The
    "Latent" requests and the first upscaler's run the full 20 steps; the
    1.5x latent modes and the other upscalers SAMPLER_STEPS, whose launch
    plans follow their steps (the upscale does not depend on them)."""
    from sdwebui_tpu_torch.pipeline.processing import setup_img2img_steps

    cfg = model.unet_cfg

    def hr_calls(steps: int) -> int:
        return setup_img2img_steps(steps, HR_DENOISE)[1] + 1

    def plan(hr_latent: int, b1: int, steps: int = STEPS) -> dict:
        n = hr_calls(steps)
        return _plan(b1=b1, b2=steps * launch_plan(cfg, 64) + n * launch_plan(cfg, hr_latent),
                     b5=steps * ln_plan(cfg, 64) + n * ln_plan(cfg, hr_latent)
                     + 2 * clip_ln_plan(model))     # the second pass encodes its prompts again

    results, plans, upscale_s = [], [], {}
    with _server(engine) as url:
        _post(f"{url}/txt2img", hires_request(1, steps=2))
        for _ in range(2):
            results.append(_request(url, "txt2img", hires_request(2024), _hires_check(
                "Latent", 2.0), 1024, "config 3 Latent"))
            plans.append(plan(128, 1))
        _check_repeat(results, 0, 1)
        for mode in ("Latent (bicubic)", "Latent (nearest-exact)"):
            results.append(_request(url, "txt2img", hires_request(
                2024, mode, 1.5, SAMPLER_STEPS), _hires_check(mode, 1.5), 768,
                f"config 3 {mode}, {SAMPLER_STEPS} steps"))
            plans.append(plan(96, 1, SAMPLER_STEPS))
        for i, name in enumerate(list(upscaler_paths) + ["Lanczos"]):
            steps, seconds = STEPS if i == 0 else SAMPLER_STEPS, []
            with _timed_upscales(seconds):
                r = _request(url, "txt2img", hires_request(2025, name, steps=steps),
                             _hires_check(name, 2.0), 1024, f"config 3 {name}, {steps} steps")
            upscale_s[name] = seconds[0]
            log(f"config 3 {name}: the upscale took {seconds[0]:.3f} s of {r['seconds']:.3f} s")
            if r["image"].std() < 1.0:
                raise AssertionError(f"config 3 {name}: the image is flat")
            results.append(dict(r, upscale_s=seconds[0]))
            plans.append(plan(128, 3, steps))
    _check_launches(results, plans)
    nets = check_upscaler_nets(upscaler_paths, engine.device)
    # the VAE attention's calls by phase-1 row: each request's decode, and on
    # the image-space route the 512² decode and the f32 1024² encode
    image_route = len(upscale_s)
    b1_calls = {("vae_mid_1024", "bfloat16"): 2 + image_route,
                ("vae_mid_768", "bfloat16"): 2, ("vae_mid_512", "bfloat16"): image_route,
                ("vae_mid_1024_f32", "float32"): image_route}
    latent_s = [r["seconds"] for r in results[:2]]
    return results, dict(hires_unet_calls=hr_calls(STEPS), upscale_s=upscale_s, nets=nets,
                         b1_calls=b1_calls, latent_wall_s=statistics.median(latent_s))


def phase_extras(engine, pngs: list, upscaler_paths: dict):
    """4d: the Extras routes with the upscale cache off."""
    from sdwebui_tpu_torch.utils.png import decode_png

    rows = []

    def run(url, route, body, shapes, label):
        reset_counts()
        t0 = time.perf_counter()
        res = _post(f"{url}/{route}", body)
        dt = time.perf_counter() - t0
        images = [res["image"]] if "image" in res else res["images"]
        got = [decode_png(base64.b64decode(b))[0].shape for b in images]
        log(f"extras {label}: {dt:.3f} s, {dt / len(images):.3f} s/image, shapes {got}")
        if got != shapes:
            raise AssertionError(f"extras {label}: shapes {got}, expected {shapes}")
        rows.append(dict(route=route, label=label, seconds=dt, images=len(images),
                         s_per_image=dt / len(images), launches=read_counts()))

    esrgan = "R-ESRGAN 4x+"
    with _server(engine) as url:
        _post(f"{url}/options", {"upscaling_max_images_in_cache": 0})
        try:
            run(url, "extra-single-image", dict(
                image=pngs[0], upscaler_1=esrgan, upscaling_resize=2, upscaler_2="Lanczos",
                extras_upscaler_2_visibility=0.5), [(1024, 1024, 3)],
                f"{esrgan} x2 + Lanczos at 0.5")
            run(url, "extra-single-image", dict(
                image=pngs[0], upscaler_1=esrgan, resize_mode=1, upscaling_resize_w=1000,
                upscaling_resize_h=700, upscaling_crop=True), [(700, 1000, 3)],
                f"{esrgan} to 1000x700, cropped")
            run(url, "extra-batch-images", dict(
                imageList=[{"data": b, "name": f"{i}.png"} for i, b in enumerate(pngs[:2])],
                upscaler_1=esrgan, upscaling_resize=2), [(1024, 1024, 3)] * 2,
                f"{esrgan} x2, batch of 2")
        finally:
            _post(f"{url}/options", {"upscaling_max_images_in_cache": 5})
        names = [u["name"] for u in _post(f"{url}/upscalers")]
    log(f"/upscalers: {names}")
    if not set(upscaler_paths) <= set(names):
        raise AssertionError(f"/upscalers lacks the files {sorted(upscaler_paths)}: {names}")
    return rows


def phase_checkpoint(model, device, phase3: dict, ckpt_dir: str):
    """4a: the random SD1.5 and a second one (seed 1, fp16) as checkpoint
    files, served by a checkpoint Engine; returns (engine, results, info)."""
    from sdwebui_tpu_torch.loader import load
    from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
    from sdwebui_tpu_torch.pipeline.sd_model import create_random_sd15
    from sdwebui_tpu_torch.server.app import Engine
    from sdwebui_tpu_torch.utils.options import opts

    first = os.path.join(ckpt_dir, "random-sd15-seed0.safetensors")
    second = os.path.join(ckpt_dir, "random-sd15-seed1-fp16.safetensors")
    t0 = time.perf_counter()
    write_safetensors(first, load.sd1_state_dict(model), metadata={"format": "pt"})
    other = create_random_sd15(seed=1, device=device)
    write_safetensors(second, {k: v.half() for k, v in load.sd1_state_dict(other).items()})
    del other
    torch.cuda.empty_cache()
    gb = os.path.getsize(first) / 1e9
    log(f"wrote {os.path.basename(first)} ({gb:.3f} GB, UNet bf16, VAE and CLIP fp32) and "
        f"{os.path.basename(second)} ({os.path.getsize(second) / 1e9:.3f} GB, fp16) in "
        f"{time.perf_counter() - t0:.2f} s")

    reads = []
    real_read = load.read_checkpoint

    def counted_read(path, *a, **k):
        reads.append(path)
        return real_read(path, *a, **k)
    load.read_checkpoint = counted_read
    opts.set("sd_checkpoints_limit", 2)
    t0 = time.perf_counter()
    engine = Engine(device=device, ckpt=first, ckpt_dirs=[ckpt_dir],
                    hash_cache=os.path.join(ckpt_dir, "hashes.json"))
    sha = engine.registry.find(os.path.basename(first)).calculate_sha256(engine.hash_cache)
    t_hash = time.perf_counter() - t0
    loaded = engine.sd_model                       # file → the model on the card
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0 - t_hash
    swaps = []
    real_reload = engine.reload_checkpoint

    def timed_reload(name=None):
        t = time.perf_counter()
        real_reload(name)
        torch.cuda.synchronize()
        swaps.append(time.perf_counter() - t)
    engine.reload_checkpoint = timed_reload

    plan = _plan(b1=1, b2=STEPS * launch_plan(loaded.unet_cfg, 64),
                 b5=STEPS * ln_plan(loaded.unet_cfg, 64) + clip_ln_plan(loaded))
    body = dict(SD15_BASE, seed=1234, batch_size=1)

    def check(params, seed):
        _sd15_check(params, seed)
        if f"Model hash: {sha[:10]}" not in params:
            raise AssertionError(f"infotext lacks the file's hash {sha[:10]}: {params!r}")

    results = []
    with _server(engine) as url:
        results.append(_request(url, "txt2img", body, check, 512, "from the file"))
        first_image_s = t_load + results[0]["seconds"]
        delta = int(abs(results[0]["image"].astype(int) - phase3["image"].astype(int)).max())
        log(f"load: sha256 {t_hash:.2f} s, file → card {t_load:.2f} s ({t_load / gb:.3f} s/GB), "
            f"file → first image {first_image_s:.2f} s; the image is {delta} uint8 levels "
            f"from phase 3's (bound {REPEAT_TOL})")
        if delta > REPEAT_TOL:
            raise AssertionError(f"the file's image differs from phase 3's by {delta}")
        _post(f"{url}/options", {"sd_model_checkpoint": os.path.basename(second)})
        results.append(_request(url, "txt2img", body, _sd15_check, 512, "the second file"))
        other_diff = float(abs(results[1]["image"].astype(int)
                               - results[0]["image"].astype(int)).mean())
        n_reads = len(reads)
        results.append(_request(url, "txt2img", dict(body, override_settings={
            "sd_model_checkpoint": os.path.basename(first)}), check, 512, "swapped back"))
        back = int(abs(results[2]["image"].astype(int) - phase3["image"].astype(int)).max())
        listed = sorted(m["filename"] for m in _post(f"{url}/sd-models"))
    log(f"second checkpoint: mean|Δ| {other_diff:.2f} levels from the first; swap back "
        f"{back} levels from phase 3 with {len(reads) - n_reads} file reads; swaps "
        + ", ".join(f"{t:.3f} s" for t in swaps) + f"; sd-models {listed}")
    if not other_diff > 1.0:
        raise AssertionError("the second checkpoint gave the first one's image")
    if back > REPEAT_TOL or len(reads) != n_reads:
        raise AssertionError(f"swap back: {back} levels from phase 3, "
                             f"{len(reads) - n_reads} file reads")
    if listed != sorted([first, second]):
        raise AssertionError(f"sd-models lists {listed}")
    load.read_checkpoint = real_read
    _check_launches(results, [plan] * 3)
    engine.reload_checkpoint = real_reload
    info = dict(file_gb=gb, sha256_s=t_hash, load_s=t_load, load_s_per_gb=t_load / gb,
                first_image_s=first_image_s, swap_s=swaps, file_reads=reads)
    return engine, results, info


def phase_samplers(engine):
    """4b: one request per sampler name on the loaded model."""
    from sdwebui_tpu_torch.pipeline.params import GenerationParams
    from sdwebui_tpu_torch.pipeline.processing import prepare_sampler
    from sdwebui_tpu_torch.sampling.solvers import build_restart_plan

    model = engine.sd_model
    per_call = launch_plan(model.unet_cfg, 64)
    results = []
    with _server(engine) as url:
        names = [s["name"] for s in _post(f"{url}/samplers")]
        for name in names:
            body = dict(SD15_BASE, sampler_name=name, steps=SAMPLER_STEPS, seed=77,
                        batch_size=1)

            def check(params, seed, name=name):
                if f"Sampler: {name}," not in params or f"Seed: {seed}," not in params:
                    raise AssertionError(f"infotext lacks sampler {name!r}: {params!r}")
            r = _request(url, "txt2img", body, check, 512, f"sampler {name!r}")
            _, spec, sigmas, _ = prepare_sampler(model, GenerationParams(
                sampler_name=name, steps=SAMPLER_STEPS), SAMPLER_STEPS)
            n = len(build_restart_plan(sigmas)[0]) if spec.name == "restart" else len(sigmas) - 1
            calls = spec.model_calls(n)
            b2 = r["launches"]["flash_attention_packed"]
            if r["image"].std() < 1.0:
                raise AssertionError(f"{name}: the image is flat")
            if calls is None:
                ok = b2 > 0 and b2 % per_call == 0
                calls = b2 // per_call
            else:
                ok = b2 == calls * per_call
            if not ok or r["launches"]["flash_attention"] != 1:
                raise AssertionError(f"{name}: launches {r['launches']} for {calls} model calls "
                                     f"of {per_call} B2 launches each")
            results.append(dict(r, sampler=name, model_calls=calls))
    log("s/request by sampler at 512², 8 steps: " + json.dumps(
        {r["sampler"]: [round(r["seconds"], 3), r["model_calls"]] for r in results}))
    return results


def phase_sdxl_unet(base, refiner, device):
    from sdwebui_tpu_torch.pipeline.processing import _decode_u8

    g = torch.Generator(device=device).manual_seed(2)
    bf16 = torch.bfloat16
    x = torch.randn((2, 4, 128, 128), generator=g, device=device).to(bf16)
    t = torch.tensor([500.0, 500.0], device=device)
    out = {}
    for label, m in (("base", base), ("refiner", refiner)):
        cfg = m.unet_cfg
        ctx = torch.randn((2, 77, cfg.context_dim), generator=g, device=device).to(bf16)
        y = torch.randn((2, cfg.adm_in_channels), generator=g, device=device)
        out[label] = _unet_step(f"SDXL {label} B=2 128x128 bf16", m.unet, cfg, 128, x, t,
                                ctx, y)
    # the SDXL VAE at 1024²: the bf16 decode and the fp32 retry dtype
    z = torch.randn((1, 4, 128, 128), generator=g, device=device)
    decoded = {}
    for dtype in (torch.bfloat16, torch.float32):
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            u8, bad = _decode_u8(base, z, dtype)
            dt = time.perf_counter() - t0
        if bad or u8.shape != (1, 1024, 1024, 3):
            raise AssertionError(f"SDXL VAE decode in {dtype}: non-finite={bad}, {u8.shape}")
        decoded[str(dtype)[6:]] = (u8.astype(int), dt)
    diff = abs(decoded["bfloat16"][0] - decoded["float32"][0])
    out["vae_decode"] = dict(bf16_s=decoded["bfloat16"][1], f32_s=decoded["float32"][1],
                             max_abs_diff=int(diff.max()), mean_abs_diff=float(diff.mean()))
    log(f"SDXL VAE decode 1024²: bf16 {decoded['bfloat16'][1]:.3f} s, fp32 "
        f"{decoded['float32'][1]:.3f} s, both finite; bf16 vs fp32 max|Δ| {diff.max()} "
        f"mean|Δ| {diff.mean():.3f} uint8 levels (bound {VAE_MEAN_DIFF_TOL:g})")
    if not diff.mean() <= VAE_MEAN_DIFF_TOL:
        raise AssertionError(f"SDXL VAE bf16 decode is {diff.mean()} levels from fp32")
    return out


def sdxl_request(seed: int, refiner_title: str) -> dict:
    """BASELINE config 5 as the JAX bench runs it (bench.py:478-489)."""
    return dict(prompt="a photograph of an astronaut riding a horse",
                negative_prompt="blurry", seed=seed, steps=STEPS, cfg_scale=7.0,
                sampler_name="DPM++ 2M", scheduler="Karras", width=1024, height=1024,
                batch_size=1, refiner_checkpoint=refiner_title,
                refiner_switch_at=SDXL_SWITCH_AT)


def phase_sdxl_serve(engine, base, refiner):
    from sdwebui_tpu_torch.pipeline.processing import _refiner_split_idx
    from sdwebui_tpu_torch.sampling.registry import build_sigmas, get_sampler

    body = sdxl_request(1234, refiner.title)

    def check(params, seed):
        for want in (f"Seed: {seed}", "Sampler: DPM++ 2M", f"Refiner: {refiner.title}"):
            if want not in params:
                raise AssertionError(f"infotext lacks {want!r}: {params!r}")

    results = _serve(engine, "txt2img", [body, body], dict(body, steps=2, seed=1), check, 1024)
    _check_repeat(results, 0, 1)
    sigmas = build_sigmas(get_sampler("DPM++ 2M"), "Karras", STEPS, base.disc, is_sdxl=True)
    s_idx = _refiner_split_idx(base, sigmas, SDXL_SWITCH_AT, STEPS)
    packed = (s_idx * launch_plan(base.unet_cfg, 128)
              + (STEPS - s_idx) * launch_plan(refiner.unet_cfg, 128))
    b5 = (s_idx * ln_plan(base.unet_cfg, 128) + (STEPS - s_idx) * ln_plan(refiner.unet_cfg, 128)
          + clip_ln_plan(base) + clip_ln_plan(refiner))
    log(f"refiner takes over after step {s_idx}")
    _check_launches(results, [_plan(b1=1, b2=packed, b5=b5)] * 2)
    return results, s_idx


def phase_sdxl_hires(engine, base, refiner):
    """6b: config 5 with hires fix; the refiner takes the second pass."""
    from sdwebui_tpu_torch.pipeline.processing import _refiner_split_idx, setup_img2img_steps
    from sdwebui_tpu_torch.sampling.registry import build_sigmas, get_sampler

    body = dict(sdxl_request(1234, refiner.title), enable_hr=True, hr_scale=1.5,
                hr_upscaler="Latent", denoising_strength=SDXL_HR_DENOISE,
                hr_second_pass_steps=STEPS)

    def check(params, seed):
        for want in (f"Seed: {seed}", "Hires upscale: 1.5", "Hires upscaler: Latent",
                     f"Hires steps: {STEPS}", f"Refiner: {refiner.title}",
                     f"Size: {body['width']}x{body['height']}"):
            if want not in params:
                raise AssertionError(f"infotext lacks {want!r}: {params!r}")

    warmup = dict(body, steps=2, hr_second_pass_steps=2, seed=1)
    (result,) = _serve(engine, "txt2img", [body], warmup, check, 1536)
    if result["image"].std() < 1.0:
        raise AssertionError("the SDXL hires image is flat")
    steps, t_enc = setup_img2img_steps(STEPS, SDXL_HR_DENOISE)
    sigmas = build_sigmas(get_sampler("DPM++ 2M"), "Karras", steps, base.disc, is_sdxl=True)
    s_idx = _refiner_split_idx(base, sigmas[steps - t_enc - 1:], SDXL_SWITCH_AT, t_enc + 1)
    r_calls = t_enc + 1 - s_idx
    b2 = (STEPS * launch_plan(base.unet_cfg, 128) + s_idx * launch_plan(base.unet_cfg, 192)
          + r_calls * launch_plan(refiner.unet_cfg, 192))
    b5 = (STEPS * ln_plan(base.unet_cfg, 128) + s_idx * ln_plan(base.unet_cfg, 192)
          + r_calls * ln_plan(refiner.unet_cfg, 192) + 2 * clip_ln_plan(base)
          + clip_ln_plan(refiner))
    log(f"SDXL hires: {t_enc + 1} second-pass calls, the refiner takes over after {s_idx}")
    _check_launches([result], [_plan(b1=1, b2=b2, b5=b5)])
    return result, dict(second_pass_calls=t_enc + 1, refiner_after=s_idx)


def kernel_class(name: str) -> str:
    if "flash_attention" in name or "attn_" in name:   # csrc/flash_attention.cu
        return "flash_attn"
    if "layer_norm_kernel" in name or "layer_norm_reg_kernel" in name:   # csrc/layer_norm.cu
        return "layer_norm"
    if "fprop" in name or "conv" in name.lower():
        return "conv"
    if "gemm" in name.lower() or "nvjet" in name or "cutlass" in name:
        return "gemm"
    if "reduce_kernel" in name:
        return "reduce"
    if "elementwise" in name or "copy" in name.lower():
        return "elementwise"
    return "other"


def phase_profile(engine, body: dict, label: str, wall: float | None = None):
    """One in-process request (the server's request parser and
    Engine.txt2img, without HTTP) under torch.profiler (CUDA activity):
    device busy is the union of the kernel intervals; the wall is `wall`
    where given (config 3: the median of phase 4c's two timed requests over
    HTTP), else the median of two in-process requests without the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    from sdwebui_tpu_torch.server.api import _params_from_request

    def run():
        p = _params_from_request(body)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.txt2img(p)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    if wall is None:
        wall = statistics.median([run(), run()])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced = run()
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type.name != "CUDA" or e.time_range.end <= e.time_range.start:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        dur = e.time_range.end - e.time_range.start
        by_name[e.name] = by_name.get(e.name, 0) + dur
    spans.sort()
    busy, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    busy_s = busy / 1e6
    by_class = {}
    for name, t in by_name.items():
        by_class[kernel_class(name)] = by_class.get(kernel_class(name), 0) + t / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    summary = dict(wall_s=wall, traced_wall_s=traced, device_busy_s=busy_s,
                   idle_share=1 - busy_s / wall, device_events=len(spans),
                   device_ms_by_class=by_class,
                   top_kernels_ms=[(n[:100], t / 1e3) for n, t in top],
                   device=torch.cuda.get_device_name(0))
    log(f"{label} request profile: wall {wall:.3f} s (traced {traced:.3f} s), device busy "
        f"{busy_s:.3f} s, idle share {1 - busy_s / wall:.3f}, {len(spans)} device events; "
        "device ms by class " + json.dumps({k: round(v, 1) for k, v in by_class.items()}))
    return summary


# each kernel of the kernels line: its TPU source line, its CUDA source and
# the phase-1 row whose times it reports (its dominant main-path shape; for
# B1, which serves only the VAE, the VAE row chosen in main())
KERNEL_ENTRIES = [
    ("flash_attention", "flash_attention.cu", "sdwebui_tpu/ops/flash_attention.py:111",
     None, None),
    ("flash_attention_packed", "flash_attention.cu", "sdwebui_tpu/ops/flash_attention.py:308",
     "sdxl_base_64x64", "bfloat16"),
    ("flash_attention_4d", "flash_attention.cu", "sdwebui_tpu/ops/flash_attention.py:429",
     "sdxl_base_64x64", "bfloat16"),
    ("conv3x3", "conv3x3.cu", "sdwebui_tpu/ops/conv.py:75", "jax_doc_64x64x320", "bfloat16"),
    # SDXL base's 1280-wide LayerNorm: 2880 of a config 5 request's 3731 launches
    ("layer_norm", "layer_norm.cu", "sdwebui_tpu/ops/pallas_norms.py:65",
     "sdxl_base_s1024_c1280", "bfloat16"),
]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    from sdwebui_tpu_torch.models.esrgan import register_esrgan_dir
    from sdwebui_tpu_torch.pipeline.sd_model import create_random_sd15
    from sdwebui_tpu_torch.postprocessing.upscalers import unregister_upscaler
    from sdwebui_tpu_torch.server.app import Engine, random_models

    device = torch.device("cuda")
    # the library calls and plain versions of phase 1 in full fp32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = marks = time.perf_counter()
    phase_s = {}

    def mark(phase: str):
        """The seconds since the previous mark, logged under `phase`."""
        nonlocal marks
        now = time.perf_counter()
        phase_s[phase] = now - marks
        log(f"phase {phase}: {now - marks:.1f} s ({now - t_start:.1f} s in all)")
        marks = now

    smi = phase_env()
    mark("0 build")
    rows = phase_kernel(device)
    mark("1 kernels")
    t0 = time.perf_counter()
    model = create_random_sd15(seed=0, device=device)
    torch.cuda.synchronize()
    log(f"random SD1.5 on the card in {time.perf_counter() - t0:.2f} s")
    unet = phase_unet(model, device)
    mark("2 SD1.5 UNet")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_upscalers_") as upscaler_dir:
        t0 = time.perf_counter()
        upscaler_paths = write_upscaler_files(upscaler_dir)
        log(f"wrote the upscaler files {sorted(upscaler_paths)} in "
            f"{time.perf_counter() - t0:.2f} s")
        # the process's upscaler registry, as the server's --esrgan-models-path
        # fills it; the files and their nets leave it with the directory
        upscaler_names = register_esrgan_dir((upscaler_dir,), device=device)
        try:
            engine = Engine(model=model, device=device)
            results = phase_serve(engine, model)
            mark("3 config 1")
            i2i_results, i2i_calls = phase_img2img(engine, model, results[0]["png_b64"])
            mark("4 config 2")
            hr_results, hr_info = phase_hires(engine, model, upscaler_paths)
            b1_calls = hr_info.pop("b1_calls")     # {(phase-1 row, dtype): calls}
            hr_info["profile"] = phase_profile(engine, hires_request(2024), "config 3",
                                               wall=hr_info["latent_wall_s"])
            mark("4c config 3")
            extras = phase_extras(engine, [results[0]["png_b64"], results[1]["png_b64"]],
                                  upscaler_paths)
            mark("4d extras")
        finally:
            for name in upscaler_names:
                unregister_upscaler(name)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
        ckpt_engine, ckpt_results, ckpt_info = phase_checkpoint(model, device, results[0],
                                                                ckpt_dir)
    mark("4a checkpoints")
    sampler_results = phase_samplers(ckpt_engine)
    mark("4b samplers")
    del model, engine, ckpt_engine
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    base, extra = random_models("sdxl", device)   # what `--model sdxl` serves
    (refiner,) = extra.values()
    engine = Engine(model=base, device=device, extra_models=extra)
    torch.cuda.synchronize()
    log(f"random SDXL base + refiner on the card in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    sdxl_unet = phase_sdxl_unet(base, refiner, device)
    mark("5 SDXL UNet and VAE")
    sdxl_results, s_idx = phase_sdxl_serve(engine, base, refiner)
    mark("6 config 5")
    sdxl_hr_result, sdxl_hr_info = phase_sdxl_hires(engine, base, refiner)
    mark("6b SDXL hires")
    profile = phase_profile(engine, sdxl_request(1234, refiner.title), "SDXL")
    mark("7 SDXL profile")

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "sdwebui_tpu"))
    if leaked:
        raise AssertionError(f"the port imported JAX or the JAX package: {leaked[:5]}")
    requests = [{k: v for k, v in r.items() if k not in ("image", "png_b64", "infotext")}
                for r in (results + i2i_results + hr_results + ckpt_results + sampler_results
                          + sdxl_results + [sdxl_hr_result])]
    log(json.dumps({"card": smi, "kernel_shapes": rows, "unet_step": unet,
                    "sdxl_unet_step": sdxl_unet, "img2img_unet_calls": i2i_calls,
                    "sdxl_refiner_after_step": s_idx, "checkpoint": ckpt_info,
                    "hires": hr_info, "extras": extras, "sdxl_hires": sdxl_hr_info,
                    "requests": requests, "sdxl_profile": profile, "phase_s": phase_s}))

    def row_of(name, shape, dtype):
        return next(r for r in rows if r["entry"] == name and r["name"] == shape
                    and r["dtype"] == dtype)

    # B1's row: the VAE shape whose launches in the timed requests times its
    # time is largest: the f32 encode at 512² (one per config 2 request), the
    # 1024² decode (config 3 and config 5 requests), the 768² decode (config
    # 3 at 1.5x), the f32 encode at 1024² (config 3's image-space route) or
    # the 1536² decode (SDXL hires)
    b1_calls[("vae_mid_512_f32", "float32")] = len(i2i_results)
    b1_calls[("vae_mid_1024", "bfloat16")] += len(sdxl_results)
    b1_calls[("vae_mid_1536", "bfloat16")] = 1
    b1_row = max(b1_calls, key=lambda c: b1_calls[c] * row_of("flash_attention", *c)["ms"])

    def entry(name, source, replaces, dominant, dtype):
        mine = [r for r in rows if r["entry"] == name]
        row = row_of(name, dominant, dtype) if dominant else row_of(name, *b1_row)
        return {"name": name, "route": "cuda", "source": f"sdwebui_tpu_torch/csrc/{source}",
                "replaces": replaces,
                "launches": sum(r["launches"][name] for r in requests),
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"]}

    # launches: every timed request of the main paths (SD1.5 txt2img,
    # img2img and hires fix, from the checkpoint files and with every
    # sampler, SDXL with and without hires fix); the times at each entry's
    # dominant shape; max_abs_err over all its compared shapes
    print(json.dumps({"kernels": [entry(*e) for e in KERNEL_ENTRIES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
