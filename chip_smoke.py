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
     768², SDXL at 1536²; SD1.5 at config 4's 8 CFG rows; SD2-depth's
     d = 64 heads at (2, 4096, 5·64) and (2, 1024, 10·64) and
     instruct-pix2pix's 3 edit-CFG rows at (3, 4096, 8·40) and (3, 1024,
     8·80); the SD1.5 and hybrid rows also on fused-qkv chunk views:
     d = 160 at S = 1024 takes the split-d wide kernel), B3 (4-D, the same
     shapes), B5 (LayerNorm at every UNet row count and width of both
     families, first and hires pass, config 4's 8 CFG rows, the SD2-depth
     and instruct-pix2pix UNets' rows, at CLIP's, and the MiDaS ViT's
     (577, 768) in f32 at eps 1e-6)
     and B4 (3x3 conv at the
     JAX docstring's shapes, the SD1.5 UNet's B=2 shapes and two ragged
     widths);
  2. the full-width SD1.5 UNet CFG step (B=2, latent 64² and the hires
     pass's 128², ctx 2x77x768, bf16, random weights), and at 64² with a
     random full-width ControlNet tower on the 16-px grid hint (config 4's
     step: the tower's residuals into the UNet), in three arms: the kernels
     (B2 + B5), plain LayerNorm (B2 only), and plain attention and
     LayerNorm: finite, max|Δ|/max|ref| <= 5e-2, ms and device events per
     call in each arm, launches per call equal to the plan's (the tower
     adds 4 B2 and 21 B5);
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
  4g. the rest of img2img on the same server, each request's B1, B2 and B5
     launches equal to the plan's (16 UNet calls: B2 = 160, B5 = 16 x 48 +
     CLIP's, B1 = the f32 encode and the decode): (g) an inpaint with the
     API's defaults (no inpainting_fill, no inpaint_full_res: fill 0 and the
     crop), padding 32, an off-centre rectangle: a 512² PNG, within 1 level
     of the init image outside the blurred mask, changed inside; (h)
     inpainting_fill 0 on the whole picture; (i) soft inpainting; (j) colour
     correction; (k) resize mode 3 on a 768² init; (l) return_mask and
     return_mask_composite (the mask and an RGBA composite follow the
     image); (m) TAESD encode and decode from seeded files at the published
     widths in a temporary models root: B1 = 0; (n) a tiling txt2img
     ("Tiling: True", unlike phase 3's untiled image of the seed); (o) a
     styles request through a temporary styles.csv (the infotext's prompts
     hold the style).  Logged: s/request, the wall ms of the fill (on the
     card, held equal in every pixel to the CPU's; and on the CPU) and of the
     crop + paste at 512², and TAESD's encode and decode ms against the full
     VAE's at 512² and 1024²;
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
  4e. BASELINE config 4 on the same server, its files made from a seed in a
     temporary directory and registered through the registries' own
     functions (dropped at the end): a rank-16 LoRA over every UNet
     attention projection, a 2-vector embedding, a hypernetwork for widths
     768/320/640/1280, and phase 2's tower as a control_model.* fp16 file.
     (a) batch 4, 512², Euler a, 20 steps, CFG 7.5, <lora:bench:0.8> and
     the trigger, one canny unit at weight 1 on the 16-px grid: PNGs,
     infotext (the tag, "TI hashes"), B2 = 20 x (10 + 4), B1 = 1, B5 = 20 x
     (48 + 21) + CLIP's; (b) the same seed again within 2 levels, with no
     second merge; (c) guidance_end 0.5: B2 = 20 x 10 + 10 x 4; (d) a
     <hypernet:...> request; (e) a tagless request: the base UNet and CLIP
     tensors equal to before the phase (torch.equal), the image within 2
     levels of phase 3's; (f) /controlnet/detect canny on a phase-3 PNG;
     (g) one config 4 request under torch.profiler, as phase 7.  The LoRA
     merge's seconds (first time and cached), s/request and the tower's ms
     per CFG call at 8 rows are logged;
  4f. the hybrid UNets and the depth half of config 4, their files made
     from a seed in a temporary directory and dropped at the end: (a) a
     full-width SD2-depth checkpoint (the SD2 UNet with 5 input channels,
     OpenCLIP-H, the VAE and a DPT-hybrid at the published widths under
     depth_model.model.) written as an ldm fp16 .safetensors and served
     through --ckpt: two img2img requests on a phase-3 PNG with one seed
     (the repeat within 2 levels; B5 adds the MiDaS forward's 24 f32
     launches and B2 nothing) and one txt2img request (not flat); the
     tower's forward at 384² on the card against the CPU (f32, TF32 off,
     max|Δ|/max|ref| <= 1e-4), its ms and launches; (b) a random
     full-width SD1.5-inpainting UNet (9 channels) answering an inpaint
     request (pixels outside the blurred mask within 1 level, changed
     inside; B1 = 3: the init encode, the masked encode, the decode);
     (c) a random instruct-pix2pix UNet (8 channels) at image_cfg_scale 1.5
     (the UNet called on 3 rows) and 1.0 (2 rows): the images differ;
     (d) /controlnet/detect with depth_midas and hed on a phase-3 PNG at
     processor_res 512 and 384 (INTER_AREA's shrink), with seeded
     annotator files at the published widths: hints not flat, B5 = 24 for
     depth_midas, nothing for hed; (e) config 4 (batch 4, LoRA, embedding)
     with a depth_midas unit on phase 2's tower.  Every request's B1, B2
     and B5 launches equal the plan's; s/request logged;
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
     2x2816) and refiner step (ctx 2x77x1280, y 2x2560), and the base step
     with a random SDXL ControlNet tower, bf16, in the three arms of phase
     2, and the SDXL VAE decode at 1024² in bf16 and in its fp32 retry
     dtype;
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
  6c. SDXL img2img on the same server (1024², DPM++ 2M Karras, 20 steps,
     CFG 7, denoising 0.75: 16 UNet calls): (a) two requests with one seed
     on a phase-6 PNG, the repeat within 2 levels; (b) an inpaint with the
     API's defaults; (c) a random full-width SDXL UNet with 9 input channels
     on an inpaint (B1 = 3: the init encode, the masked encode, the
     decode); every request's launches equal to the plan's (B2 = 16 x 70,
     B1 = 2: the f32 encode and the decode at S = 16384, B5 = 16 x 210 +
     CLIP's); (d) one SDXL img2img request under torch.profiler, as phase 7;
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
    # config 4: SD1.5 at batch 4, so 8 CFG rows (the UNet and the tower)
    ("sd15_b8_64x64", 8, 4096, 8, 40),
    ("sd15_b8_32x32", 8, 1024, 8, 80),
    # the hybrid UNets (phase 4f): SD2-depth's d = 64 heads, instruct-pix2pix's
    # three edit-CFG rows
    ("sd2_depth_64x64", 2, 4096, 5, 64),
    ("sd2_depth_32x32", 2, 1024, 10, 64),
    ("p2p_b3_64x64", 3, 4096, 8, 40),
    ("p2p_b3_32x32", 3, 1024, 8, 80),
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
                  "sd15_hr_32x32", "sd15_hr_96x96", "sd15_hr_48x48", "sd2_depth_64x64",
                  "sd2_depth_32x32", "p2p_b3_64x64", "p2p_b3_32x32")
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
    SDXL at 192²), SD1.5's at config 4's 8 CFG rows (the UNet's and the
    ControlNet tower's widths and row counts), SD2-depth's UNet at B = 2
    and instruct-pix2pix's at its 3 edit-CFG rows, and the CLIP-L / bigG
    encoders over cond + uncond (2 x 77 tokens).  (The MiDaS ViT's f32
    rows at eps 1e-6 are layer_norm_cases' own.)"""
    from sdwebui_tpu_torch.models.configs import (CLIP_L, OPEN_CLIP_BIGG, SD15_UNET,
                                                  SD21_UNET, SDXL_REFINER_UNET, SDXL_UNET)
    from sdwebui_tpu_torch.models.unet import self_attention_calls

    shapes = {}
    for fam, cfg, latents, batch in (("sd15", SD15_UNET, (64, 128, 96), 2),
                                     ("sd15_b8", SD15_UNET, (64,), 8),
                                     ("sd2_depth", SD21_UNET, (64,), 2),
                                     ("p2p_b3", SD15_UNET, (64,), 3),
                                     ("sdxl_base", SDXL_UNET, (128, 192), 2),
                                     ("sdxl_refiner", SDXL_REFINER_UNET, (128, 192), 2)):
        for latent in latents:
            for s, h, d in self_attention_calls(cfg, latent):
                shapes.setdefault(f"{fam}_s{s}_c{h * d}", (batch * s, h * d))
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
    # the MiDaS ViT (phase 4f): 577 tokens of 768 at batch 1, f32, eps 1e-6
    g = torch.Generator(device=device).manual_seed(2)
    x = _randn((577, 768), g, torch.float32, device) * 2 + 0.5
    w, b = _randn((768,), g, torch.float32, device), _randn((768,), g, torch.float32, device)
    yield dict(entry="layer_norm", name="midas_vit_577", shape=(577, 768), dtype=torch.float32,
               kernel=lambda: ln_mod.layer_norm(x, w, b, 1e-6),
               plain=lambda: ln_mod.layer_norm_plain(x, w, b, 1e-6),
               library=lambda: F.layer_norm(x, (768,), w, b, 1e-6),
               work=(7.0 * 577 * 768, 4 * (2 * 577 * 768 + 2 * 768), "fp32"))


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


def _unet_step(label, unet, cfg, latent, x, t, ctx, y=None, tower=None, hint=None):
    """The UNet call in three arms: the kernels (attention kernels + B5),
    plain LayerNorm, and plain attention with plain LayerNorm.  With a
    ControlNet tower, each call runs the tower on `hint` first and the UNet
    takes its residuals (config 4's CFG step)."""
    from sdwebui_tpu_torch.ops import flash_attention as fa
    from sdwebui_tpu_torch.ops import layer_norm as ln_mod
    from sdwebui_tpu_torch.ops import norms

    arms = {"kernels": contextlib.nullcontext, "plain_layer_norm": norms.forced_plain,
            "plain": _all_plain}
    if tower is None:
        step = lambda: unet(x, t, ctx, y)  # noqa: E731
    else:
        step = lambda: unet(x, t, ctx, y, control=tower(x, t, ctx, hint, y))  # noqa: E731
    res, outs = {}, {}
    with torch.inference_mode():
        for arm, ctx_mgr in arms.items():
            with ctx_mgr():
                reset_counts()
                outs[arm] = step().float()
                torch.cuda.synchronize()
                if arm == "kernels":
                    towers = 0 if tower is None else 1
                    planned = (launch_plan(cfg, latent) + towers * launch_plan(cfg, latent, False),
                               0, ln_plan(cfg, latent) + towers * ln_plan(cfg, latent, False))
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


def _grid_hint(size: int, batch: int, device) -> torch.Tensor:
    """The JAX bench's control image (bench.py:388-390): white lines every
    16 px on black, as a (batch, 3, size, size) hint in [0, 1]."""
    hint = torch.zeros((batch, 3, size, size), device=device)
    hint[:, :, ::16, :] = 1.0
    hint[:, :, :, ::16] = 1.0
    return hint


def random_tower(cfg, seed: int, device):
    """A ControlNet tower of `cfg` in bf16 with random weights from `seed`
    (every conv, the zero-convs too, N(0, 1/fan-in))."""
    from sdwebui_tpu_torch.models.controlnet import ControlNetModel
    from sdwebui_tpu_torch.models.layers import reset_random

    tower = ControlNetModel(cfg, device=device, dtype=torch.bfloat16)
    reset_random(tower, torch.Generator(device=device).manual_seed(seed))
    return tower


def phase_unet(model, device, tower):
    """The SD1.5 UNet step at the first pass's 64² latent and at the hires
    pass's 128² (config 3), and at 64² with the ControlNet tower (config
    4's step: the tower on the grid hint, its residuals into the UNet)."""
    out = {}
    for latent, with_tower in ((64, False), (128, False), (64, True)):
        g = torch.Generator(device=device).manual_seed(1)
        x = torch.randn((2, 4, latent, latent), generator=g, device=device).to(torch.bfloat16)
        t = torch.tensor([500.0, 500.0], device=device)
        ctx = torch.randn((2, 77, 768), generator=g, device=device).to(torch.bfloat16)
        name = f"{latent}x{latent}" + ("_controlnet" if with_tower else "")
        out[name] = _unet_step(
            f"SD1.5 B=2 {name} bf16", model.unet, model.unet_cfg, latent, x, t, ctx,
            tower=tower if with_tower else None, hint=_grid_hint(8 * latent, 2, device))
        del x, ctx
        torch.cuda.empty_cache()
    return out


def launch_plan(cfg, latent: int, decoder: bool = True) -> int:
    """B2 launches of one UNet forward at latent² (decoder=False: of one
    ControlNet tower's, the encoder and middle block), from the config and
    the dispatch rule (ops/attention.py): every self-attention with Skv >=
    FLASH_MIN_KV, whatever its head dim.  No UNet call reaches B1."""
    from sdwebui_tpu_torch.models.unet import self_attention_calls
    from sdwebui_tpu_torch.ops.attention import FLASH_MIN_KV

    return sum(s >= FLASH_MIN_KV for s, _, _ in self_attention_calls(cfg, latent, decoder))


def ln_plan(cfg, latent: int, decoder: bool = True) -> int:
    """B5 launches of one UNet (or tower) forward: three per transformer
    block."""
    from sdwebui_tpu_torch.models.unet import self_attention_calls

    return 3 * len(self_attention_calls(cfg, latent, decoder))


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


def _request(url, route, body, check, size, label=None, extra: int = 0) -> dict:
    """POST one generation request and check its images: (seconds, the
    last image decoded and as sent, launches); `extra` images follow the
    batch's (img2img's returned masks), decoded under "extras"."""
    from sdwebui_tpu_torch.utils.png import decode_png

    reset_counts()
    t0 = time.perf_counter()
    res = _post(f"{url}/{route}", body)
    dt = time.perf_counter() - t0
    launches = read_counts()
    first = json.loads(res["info"])["index_of_first_image"]
    images = [decode_png(base64.b64decode(b)) for b in res["images"][first:]]
    extras = [img for img, _ in images[len(images) - extra:]] if extra else []
    images = images[:len(images) - extra]
    if len(images) != body.get("batch_size", 1):
        raise AssertionError(f"{len(images)} images for batch {body.get('batch_size')}")
    for i, (img, text) in enumerate(images):
        if img.shape != (size, size, 3):
            raise AssertionError(f"image shape {img.shape}")
        check(text.get("parameters", ""), body["seed"] + i)
    log(f"{label or route} {size}² batch {len(images)} seed {body['seed']}: {dt:.3f} s, "
        f"{len(images) / dt:.3f} images/s, launches {launches}")
    return dict(route=route, label=label or route, batch=len(images), seed=body["seed"],
                seconds=dt, images_per_s=len(images) / dt, launches=launches, image=images[-1][0],
                png_b64=res["images"][first + len(images) - 1], extras=extras,
                infotext=images[-1][1].get("parameters", ""))


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


def _check_overlay(out, init, mask):
    """The inpaint's pixels outside the blurred mask within OVERLAY_TOL of
    the init image, and changed inside the mask."""
    from sdwebui_tpu_torch.utils.masking import blur_mask

    if out.shape != init.shape:
        raise AssertionError(f"inpaint image {out.shape}, init image {init.shape}")
    blurred = blur_mask(mask, MASK_BLUR)
    outside = int(abs(out.astype(int) - init.astype(int))[blurred == 0].max())
    inside = float(abs(out.astype(int) - init.astype(int))[mask > 0].mean())
    log(f"inpaint: outside the blurred mask max|Δ| {outside} uint8 levels from the init "
        f"image (bound {OVERLAY_TOL}); inside mean|Δ| {inside:.2f}")
    if outside > OVERLAY_TOL or not inside > 1.0:
        raise AssertionError(f"inpaint overlay wrong: outside {outside}, inside {inside}")


def _rect_mask_png(size: int):
    """Config 2's rectangle mask at size² (and as an RGB PNG)."""
    from sdwebui_tpu_torch.utils.png import encode_png

    mask_rgb = torch.zeros((size, size, 3), dtype=torch.uint8)
    mask_rgb[size * 5 // 16:size * 11 // 16, size // 4:size * 3 // 4] = 255
    return mask_rgb[:, :, 0].numpy(), base64.b64encode(encode_png(mask_rgb.numpy())).decode()


def phase_img2img(engine, model, init_png: str):
    """BASELINE config 2: img2img twice with one seed, then an inpaint."""
    from sdwebui_tpu_torch.pipeline.img2img import setup_img2img_steps
    from sdwebui_tpu_torch.utils.png import decode_png

    init = decode_png(base64.b64decode(init_png))[0]
    mask, mask_png = _rect_mask_png(512)
    base = dict(SD15_BASE, init_images=[init_png], denoising_strength=DENOISE, batch_size=1)
    inpaint = dict(base, seed=4321, mask=mask_png, mask_blur=MASK_BLUR, inpainting_fill=1,
                   inpaint_full_res=False)

    def check(params, seed):
        _sd15_check(params, seed)
        if f"Denoising strength: {DENOISE}" not in params:
            raise AssertionError(f"infotext lacks the denoising strength: {params!r}")

    results = _serve(engine, "img2img", [dict(base, seed=1234), dict(base, seed=1234), inpaint],
                     dict(base, seed=1, steps=2), check, 512)
    _check_repeat(results, 0, 1)
    _check_overlay(results[2]["image"], init, mask)
    _, t_enc = setup_img2img_steps(STEPS, DENOISE)
    calls = t_enc + 1                  # the last t_enc + 2 sigmas; Euler a: one call per step
    expected = [_plan(b1=2, b2=calls * launch_plan(model.unet_cfg, 64),   # B1: encode, decode
                      b5=calls * ln_plan(model.unet_cfg, 64) + clip_ln_plan(model))
                ] * 3
    _check_launches(results, expected)
    return results, calls


def _offcentre_mask_png(size: int):
    """Phase 4g's rectangle mask, off the centre (and as an RGB PNG)."""
    from sdwebui_tpu_torch.utils.png import encode_png

    mask = torch.zeros((size, size, 3), dtype=torch.uint8)
    mask[size * 9 // 16:size * 13 // 16, size // 8:size * 7 // 16] = 255
    return mask[:, :, 0].numpy(), base64.b64encode(encode_png(mask.numpy())).decode()


def host_ms(fn, repeats: int = 3) -> float:
    """The median host milliseconds of fn()."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def write_taesd_files(directory: str, device, seed: int = 3) -> None:
    """TAESD's encoder and decoder for SD1/SD2 at the published widths
    (64-wide blocks, 4 latent channels), seeded, where the port looks for
    them under a models root: VAE-taesd/taesd_{encoder,decoder}."""
    from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
    from sdwebui_tpu_torch.models.vae_approx import random_taesd

    os.makedirs(os.path.join(directory, "VAE-taesd"))
    for i, which in enumerate(("encoder", "decoder")):
        write_safetensors(os.path.join(directory, "VAE-taesd", f"taesd_{which}.safetensors"),
                          random_taesd(which, 4, seed + i, device).state_dict())


def taesd_vs_vae(model, device) -> dict:
    """TAESD's encode and decode against the full VAE's (f32 encode, bf16
    decode, as the pipeline runs them) at 512² and 1024²: device ms each."""
    from sdwebui_tpu_torch.models import vae_approx

    enc = vae_approx.get_taesd(model.kind, "encoder", device)
    dec = vae_approx.get_taesd(model.kind, "decoder", device)
    out = {}
    for size in (512, 1024):
        g = torch.Generator(device=device).manual_seed(size)
        img = torch.rand((1, 3, size, size), generator=g, device=device)
        z = torch.randn((1, 4, size // 8, size // 8), generator=g, device=device)
        with torch.inference_mode():
            row = {
                "taesd_encode_ms": cuda_ms(lambda: vae_approx.taesd_encode(enc, img),
                                           hide_host=False),
                "vae_encode_f32_ms": cuda_ms(lambda: model.vae.encode_mode(
                    model.vae.encode_moments(img * 2 - 1)), hide_host=False),
                "taesd_decode_ms": cuda_ms(lambda: vae_approx.taesd_decode(dec, z),
                                           hide_host=False),
                "vae_decode_bf16_ms": cuda_ms(lambda: model.vae.decode(z.to(torch.bfloat16)),
                                              hide_host=False)}
        out[f"{size}x{size}"] = row
        log(f"TAESD vs the full VAE at {size}²: " + json.dumps({k: round(v, 3)
                                                                 for k, v in row.items()}))
    return out


def phase_img2img_options(engine, model, phase3: dict, directory: str, device):
    """4g: the rest of img2img on the phase-3 server: (g) an inpaint with the
    API's defaults (inpainting_fill 0, inpaint_full_res) and padding 32;
    (h) fill 0 on the whole picture; (i) soft inpainting; (j) colour
    correction; (k) resize mode 3 on a 768² init; (l) return_mask and
    return_mask_composite; (m) TAESD encode and decode; (n) a tiling
    txt2img; (o) a styles request.  Returns (results, info)."""
    from sdwebui_tpu_torch.models import vae_approx
    from sdwebui_tpu_torch.pipeline.img2img import apply_overlay, setup_img2img_steps
    from sdwebui_tpu_torch.text.styles import StyleDatabase
    from sdwebui_tpu_torch.utils import images as images_util
    from sdwebui_tpu_torch.utils import masking
    from sdwebui_tpu_torch.utils.png import decode_png, encode_png

    init_png = phase3["png_b64"]
    init = decode_png(base64.b64decode(init_png))[0]
    size = SD15_BASE["width"]
    _, t_enc = setup_img2img_steps(STEPS, DENOISE)
    calls = t_enc + 1
    i2i = _plan(b1=2, b2=calls * launch_plan(model.unet_cfg, 64),
                b5=calls * ln_plan(model.unet_cfg, 64) + clip_ln_plan(model))
    t2i = _plan(b1=1, b2=STEPS * launch_plan(model.unet_cfg, 64),
                b5=STEPS * ln_plan(model.unet_cfg, 64) + clip_ln_plan(model))
    base = dict(SD15_BASE, init_images=[init_png], denoising_strength=DENOISE, batch_size=1)
    mask, mask_png = _offcentre_mask_png(size)
    masked = dict(base, mask=mask_png, mask_blur=MASK_BLUR)
    whole = dict(masked, inpaint_full_res=False)

    def check_i2i(params, seed):
        _sd15_check(params, seed)
        if f"Denoising strength: {DENOISE}" not in params:
            raise AssertionError(f"infotext lacks the denoising strength: {params!r}")

    big = images_util.resize(init, (768, 768), "lanczos")
    big_png = base64.b64encode(encode_png(big)).decode()
    styles_path = os.path.join(directory, "styles.csv")
    with open(styles_path, "w", encoding="utf-8") as f:
        f.write("name,prompt,negative_prompt\n"
                "chip smoke,\"{prompt}, oil painting, brush strokes\",\"photo\"\n")
    os.makedirs(os.path.join(directory, "models"))
    write_taesd_files(os.path.join(directory, "models"), device)
    prev_root, prev_styles = vae_approx.models_root(), engine.styles
    vae_approx.set_models_root(os.path.join(directory, "models"))
    engine.styles = StyleDatabase(styles_path)
    results, plans = [], []

    def run(url, route, body, label, plan, check=check_i2i, extra=0):
        results.append(_request(url, route, body, check, size, label, extra))
        plans.append(plan)
        return results[-1]

    try:
        with _server(engine) as url:
            _post(f"{url}/img2img", dict(masked, seed=1, steps=2, inpaint_full_res_padding=32))
            # (g) no inpainting_fill, no inpaint_full_res: the schema's 0 and True
            g = run(url, "img2img", dict(masked, seed=4321, inpaint_full_res_padding=32),
                    "(g) inpaint, API defaults, padding 32", i2i)
            _check_overlay(g["image"], init, mask)
            h = run(url, "img2img", dict(whole, seed=4321, inpainting_fill=0),
                    "(h) inpainting_fill 0, whole picture", i2i)
            _check_overlay(h["image"], init, mask)
            i = run(url, "img2img", dict(whole, seed=4321, inpainting_fill=1,
                                         soft_inpainting=True),
                    "(i) soft inpainting", i2i)
            _check_overlay(i["image"], init, mask)
            run(url, "img2img", dict(base, seed=1234, override_settings={
                "img2img_color_correction": True}), "(j) colour correction", i2i)
            k = run(url, "img2img", dict(base, seed=1234, init_images=[big_png], resize_mode=3),
                    "(k) resize mode 3, 768² init", i2i)
            l_ = run(url, "img2img", dict(whole, seed=4321, inpainting_fill=1, override_settings={
                "return_mask": True, "return_mask_composite": True}),
                "(l) return_mask and return_mask_composite", i2i, extra=2)
            shapes = [x.shape for x in l_["extras"]]
            if shapes != [(size, size, 3), (size, size, 4)]:
                raise AssertionError(f"(l) returned masks {shapes}")
            m = run(url, "img2img", dict(base, seed=1234, override_settings={
                "sd_vae_encode_method": "TAESD", "sd_vae_decode_method": "TAESD"}),
                "(m) TAESD encode and decode", dict(i2i, flash_attention=0))
            n = run(url, "txt2img", dict(SD15_BASE, seed=1234, batch_size=1, tiling=True),
                    "(n) tiling txt2img", t2i, check=_sd15_check)
            o = run(url, "txt2img", dict(SD15_BASE, seed=1234, batch_size=1,
                                         styles=["chip smoke"]),
                    "(o) styles", t2i, check=_sd15_check)
        vae = taesd_vs_vae(model, device)
    finally:
        vae_approx.set_models_root(prev_root)
        engine.styles = prev_styles
    _check_launches(results, plans)
    for r in (k, m):
        if r["image"].std() < 1.0:
            raise AssertionError(f"{r['label']}: the image is flat")
    if "Tiling: True" not in n["infotext"] or (n["image"] == phase3["image"]).all():
        raise AssertionError("(n) the tiling request's infotext or image is the untiled one's")
    styled = (f"{SD15_BASE['prompt']}, oil painting, brush strokes\nNegative prompt: "
              f"{SD15_BASE['negative_prompt']}, photo\n")
    if not o["infotext"].startswith(styled):
        raise AssertionError(f"(o) infotext lacks the style: {o['infotext'][:160]!r}")

    # the host side of the default inpaint: the fill and the crop + paste
    blurred = masking.blur_mask(masking.binarize_mask(mask), MASK_BLUR)
    box = masking.expand_crop_region(masking.get_crop_region_v2(blurred > 127, 32), size,
                                     size, size, size)
    crop = images_util.resize(images_util.crop(init, box), (size, size), "lanczos")
    crop_mask = images_util.resize(images_util.crop(blurred, box), (size, size))
    info = {"mask": crop_mask, "overlay_mask": blurred, "crop_region": box, "originals": [init]}
    filled = masking.fill(crop, crop_mask, device)
    if not (filled == masking.fill(crop, crop_mask, "cpu")).all():
        raise AssertionError("masking.fill on the card differs from the CPU's")

    def card_fill():
        masking.fill(crop, crop_mask, device)
        torch.cuda.synchronize()

    host = {"fill_512_card_ms": host_ms(card_fill),
            "fill_512_cpu_ms": host_ms(lambda: masking.fill(crop, crop_mask, "cpu")),
            "crop_paste_512_ms": host_ms(lambda: apply_overlay(init, info, 0)),
            "crop_region": list(box)}
    log("inpaint fill (on the card, equal to the CPU's in every pixel) and crop + paste at "
        "512², wall ms: " + json.dumps(host))
    seconds = {r["label"]: r["seconds"] for r in results}
    log(f"(m) TAESD request {m['seconds']:.3f} s against phase 4's full-VAE img2img")
    # f32 encodes at 512² (B1's vae_mid_512_f32 row): every img2img request but TAESD's
    f32_encodes = sum(r["route"] == "img2img" for r in results) - 1
    return results, dict(seconds=seconds, host=host, taesd_vs_vae=vae,
                         f32_encodes_512=f32_encodes)


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


# config 4's files (bench.py:313-342, 384-396): a rank-16 LoRA over every
# UNet attention projection, a 2-vector embedding (its name the trigger), a
# hypernetwork for SD1.5's context and attention widths, and the tower
LORA_RANK = 16
CN_TRIGGER = "chipemb"
HN_WIDTHS = (768, 320, 640, 1280)
CN_BATCH = 4


def write_network_files(directory: str, model, tower, seed: int = 7) -> dict:
    """The config 4 files in `directory`, made from `seed`: bench.safetensors
    (LoRA, up and down N(0, 0.01²), alpha = rank), chipemb.safetensors
    (N(0, 0.02²), the scale of the CLIP token table), chiphn.safetensors
    (the JAX package's hypernetwork layout, structure 1-2-1, weights
    N(0, 0.01²)) and chipcn.safetensors (`tower` as control_model.* fp16)."""
    from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors

    g = torch.Generator().manual_seed(seed)
    lora = {}
    for name, w in model.unet.named_parameters():
        mod = name[: -len(".weight")]
        if name.endswith(".weight") and w.dim() == 2 and (".attn1.to_" in mod
                                                          or ".attn2.to_" in mod):
            key = "lora_unet_" + mod.replace(".", "_")
            lora[f"{key}.lora_up.weight"] = torch.randn(w.shape[0], LORA_RANK, generator=g) * 0.01
            lora[f"{key}.lora_down.weight"] = torch.randn(LORA_RANK, w.shape[1],
                                                          generator=g) * 0.01
            lora[f"{key}.alpha"] = torch.tensor(float(LORA_RANK))
    hn = {}
    for width in HN_WIDTHS:
        for tag in "kv":
            for li, (cin, cout) in enumerate(((width, 2 * width), (2 * width, width))):
                hn[f"{width}.{tag}.linear.{li}.weight"] = torch.randn(cin, cout, generator=g) * 0.01
                hn[f"{width}.{tag}.linear.{li}.bias"] = torch.zeros(cout)
    paths = {name: os.path.join(directory, name + ".safetensors")
             for name in ("bench", CN_TRIGGER, "chiphn", "chipcn")}
    write_safetensors(paths["bench"], lora)
    width = model.conditioner.cfg.width
    write_safetensors(paths[CN_TRIGGER], {"emb_params": torch.randn(2, width, generator=g) * 0.02})
    write_safetensors(paths["chiphn"], hn, metadata={"activation_func": "linear"})
    write_safetensors(paths["chipcn"], {"control_model." + k: v.half()
                                        for k, v in tower.state_dict().items()})
    log(f"config 4 files: LoRA {len(lora) // 3} modules rank {LORA_RANK}, embedding "
        f"{CN_TRIGGER!r} (2 vectors), hypernetwork widths {HN_WIDTHS}, tower "
        f"{os.path.getsize(paths['chipcn']) / 1e9:.3f} GB fp16")
    return paths


def config4_request(seed: int, hint_png: str, **unit) -> dict:
    """BASELINE config 4 as the JAX bench's lora_cn leg (bench.py:378-396):
    config 1 at batch 4 with the LoRA tag and the embedding's trigger, and
    one canny unit at weight 1 on the 16-px grid."""
    return dict(SD15_BASE, seed=seed, batch_size=CN_BATCH,
                prompt=f"{SD15_BASE['prompt']}, {CN_TRIGGER} <lora:bench:0.8>",
                controlnet_units=[dict(dict(model="chipcn", image=hint_png, module="canny",
                                            weight=1.0), **unit)])


@contextlib.contextmanager
def _timed_merges(first: list, cached: list):
    """The seconds of each LoRA merge (extra_networks._merge) and of each
    activation that found its merge cached (apply_to_model without one)."""
    from sdwebui_tpu_torch.networks import extra_networks

    real_merge, real_apply = extra_networks._merge, extra_networks.apply_to_model
    merges = []

    def merge(*args):
        t0 = time.perf_counter()
        out = real_merge(*args)
        torch.cuda.synchronize()
        merges.append(time.perf_counter() - t0)
        return out

    def apply(*args):
        n, t0 = len(merges), time.perf_counter()
        out = real_apply(*args)
        if len(merges) == n:
            cached.append(time.perf_counter() - t0)
        else:
            first.append(merges[-1])
        return out
    extra_networks._merge, extra_networks.apply_to_model = merge, apply
    try:
        yield
    finally:
        extra_networks._merge, extra_networks.apply_to_model = real_merge, real_apply


@contextlib.contextmanager
def _network_registries(engine, directory: str):
    """The LoRA, hypernetwork, ControlNet and embedding registries over
    `directory` (as --lora-dir, --hypernetwork-dir, --controlnet-dir and
    --embeddings-dir set them), back to their defaults afterwards."""
    from sdwebui_tpu_torch.networks.extra_networks import DEFAULT_LORA_DIRS, set_lora_dirs
    from sdwebui_tpu_torch.networks.hypernetwork import (DEFAULT_HYPERNETWORK_DIR,
                                                         set_hypernetwork_dirs)
    from sdwebui_tpu_torch.networks.textual_inversion import DEFAULT_EMBEDDINGS_DIR
    from sdwebui_tpu_torch.pipeline import control

    set_lora_dirs([directory])
    set_hypernetwork_dirs([directory])
    control.set_model_dirs([directory])
    engine.embeddings_dir = directory
    engine.refresh_embeddings()
    try:
        yield
    finally:
        set_lora_dirs(DEFAULT_LORA_DIRS)
        set_hypernetwork_dirs([DEFAULT_HYPERNETWORK_DIR])
        control.set_model_dirs([control.DEFAULT_CONTROLNET_DIR])
        engine.embeddings_dir = DEFAULT_EMBEDDINGS_DIR
        engine.refresh_embeddings()
        engine.sd_model.network_cache.clear()


def phase_config4(engine, model, phase3: dict, directory: str, tower):
    """4e: BASELINE config 4 on the phase-3 server; returns (results, info)."""
    from sdwebui_tpu_torch.pipeline import control
    from sdwebui_tpu_torch.utils.png import decode_png, encode_png

    cfg, size = model.unet_cfg, SD15_BASE["width"]
    latent = size // 8
    modules = {"unet": model.unet, "clip": model.conditioner.model}
    before = {m: {k: v.clone() for k, v in mod.state_dict().items()}
              for m, mod in modules.items()}
    write_network_files(directory, model, tower)
    grid = torch.zeros((size, size, 3), dtype=torch.uint8)
    grid[::16] = 255
    grid[:, ::16] = 255
    hint_png = base64.b64encode(encode_png(grid.numpy())).decode("ascii")

    def check(params, seed):
        _sd15_check(params, seed)
        for want in ("<lora:bench:0.8>", f'TI hashes: "{CN_TRIGGER}: '):
            if want not in params:
                raise AssertionError(f"infotext lacks {want!r}: {params!r}")

    def plan(tower_calls: int = STEPS, batch_clip: int = 1) -> dict:
        return _plan(b1=1, b2=STEPS * launch_plan(cfg, latent) + tower_calls * launch_plan(
            cfg, latent, False), b5=STEPS * ln_plan(cfg, latent) + tower_calls * ln_plan(
            cfg, latent, False) + batch_clip * clip_ln_plan(model))

    first, cached, results, plans = [], [], [], []
    with _network_registries(engine, directory):
        with _server(engine) as url, _timed_merges(first, cached):
            _post(f"{url}/txt2img", dict(config4_request(1, hint_png), steps=2, batch_size=1))
            first.clear()       # the warm-up merged the set; the timed runs merge anew
            cached.clear()
            engine.sd_model.network_cache.clear()
            for label in ("config 4", "config 4 repeat"):       # (a), (b)
                results.append(_request(url, "txt2img", config4_request(1234, hint_png), check,
                                        size, label))
                plans.append(plan())
            _check_repeat(results, 0, 1)
            if len(first) != 1 or len(cached) != 1:
                raise AssertionError(f"merges {first}, cached activations {cached}: the "
                                     "repeated tag set must merge once")
            log(f"config 4: LoRA merge {first[0]:.3f} s the first time, the cached set "
                f"{cached[0] * 1e3:.2f} ms; s/request {results[0]['seconds']:.3f}, "
                f"{results[1]['seconds']:.3f}")
            results.append(_request(url, "txt2img", config4_request(                # (c)
                1234, hint_png, guidance_end=0.5), check, size, "config 4 guidance_end 0.5"))
            plans.append(plan(tower_calls=STEPS // 2))
            body = dict(SD15_BASE, seed=1234, batch_size=1,                          # (d)
                        prompt=SD15_BASE["prompt"] + " <hypernet:chiphn:1.0>")
            results.append(_request(url, "txt2img", body, _sd15_check, size, "hypernetwork"))
            plans.append(plan(tower_calls=0))
            results.append(_request(url, "txt2img", dict(SD15_BASE, seed=1234, batch_size=1),
                                    _sd15_check, size, "tagless"))                   # (e)
            plans.append(plan(tower_calls=0))
            detect = _post(url.replace("/sdapi/v1", "/controlnet/detect"), {          # (f)
                "controlnet_module": "canny", "controlnet_input_images": [phase3["png_b64"]],
                "controlnet_processor_res": size})
        _check_launches(results, plans)
        tagless = results[-1]["image"].astype(int)
        delta = int(abs(tagless - phase3["image"].astype(int)).max())
        changed = [k for m, mod in modules.items() for k, v in mod.state_dict().items()
                   if not torch.equal(v, before[m][k])]
        log(f"tagless request after config 4: max|Δ| {delta} uint8 levels from phase 3's image "
            f"(bound {REPEAT_TOL}); {len(changed)} base tensors changed")
        if delta > REPEAT_TOL or changed:
            raise AssertionError(f"the base model changed: {delta} levels, {changed[:4]}")
        (edges,) = [decode_png(base64.b64decode(b))[0] for b in detect["images"]]
        share = float((edges > 0).mean())
        log(f"/controlnet/detect canny on a phase-3 PNG: {edges.shape}, {share:.4f} edge pixels")
        if edges.shape[:2] != (size, size) or set(edges.ravel().tolist()) - {0, 255} \
                or not 0 < share < 0.5:
            raise AssertionError(f"canny over /controlnet/detect: {edges.shape}, {share}")
        # the tower alone at config 4's 8 CFG rows
        (live, _), = control._resident.values()
        g = torch.Generator(device=engine.device).manual_seed(3)
        x = torch.randn((2 * CN_BATCH, 4, latent, latent), generator=g,
                        device=engine.device).to(torch.bfloat16)
        t = torch.full((2 * CN_BATCH,), 500.0, device=engine.device)
        ctx = torch.randn((2 * CN_BATCH, 77, cfg.context_dim), generator=g,
                          device=engine.device).to(torch.bfloat16)
        hint = _grid_hint(size, 2 * CN_BATCH, engine.device)
        with torch.inference_mode():
            tower_ms = cuda_ms(lambda: live(x, t, ctx, hint), iters=5, hide_host=False)
        log(f"ControlNet tower per CFG call at {2 * CN_BATCH} rows, {latent}² latent: "
            f"{tower_ms:.2f} ms")
        info = dict(merge_s=first[0], cached_activation_s=cached[0], tower_ms_per_cfg_call=tower_ms,
                    tagless_delta=delta, detect_edge_share=share,
                    profile=phase_profile(engine, config4_request(1234, hint_png), "config 4",
                                          wall=statistics.median(
                                              r["seconds"] for r in results[:2])))
    return results, info


# phase 4f: the hybrid UNets and the depth half of config 4
P2P_IMAGE_CFG = 1.5
DPT_REL_TOL = 1e-4        # max|Δ| / max|ref|, the MiDaS tower on the card vs the CPU, f32
DETECT_RES = (512, 384)   # processor_res on a 512² PNG: as it is, and INTER_AREA's shrink


def midas_ln_plan() -> int:
    """B5 launches of one MiDaS forward: two per ViT block, f32 (its
    577-token attention takes the plain path, so no B2)."""
    from sdwebui_tpu_torch.models.midas import DPTConfig

    return 2 * DPTConfig().vit_layers


def write_annotator_files(directory: str, device, seed: int = 5) -> dict:
    """The model annotators' files at the published widths, made from
    `seed`: ControlNetHED.safetensors (widths 64..512, fp32) and
    dpt_hybrid-midas-501f0c75.safetensors (the DPT-hybrid, fp16)."""
    from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
    from sdwebui_tpu_torch.models.hed import create_random_hed
    from sdwebui_tpu_torch.models.midas import create_random_dpt

    paths = {"hed": os.path.join(directory, "ControlNetHED.safetensors"),
             "depth_midas": os.path.join(directory, "dpt_hybrid-midas-501f0c75.safetensors")}
    write_safetensors(paths["hed"], {k: v.cpu() for k, v in
                                     create_random_hed(seed, device).state_dict().items()})
    write_safetensors(paths["depth_midas"], {k: v.half().cpu() for k, v in
                                             create_random_dpt(seed, device).state_dict().items()})
    return paths


@contextlib.contextmanager
def _rows_seen(unet, rows: list):
    """Appends the batch rows of every call of `unet` to `rows`."""
    handle = unet.register_forward_pre_hook(lambda module, args: rows.append(args[0].shape[0]))
    try:
        yield
    finally:
        handle.remove()


def phase_hybrid(engine, model, phase3: dict, directory: str, device, tower):
    """4f: (a) SD2-depth from an fp16 file through --ckpt, (b) the
    inpainting model, (c) instruct-pix2pix, (d) /controlnet/detect with the
    model annotators, (e) config 4 with a depth_midas unit on phase 2's
    tower; returns (results, info)."""
    import copy

    from sdwebui_tpu_torch.loader import load
    from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
    from sdwebui_tpu_torch.pipeline import annotators
    from sdwebui_tpu_torch.pipeline.img2img import setup_img2img_steps
    from sdwebui_tpu_torch.pipeline.sd_model import (create_random_sd2_depth,
                                                     create_random_sd15)
    from sdwebui_tpu_torch.server.app import Engine
    from sdwebui_tpu_torch.utils.png import decode_png

    init_png = phase3["png_b64"]
    init = decode_png(base64.b64decode(init_png))[0]
    size = SD15_BASE["width"]
    latent = size // 8
    _, t_enc = setup_img2img_steps(STEPS, DENOISE)
    calls = t_enc + 1
    base = dict(SD15_BASE, init_images=[init_png], denoising_strength=DENOISE, batch_size=1)
    midas = midas_ln_plan()
    results, plans, info = [], [], {}

    def i2i_plan(m, b1, rows_midas=0):
        return _plan(b1=b1, b2=calls * launch_plan(m.unet_cfg, latent),
                     b5=calls * ln_plan(m.unet_cfg, latent) + clip_ln_plan(m) + rows_midas * midas)

    def check_i2i(params, seed):
        _sd15_check(params, seed)
        if f"Denoising strength: {DENOISE}" not in params:
            raise AssertionError(f"infotext lacks the denoising strength: {params!r}")

    # (a) SD2-depth: an ldm fp16 file served through --ckpt
    t0 = time.perf_counter()
    path = os.path.join(directory, "random-sd2-depth-fp16.safetensors")
    depth = create_random_sd2_depth(seed=21, device=device)
    write_safetensors(path, {k: v.half() for k, v in load.ldm_state_dict(depth).items()})
    del depth
    torch.cuda.empty_cache()
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine_d = Engine(device=device, ckpt=path, ckpt_dirs=[directory],
                      hash_cache=os.path.join(directory, "hashes.json"))
    loaded = engine_d.sd_model
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    log(f"SD2-depth file {os.path.getsize(path) / 1e9:.3f} GB written in {t_write:.2f} s, "
        f"loaded (sha256 and file → card) in {t_load:.2f} s: {loaded.kind}, "
        f"{loaded.unet_cfg.in_channels}-channel UNet, depth tower {loaded.is_depth}")
    if not (loaded.kind == "sd2" and loaded.is_depth and loaded.unet_cfg.in_channels == 5):
        raise AssertionError("the SD2-depth file did not load as the depth variant")
    with _server(engine_d) as url:
        _post(f"{url}/img2img", dict(base, seed=1, steps=2))
        for label in ("SD2-depth img2img", "SD2-depth img2img repeat"):
            results.append(_request(url, "img2img", dict(base, seed=1234), check_i2i, size, label))
            plans.append(i2i_plan(loaded, b1=2, rows_midas=1))
        results.append(_request(url, "txt2img", dict(SD15_BASE, seed=1234, batch_size=1),
                                _sd15_check, size, "SD2-depth txt2img"))
        plans.append(_plan(b1=1, b2=STEPS * launch_plan(loaded.unet_cfg, latent),
                           b5=STEPS * ln_plan(loaded.unet_cfg, latent) + clip_ln_plan(loaded)))
    _check_repeat(results, 0, 1)
    if results[2]["image"].std() < 1.0:
        raise AssertionError("the SD2-depth txt2img image is flat")
    tower_d = loaded.depth_model
    g = torch.Generator(device=device).manual_seed(4)
    x = torch.rand((1, 3, 384, 384), generator=g, device=device) * 2 - 1
    with torch.inference_mode():
        reset_counts()
        card = tower_d(x)
        torch.cuda.synchronize()
        counted = read_counts()
        cpu = copy.deepcopy(tower_d).to("cpu")(x.cpu())
        dpt_ms = cuda_ms(lambda: tower_d(x), iters=5, hide_host=False)
        dpt_kernels = kernel_times(lambda: tower_d(x))
    dpt_rel = ((card.cpu() - cpu).abs().max() / cpu.abs().max()).item()
    log(f"MiDaS DPT-hybrid at 384², f32: card vs CPU max|Δ|/max|ref| {dpt_rel:.3e} (bound "
        f"{DPT_REL_TOL:g}), {dpt_ms:.2f} ms a forward, launches {counted}; device ms by class "
        + json.dumps({k: round(v, 2) for k, v in dpt_kernels["by_class"].items()})
        + "; top kernels " + json.dumps([(n[:60], round(t, 2)) for n, t in dpt_kernels["top"]]))
    if not dpt_rel <= DPT_REL_TOL or counted != _plan(b5=midas):
        raise AssertionError(f"MiDaS on the card: {dpt_rel}, launches {counted}")
    info["sd2_depth"] = dict(file_write_s=t_write, load_s=t_load, dpt_rel_err=dpt_rel,
                             dpt_ms=dpt_ms, dpt_launches=counted, dpt_kernels=dpt_kernels)
    del engine_d, loaded, tower_d, cpu, card
    os.remove(path)
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the inpainting model (9 channels): B1 = the init encode, the
    # masked image's encode and the decode
    mask, mask_png = _rect_mask_png(size)
    inpaint = create_random_sd15(seed=9, device=device, in_channels=9)
    with _server(Engine(model=inpaint, device=device)) as url:
        _post(f"{url}/img2img", dict(base, seed=1, steps=2))
        results.append(_request(url, "img2img", dict(
            base, seed=4321, mask=mask_png, mask_blur=MASK_BLUR, inpainting_fill=1,
            inpaint_full_res=False), check_i2i, size, "inpainting model"))
        plans.append(i2i_plan(inpaint, b1=3))
    _check_overlay(results[-1]["image"], init, mask)
    del inpaint
    torch.cuda.empty_cache()

    # (c) instruct-pix2pix (8 channels) at image_cfg_scale 1.5 (3 CFG rows)
    # and 1.0 (the plain 2-row CFG with the init latent as c_concat)
    p2p = create_random_sd15(seed=8, device=device, in_channels=8)
    rows = {}
    with _server(Engine(model=p2p, device=device)) as url:
        _post(f"{url}/img2img", dict(base, seed=1, steps=2, image_cfg_scale=P2P_IMAGE_CFG))
        for scale in (P2P_IMAGE_CFG, 1.0):
            seen = rows.setdefault(scale, [])
            with _rows_seen(p2p.unet, seen):
                results.append(_request(url, "img2img", dict(base, seed=1234,
                                                             image_cfg_scale=scale),
                                        check_i2i, size, f"instruct-pix2pix image_cfg {scale}"))
            plans.append(i2i_plan(p2p, b1=2))
    p2p_delta = float(abs(results[-2]["image"].astype(int) - results[-1]["image"].astype(int))
                      .mean())
    log(f"instruct-pix2pix: UNet rows per call {sorted(set(rows[P2P_IMAGE_CFG]))} at "
        f"image_cfg_scale {P2P_IMAGE_CFG}, {sorted(set(rows[1.0]))} at 1.0; the images "
        f"mean|Δ| {p2p_delta:.2f} levels apart")
    if set(rows[P2P_IMAGE_CFG]) != {3} or set(rows[1.0]) != {2} or not p2p_delta > 0:
        raise AssertionError(f"instruct-pix2pix CFG rows {rows}, delta {p2p_delta}")
    del p2p
    torch.cuda.empty_cache()

    # (d) /controlnet/detect with the model annotators on the phase-3 server
    prev_dirs = list(annotators._model_dirs)
    annotator_dir = os.path.join(directory, "Annotators")
    os.makedirs(annotator_dir)
    write_annotator_files(annotator_dir, device)
    annotators.set_annotator_dirs([annotator_dir])
    detect = {}
    try:
        with _server(engine) as url:
            for module in ("depth_midas", "hed"):
                for res in DETECT_RES:
                    reset_counts()
                    t0 = time.perf_counter()
                    out = _post(url.replace("/sdapi/v1", "/controlnet/detect"), {
                        "controlnet_module": module, "controlnet_input_images": [init_png],
                        "controlnet_processor_res": res})
                    dt = time.perf_counter() - t0
                    counted = read_counts()
                    (hint,) = [decode_png(base64.b64decode(b))[0] for b in out["images"]]
                    planned = _plan(b5=midas if module == "depth_midas" else 0)
                    log(f"/controlnet/detect {module} at processor_res {res}: {dt:.3f} s, "
                        f"hint {hint.shape}, std {hint.std():.2f}, launches {counted}")
                    if hint.shape[:2] != (res, res) or hint.std() < 1.0 or counted != planned:
                        raise AssertionError(f"{module} at {res}: {hint.shape}, std "
                                             f"{hint.std()}, launches {counted} != {planned}")
                    detect[f"{module}_{res}"] = dict(seconds=dt, hint_std=float(hint.std()))
        info["detect"] = detect

        # (e) config 4 with a depth_midas unit on phase 2's tower
        network_dir = os.path.join(directory, "networks")
        os.makedirs(network_dir)
        write_network_files(network_dir, model, tower)
        cfg = model.unet_cfg
        with _network_registries(engine, network_dir), _server(engine) as url:
            results.append(_request(url, "txt2img", config4_request(
                1234, init_png, module="depth_midas"), _sd15_check, size,
                "config 4 with a depth_midas unit"))
            plans.append(_plan(b1=1, b2=STEPS * (launch_plan(cfg, latent) + launch_plan(cfg, latent, False)),
                               b5=STEPS * (ln_plan(cfg, latent) + ln_plan(cfg, latent, False))
                               + clip_ln_plan(model) + midas))
    finally:
        annotators.set_annotator_dirs(prev_dirs)
    _check_launches(results, plans)
    info["seconds"] = {r["label"]: r["seconds"] for r in results}
    # the VAE encodes at 512² (f32): each img2img request's, and the
    # inpainting model's masked image
    info["f32_encodes_512"] = sum(r["route"] == "img2img" for r in results) + 1
    return results, info


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
    write_safetensors(first, load.ldm_state_dict(model), metadata={"format": "pt"})
    other = create_random_sd15(seed=1, device=device)
    write_safetensors(second, {k: v.half() for k, v in load.ldm_state_dict(other).items()})
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
    # the base's step with an SDXL ControlNet tower (label_emb on y)
    tower = random_tower(base.unet_cfg, 12, device)
    ctx = torch.randn((2, 77, base.unet_cfg.context_dim), generator=g, device=device).to(bf16)
    y = torch.randn((2, base.unet_cfg.adm_in_channels), generator=g, device=device)
    out["base_controlnet"] = _unet_step("SDXL base + ControlNet B=2 128x128 bf16", base.unet,
                                        base.unet_cfg, 128, x, t, ctx, y, tower=tower,
                                        hint=_grid_hint(1024, 2, device))
    del tower
    torch.cuda.empty_cache()
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


def sdxl_img2img_request(seed: int, init_png: str) -> dict:
    """Phase 6c's SDXL img2img: 1024², DPM++ 2M Karras, 20 steps, CFG 7,
    denoising 0.75 (16 UNet calls)."""
    return dict(prompt="a photograph of an astronaut riding a horse", negative_prompt="blurry",
                seed=seed, steps=STEPS, cfg_scale=7.0, sampler_name="DPM++ 2M",
                scheduler="Karras", width=1024, height=1024, batch_size=1,
                denoising_strength=DENOISE, init_images=[init_png])


def phase_sdxl_img2img(engine, base, phase6: dict, device):
    """6c: (a) two SDXL img2img requests with one seed on a phase-6 PNG,
    (b) an SDXL inpaint with the API's defaults, (c) a random full-width
    SDXL UNet with 9 input channels on an inpaint, (d) one SDXL img2img
    request under torch.profiler.  Returns (results, info)."""
    from sdwebui_tpu_torch.pipeline.img2img import setup_img2img_steps
    from sdwebui_tpu_torch.pipeline.sd_model import create_random_sdxl
    from sdwebui_tpu_torch.server.app import Engine
    from sdwebui_tpu_torch.utils.png import decode_png

    init_png = phase6["png_b64"]
    init = decode_png(base64.b64decode(init_png))[0]
    size = 1024
    _, t_enc = setup_img2img_steps(STEPS, DENOISE)
    calls = t_enc + 1

    def plan(m, b1):
        return _plan(b1=b1, b2=calls * launch_plan(m.unet_cfg, 128),
                     b5=calls * ln_plan(m.unet_cfg, 128) + clip_ln_plan(m))

    def check(params, seed):
        for want in (f"Seed: {seed}", "Sampler: DPM++ 2M", f"Denoising strength: {DENOISE}"):
            if want not in params:
                raise AssertionError(f"infotext lacks {want!r}: {params!r}")

    body = sdxl_img2img_request(1234, init_png)
    mask, mask_png = _offcentre_mask_png(size)
    results, plans = [], []
    with _server(engine) as url:
        _post(f"{url}/img2img", dict(body, steps=2, seed=1))
        for label in ("(a) SDXL img2img", "(a) SDXL img2img repeat"):
            results.append(_request(url, "img2img", body, check, size, label))
            plans.append(plan(base, 2))
        results.append(_request(url, "img2img", dict(
            body, seed=4321, mask=mask_png, mask_blur=MASK_BLUR, inpaint_full_res_padding=32),
            check, size, "(b) SDXL inpaint, API defaults"))
        plans.append(plan(base, 2))
    _check_repeat(results, 0, 1)
    _check_overlay(results[2]["image"], init, mask)
    t0 = time.perf_counter()
    nine = create_random_sdxl(seed=9, device=device, in_channels=9)
    torch.cuda.synchronize()
    log(f"random 9-channel SDXL on the card in {time.perf_counter() - t0:.2f} s")
    with _server(Engine(model=nine, device=device)) as url:
        _post(f"{url}/img2img", dict(body, steps=2, seed=1))
        results.append(_request(url, "img2img", dict(
            body, seed=4321, mask=mask_png, mask_blur=MASK_BLUR, inpainting_fill=1,
            inpaint_full_res=False), check, size, "(c) 9-channel SDXL inpaint"))
        plans.append(plan(nine, 3))      # B1: the init encode, the masked encode, the decode
    _check_overlay(results[-1]["image"], init, mask)
    del nine
    gc.collect()
    torch.cuda.empty_cache()
    _check_launches(results, plans)
    profile = phase_profile(engine, sdxl_img2img_request(1234, init_png), "SDXL img2img",
                            route="img2img")
    return results, dict(unet_calls=calls, seconds={r["label"]: r["seconds"] for r in results},
                         profile=profile, f32_encodes_1024=2 + 1 + 2, decodes_1024=4)


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


def kernel_times(fn, top: int = 8) -> dict:
    """Device ms of one call of fn under torch.profiler: the sum by kernel
    class and the `top` kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type.name == "CUDA" and e.time_range.end > e.time_range.start:
            by_name[e.name] = by_name.get(e.name, 0) + (e.time_range.end - e.time_range.start) / 1e3
    by_class = {}
    for name, t in by_name.items():
        by_class[kernel_class(name)] = by_class.get(kernel_class(name), 0) + t
    return dict(by_class=by_class, total_ms=sum(by_name.values()),
                top=sorted(by_name.items(), key=lambda kv: -kv[1])[:top])


def phase_profile(engine, body: dict, label: str, wall: float | None = None,
                  route: str = "txt2img"):
    """One in-process request (the server's request parser and
    Engine.txt2img or .img2img, without HTTP) under torch.profiler (CUDA activity):
    device busy is the union of the kernel intervals; the wall is `wall`
    where given (config 3: the median of phase 4c's two timed requests over
    HTTP), else the median of two in-process requests without the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    from sdwebui_tpu_torch.server.api import _params_from_request

    def run():
        p = _params_from_request(body, img2img=route == "img2img")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (engine.img2img if route == "img2img" else engine.txt2img)(p)
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
    ("flash_attention", "flash_attention.cu", "sdwebui_tpu/ops/flash_attention.py:112",
     None, None),
    ("flash_attention_packed", "flash_attention.cu", "sdwebui_tpu/ops/flash_attention.py:311",
     "sdxl_base_64x64", "bfloat16"),
    ("flash_attention_4d", "flash_attention.cu", "sdwebui_tpu/ops/flash_attention.py:432",
     "sdxl_base_64x64", "bfloat16"),
    ("conv3x3", "conv3x3.cu", "sdwebui_tpu/ops/conv.py:76", "jax_doc_64x64x320", "bfloat16"),
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
    tower = random_tower(model.unet_cfg, 11, device)
    unet = phase_unet(model, device, tower)
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
            with tempfile.TemporaryDirectory(prefix="chip_smoke_img2img_") as opt_dir:
                opt_results, opt_info = phase_img2img_options(engine, model, results[0],
                                                              opt_dir, device)
            mark("4g img2img options")
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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_networks_") as network_dir:
        c4_results, c4_info = phase_config4(engine, model, results[0], network_dir, tower)
    mark("4e config 4")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_hybrid_") as hybrid_dir:
        hy_results, hy_info = phase_hybrid(engine, model, results[0], hybrid_dir, device, tower)
    del tower
    gc.collect()
    torch.cuda.empty_cache()
    mark("4f hybrids")
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
    sdxl_i2i_results, sdxl_i2i_info = phase_sdxl_img2img(engine, base, sdxl_results[0], device)
    mark("6c SDXL img2img")
    profile = phase_profile(engine, sdxl_request(1234, refiner.title), "SDXL")
    mark("7 SDXL profile")

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "sdwebui_tpu"))
    if leaked:
        raise AssertionError(f"the port imported JAX or the JAX package: {leaked[:5]}")
    requests = [{k: v for k, v in r.items()
                 if k not in ("image", "png_b64", "infotext", "extras")}
                for r in (results + i2i_results + opt_results + hr_results + c4_results
                          + hy_results + ckpt_results + sampler_results + sdxl_results
                          + [sdxl_hr_result] + sdxl_i2i_results)]
    log(json.dumps({"card": smi, "kernel_shapes": rows, "unet_step": unet,
                    "sdxl_unet_step": sdxl_unet, "img2img_unet_calls": i2i_calls,
                    "sdxl_refiner_after_step": s_idx, "checkpoint": ckpt_info,
                    "hires": hr_info, "extras": extras, "sdxl_hires": sdxl_hr_info,
                    "config4": c4_info, "hybrid": hy_info, "img2img_options": opt_info,
                    "sdxl_img2img": sdxl_i2i_info,
                    "requests": requests, "sdxl_profile": profile, "phase_s": phase_s}))

    def row_of(name, shape, dtype):
        return next(r for r in rows if r["entry"] == name and r["name"] == shape
                    and r["dtype"] == dtype)

    # B1's row: the VAE shape whose launches in the timed requests times its
    # time is largest: the f32 encode at 512² (one per config 2 request), the
    # 1024² decode (config 3 and config 5 requests), the 768² decode (config
    # 3 at 1.5x), the f32 encode at 1024² (config 3's image-space route and
    # every SDXL img2img request) or the 1536² decode (SDXL hires)
    b1_calls[("vae_mid_512_f32", "float32")] = (len(i2i_results) + hy_info["f32_encodes_512"]
                                                + opt_info["f32_encodes_512"])
    b1_calls[("vae_mid_1024", "bfloat16")] += len(sdxl_results) + sdxl_i2i_info["decodes_1024"]
    b1_calls[("vae_mid_1024_f32", "float32")] += sdxl_i2i_info["f32_encodes_1024"]
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
    # img2img, hires fix and config 4, from the checkpoint files and with
    # every sampler, SDXL with and without hires fix); the times at each entry's
    # dominant shape; max_abs_err over all its compared shapes
    print(json.dumps({"kernels": [entry(*e) for e in KERNEL_ENTRIES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
