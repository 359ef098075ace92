"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  0. environment: torch/CUDA versions, the card's name and power limit, and
     the flash-attention kernel built from csrc/ with nvcc (build seconds);
  1. kernel vs its plain PyTorch version at the main path's shapes
     (tolerance 2e-2 in bf16, 1e-4 in f32; TF32 off), with both times;
  2. the full-width SD1.5 UNet CFG step (B=2, latent 64², ctx 2x77x768,
     bf16, random weights) through the kernel and with the plain attention
     forced: finite, max|Δ|/max|ref| <= 5e-2;
  3. the txt2img HTTP server on 127.0.0.1 with random-weight SD1.5 on the
     card, answering BASELINE config 1 requests (512², Euler a, 20 steps,
     CFG 7.5; batch 1, batch 4 and a repeated seed): PNGs decoded with the
     standard library, infotext checked, the repeat's image within 2 uint8
     levels, and the kernel launch count equal to the plan's
     (10 per UNet call + 1 per VAE decode).
The last two lines are the kernels JSON and {"ok": true, "device": ...}.
Needs a CUDA card; without one it exits 1 and prints no result.
"""

from __future__ import annotations

import base64
import json
import subprocess
import sys
import threading
import time
import urllib.request

import torch

BF16_TOL = 2e-2
F32_TOL = 1e-4
UNET_REL_TOL = 5e-2
REPEAT_TOL = 2          # uint8 levels
STEPS = 20
# SD1.5 at 512²: self-attention with Skv >= 1024 in 4+6 transformer blocks
# (64² and 32² levels) per UNet call; one mid-block attention per VAE decode
LAUNCHES_PER_UNET_CALL = 10
LAUNCHES_PER_DECODE = 1

KERNEL_SHAPES = [   # (name, BH, Sq, Skv, D, dtype)
    ("unet_64x64_d40", 16, 4096, 4096, 40, torch.bfloat16),
    ("unet_32x32_d80", 16, 1024, 1024, 80, torch.bfloat16),
    ("vae_mid_d512", 1, 4096, 4096, 512, torch.bfloat16),
    ("vae_mid_d512_f32", 1, 4096, 4096, 512, torch.float32),
    ("ragged_d64", 3, 1000, 1100, 64, torch.bfloat16),
]


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_env():
    from sdwebui_tpu_torch.ops import _build

    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    log(smi)
    t0 = time.perf_counter()
    _build.load_library("flash_attention", rebuild=True)
    log(f"built flash_attention.cu for sm_90a in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds['flash_attention']:.2f} s)")
    return smi


def phase_kernel(device):
    from sdwebui_tpu_torch.ops.flash_attention import (flash_attention,
                                                       flash_attention_plain)

    rows = []
    for name, bh, sq, skv, d, dtype in KERNEL_SHAPES:
        g = torch.Generator(device=device).manual_seed(0)
        q = torch.randn((bh, sq, d), generator=g, device=device).to(dtype)
        k = torch.randn((bh, skv, d), generator=g, device=device).to(dtype)
        v = torch.randn((bh, skv, d), generator=g, device=device).to(dtype)
        out = flash_attention(q, k, v)
        ref = flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        ms = cuda_ms(lambda: flash_attention(q, k, v))
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v))
        log(f"kernel {name} ({bh},{sq},{skv},{d}) {str(dtype)[6:]}: max|Δ| {err:.3e} "
            f"(tol {tol:g}), kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        if not err <= tol:
            raise AssertionError(f"flash_attention disagrees with its plain version at "
                                 f"{name}: max|Δ| {err} > {tol}")
        rows.append(dict(name=name, shape=[bh, sq, skv, d], dtype=str(dtype)[6:],
                         max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms))
        del q, k, v, out, ref
    return rows


def phase_unet(model, device):
    from sdwebui_tpu_torch.ops.attention import forced_impl

    g = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((2, 4, 64, 64), generator=g, device=device).to(torch.bfloat16)
    t = torch.tensor([500.0, 500.0], device=device)
    ctx = torch.randn((2, 77, 768), generator=g, device=device).to(torch.bfloat16)
    with torch.inference_mode():
        step = lambda: model.unet(x, t, ctx)  # noqa: E731
        out = step().float()
        ms = cuda_ms(step, iters=10)
        with forced_impl("plain"):
            ref = step().float()
            plain_ms = cuda_ms(step, iters=10)
    torch.cuda.synchronize()
    if not (torch.isfinite(out).all() and torch.isfinite(ref).all()):
        raise AssertionError("non-finite UNet output")
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    log(f"unet SD1.5 B=2 64x64 bf16: {tuple(out.shape)}, max|Δ|/max|ref| {rel:.3e} "
        f"(bound {UNET_REL_TOL:g}); {ms:.2f} ms/call with the kernel, "
        f"{plain_ms:.2f} ms/call plain")
    if tuple(out.shape) != (2, 4, 64, 64) or not rel <= UNET_REL_TOL:
        raise AssertionError(f"UNet kernel path disagrees with the plain path: {rel}")
    return dict(rel_err=rel, ms=ms, plain_ms=plain_ms)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def phase_serve(model):
    from sdwebui_tpu_torch.ops import flash_attention as fa
    from sdwebui_tpu_torch.server.api import make_server
    from sdwebui_tpu_torch.server.app import Engine
    from sdwebui_tpu_torch.utils.png import decode_png

    server = make_server(Engine(model=model, device=model.device), "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/sdapi/v1/txt2img"
    base = dict(prompt="a photograph of an astronaut riding a horse",
                negative_prompt="blurry, lowres", width=512, height=512,
                sampler_name="Euler a", steps=STEPS, cfg_scale=7.5)
    requests = [dict(base, seed=1234, batch_size=1), dict(base, seed=99, batch_size=4),
                dict(base, seed=1234, batch_size=1)]
    results, launches, total_launches = [], [], 0
    try:
        _post(url, dict(base, seed=1, batch_size=1, steps=2))    # warm-up, not timed
        fa.reset_launch_count()
        for body in requests:
            before = fa.launch_count()
            t0 = time.perf_counter()
            res = _post(url, body)
            dt = time.perf_counter() - t0
            launches.append(fa.launch_count() - before)
            info = json.loads(res["info"])
            images = [decode_png(base64.b64decode(b)) for b in res["images"]]
            for i, (img, text) in enumerate(images[info["index_of_first_image"]:]):
                seed = body["seed"] + i
                if img.shape != (512, 512, 3):
                    raise AssertionError(f"image shape {img.shape}")
                params = text.get("parameters", "")
                if f"Seed: {seed}" not in params or "Sampler: Euler a" not in params:
                    raise AssertionError(f"infotext lacks seed/sampler: {params!r}")
            n = len(images) - info["index_of_first_image"]
            if n != body["batch_size"]:
                raise AssertionError(f"{n} images for batch {body['batch_size']}")
            results.append(dict(batch=body["batch_size"], seed=body["seed"], seconds=dt,
                                images_per_s=n / dt, image=images[-1][0]))
            log(f"request batch {body['batch_size']} seed {body['seed']}: {dt:.3f} s, "
                f"{n / dt:.3f} images/s, {launches[-1]} kernel launches")
        total_launches = fa.launch_count()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    delta = int(abs(results[0]["image"].astype(int) - results[2]["image"].astype(int)).max())
    log(f"repeated seed 1234: max|Δ| {delta} uint8 levels (bound {REPEAT_TOL})")
    if delta > REPEAT_TOL:
        raise AssertionError(f"repeated seed differs by {delta}")
    if results[0]["image"].std() < 1.0:
        raise AssertionError("the generated image is flat")
    expected = [STEPS * LAUNCHES_PER_UNET_CALL + LAUNCHES_PER_DECODE] * len(requests)
    log(f"kernel launches per request {launches}, planned {expected}")
    if launches != expected:
        raise AssertionError(f"launch count {launches} != planned {expected}")
    return results, total_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    from sdwebui_tpu_torch.pipeline.sd_model import create_random_sd15

    device = torch.device("cuda")
    phase_env()
    rows = phase_kernel(device)
    t0 = time.perf_counter()
    model = create_random_sd15(seed=0, device=device)
    torch.cuda.synchronize()
    log(f"random SD1.5 on the card in {time.perf_counter() - t0:.2f} s")
    unet = phase_unet(model, device)
    results, launches = phase_serve(model)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
    if leaked:
        raise AssertionError(f"the port imported JAX: {leaked[:5]}")
    log(json.dumps({"kernel_shapes": rows, "unet_step": unet, "requests": [
        {k: v for k, v in r.items() if k != "image"} for r in results]}))
    # ms / plain_ms: the main path's dominant shape, the 64x64-level UNet
    # self-attention; max_abs_err: the largest over all compared shapes
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "sdwebui_tpu_torch/csrc/flash_attention.cu",
        "replaces": "sdwebui_tpu/ops/flash_attention.py:111",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
